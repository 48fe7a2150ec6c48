"""Gaussian diffusion over the flow latent video: training loss and DDIM.

Port of ``dawn_tpu/models/dm/diffusion.py``: cosine schedule, epsilon
prediction, the per-element l2 training loss (``p_losses``), dynamic
thresholding (Imagen), eta-DDIM and classifier-free guidance. The DDIM loop
is a Python loop. Tensors are channels-last: x is (B, T, h, w, 3) = (2 flow
+ 1 occlusion).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dawn_tpu_torch.ops.quantile import quantile_nonneg
from dawn_tpu_torch.ops.schedule import ddim_times, diffusion_buffers
from dawn_tpu_torch.parallel.mesh import all_gather_cat

# denoise_fn(x, time, cond, cond_drop_mask) -> eps prediction, all batched
DenoiseFn = Callable[..., torch.Tensor]


DYNAMIC_THRES_PERCENTILE = 0.9


class GaussianDiffusion:
    """Stateless diffusion math; the denoiser is passed per call. Schedule
    scalars are float32 on the host, as the JAX package holds them; the
    per-sample lookups use a copy on the timesteps' device, made once."""

    def __init__(self, timesteps: int = 1000, sampling_timesteps: int = 20,
                 ddim_sampling_eta: float = 1.0, null_cond_prob: float = 0.1):
        self.timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        self.null_cond_prob = null_cond_prob
        self.bufs = {k: torch.from_numpy(v) for k, v in diffusion_buffers(timesteps).items()}
        self._device_bufs: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Per-sample schedule values bufs[name][t], shaped to broadcast over
        ndim."""
        bufs = self._device_bufs.get(t.device)
        if bufs is None:
            bufs = {k: v.to(t.device) for k, v in self.bufs.items()}
            self._device_bufs[t.device] = bufs
        return bufs[name][t].reshape(t.shape + (1,) * (ndim - 1))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_t for per-sample int timesteps t (B,)."""
        nd = x_start.ndim
        return (self._extract("sqrt_alphas_cumprod", t, nd) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, nd) * noise)

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor,
                                 noise: torch.Tensor) -> torch.Tensor:
        """x_0 from x_t and the predicted noise, per-sample int timesteps t (B,)."""
        nd = x_t.ndim
        return (self._extract("sqrt_recip_alphas_cumprod", t, nd) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, nd) * noise)

    def _threshold(self, x0: torch.Tensor, group=None) -> torch.Tensor:
        """Dynamic thresholding: per-sample quantile of |x0|, floored at 1,
        then clip to [-s, s] and divide by s. The threshold s carries no
        gradient: the JAX package finds it by a search over bit patterns,
        which autodiff cannot see through. With ``group`` (the 'seq' ranks
        of a frame-sharded video) the quantile is the whole video's: the
        ranks' |x0| are all-gathered first."""
        b = x0.shape[0]
        flat = all_gather_cat(x0.detach().reshape(b, -1).abs(), group, dim=1)
        s = quantile_nonneg(flat, DYNAMIC_THRES_PERCENTILE)
        s = s.clamp_min(1.0).reshape((b,) + (1,) * (x0.ndim - 1))
        return torch.maximum(torch.minimum(x0, s), -s) / s

    def p_losses(self, denoise_fn: DenoiseFn, x_start: torch.Tensor, t: torch.Tensor,
                 fea: torch.Tensor, bbox_mask: torch.Tensor, cond: Optional[torch.Tensor],
                 noise: Optional[torch.Tensor] = None, drop: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, group=None):
        """Per-element l2 eps loss. Returns (loss, pred_x0, cond_drop_mask).

        x_start: (B, T, h, w, 3); t: (B,) int timesteps; fea: (B, T, h, w,
        256); bbox_mask: (B, T, h, w, 16). ``noise`` and the (B, T) bool
        ``drop`` mask (True: the frame gets the null condition) are drawn
        from ``generator`` unless given. ``group``: see :meth:`_threshold`."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x_noisy = self.q_sample(x_start, t, noise)
        inp = torch.cat([x_noisy, fea, bbox_mask], dim=-1)
        if drop is None:
            drop = torch.rand(x_start.shape[:2], generator=generator,
                              device=x_start.device) < self.null_cond_prob
        pred_noise = denoise_fn(inp, t, cond, drop)
        loss = (noise - pred_noise).square()
        pred_x0 = self._threshold(self.predict_start_from_noise(x_noisy, t, pred_noise), group)
        return loss, pred_x0, drop

    def _cfg_eps(self, denoise_fn: DenoiseFn, inp, tvec, cond, cond_scale: float):
        """forward_with_cond_scale: one call at cond_scale 1, two otherwise."""
        eps = denoise_fn(inp, tvec, cond, None)
        if cond_scale == 1.0 or cond is None:
            return eps
        null_mask = torch.ones(cond.shape[:2], dtype=torch.bool, device=cond.device)
        null_eps = denoise_fn(inp, tvec, cond, null_mask)
        return null_eps + (eps - null_eps) * cond_scale

    def ddim_sample(self, denoise_fn: DenoiseFn, shape: Tuple[int, ...],
                    cond: Optional[torch.Tensor], cond_scale: float = 1.0,
                    noise_seq: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    device=None, view: Tuple = (), group=None) -> torch.Tensor:
        """DDIM sampling. ``noise_seq`` optionally supplies (steps+1, *shape)
        gaussians (index 0 = x_T, then one per step) for reproducible parity;
        otherwise noise is drawn from ``generator`` on ``device``.

        A rank of a sharded sampler passes the whole batch's ``shape`` and
        its own part as ``view`` (an index, e.g. (rows, frames)): every
        gaussian is drawn at ``shape`` and cut to ``view``, so the ranks
        together use the noise of one unsharded call, and the denoiser sees
        the rank's part only. ``group``: see :meth:`_threshold`."""
        def normal(i):
            if noise_seq is not None:
                return noise_seq[i][view].to(device)
            return torch.randn(shape, generator=generator, device=device)[view]

        acp = self.bufs["alphas_cumprod_prev"]
        eta = torch.tensor(self.ddim_sampling_eta, dtype=torch.float32)
        img = normal(0)
        for i, (time, time_next) in enumerate(ddim_times(self.timesteps,
                                                         self.sampling_timesteps)):
            alpha, alpha_next = acp[time], acp[time_next]
            tvec = torch.full((img.shape[0],), time, dtype=torch.int64, device=device)
            pred_noise = self._cfg_eps(denoise_fn, img, tvec, cond, cond_scale)
            x_start = self._threshold(self.predict_start_from_noise(img, tvec, pred_noise),
                                      group)
            sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next)
                                     / (1 - alpha))
            c = torch.sqrt(torch.clamp((1 - alpha_next) - sigma ** 2, min=0.0))
            noise = normal(i + 1)
            img = (x_start * torch.sqrt(alpha_next).item() + c.item() * pred_noise
                   + float(time_next > 0) * sigma.item() * noise)
        return img

    def sample(self, denoise_fn: DenoiseFn, shape, cond=None, cond_scale: float = 1.0,
               noise_seq=None, generator=None, device=None, view: Tuple = (),
               group=None) -> torch.Tensor:
        if self.sampling_timesteps >= self.timesteps:
            raise NotImplementedError("the ancestral p_sample_loop is not ported yet")
        return self.ddim_sample(denoise_fn, shape, cond, cond_scale, noise_seq,
                                generator, device, view, group)
