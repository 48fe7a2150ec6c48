"""Gaussian diffusion over the flow latent video: the DDIM sampler.

Port of the sampling half of ``dawn_tpu/models/dm/diffusion.py``: cosine
schedule, epsilon prediction, dynamic thresholding (Imagen), eta-DDIM and
classifier-free guidance. The DDIM loop is a Python loop. Tensors are
channels-last: x is (B, T, h, w, 3) = (2 flow + 1 occlusion).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dawn_tpu_torch.ops.quantile import quantile_nonneg
from dawn_tpu_torch.ops.schedule import ddim_times, diffusion_buffers

# denoise_fn(x, time, cond, cond_drop_mask) -> eps prediction, all batched
DenoiseFn = Callable[..., torch.Tensor]


DYNAMIC_THRES_PERCENTILE = 0.9


class GaussianDiffusion:
    """Stateless diffusion math; the denoiser is passed per call. Schedule
    scalars are float32 on the host, as the JAX package holds them."""

    def __init__(self, timesteps: int = 1000, sampling_timesteps: int = 20,
                 ddim_sampling_eta: float = 1.0):
        self.timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        self.bufs = {k: torch.from_numpy(v) for k, v in diffusion_buffers(timesteps).items()}

    def predict_start_from_noise(self, x_t: torch.Tensor, t: int,
                                 noise: torch.Tensor) -> torch.Tensor:
        return (self.bufs["sqrt_recip_alphas_cumprod"][t].item() * x_t
                - self.bufs["sqrt_recipm1_alphas_cumprod"][t].item() * noise)

    def _threshold(self, x0: torch.Tensor) -> torch.Tensor:
        """Dynamic thresholding: per-sample quantile of |x0|, floored at 1,
        then clip to [-s, s] and divide by s."""
        b = x0.shape[0]
        s = quantile_nonneg(x0.reshape(b, -1).abs(), DYNAMIC_THRES_PERCENTILE)
        s = s.clamp_min(1.0).reshape((b,) + (1,) * (x0.ndim - 1))
        return torch.maximum(torch.minimum(x0, s), -s) / s

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
                    device=None) -> torch.Tensor:
        """DDIM sampling. ``noise_seq`` optionally supplies (steps+1, *shape)
        gaussians (index 0 = x_T, then one per step) for reproducible parity;
        otherwise noise is drawn from ``generator`` on ``device``."""
        def normal(i):
            if noise_seq is not None:
                return noise_seq[i].to(device)
            return torch.randn(shape, generator=generator, device=device)

        acp = self.bufs["alphas_cumprod_prev"]
        eta = torch.tensor(self.ddim_sampling_eta, dtype=torch.float32)
        img = normal(0)
        for i, (time, time_next) in enumerate(ddim_times(self.timesteps,
                                                         self.sampling_timesteps)):
            alpha, alpha_next = acp[time], acp[time_next]
            tvec = torch.full((shape[0],), time, dtype=torch.int64, device=device)
            pred_noise = self._cfg_eps(denoise_fn, img, tvec, cond, cond_scale)
            x_start = self._threshold(self.predict_start_from_noise(img, time, pred_noise))
            sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next)
                                     / (1 - alpha))
            c = torch.sqrt(torch.clamp((1 - alpha_next) - sigma ** 2, min=0.0))
            noise = normal(i + 1)
            img = (x_start * torch.sqrt(alpha_next).item() + c.item() * pred_noise
                   + float(time_next > 0) * sigma.item() * noise)
        return img

    def sample(self, denoise_fn: DenoiseFn, shape, cond=None, cond_scale: float = 1.0,
               noise_seq=None, generator=None, device=None) -> torch.Tensor:
        if self.sampling_timesteps >= self.timesteps:
            raise NotImplementedError("the ancestral p_sample_loop is not ported yet")
        return self.ddim_sample(denoise_fn, shape, cond, cond_scale, noise_seq,
                                generator, device)
