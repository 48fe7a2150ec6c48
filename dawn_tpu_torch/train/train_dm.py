"""DM (flow diffusion) training, stages 1 and 2, on one card.

Port of ``dawn_tpu/train/train_dm.py:39-326``. The loss is the reference's:
the eps loss + 0.15 * floss (MSE of the thresholded x0 prediction) + 0.15 *
the eps loss inside the mouth-landmark box. Stage 1 diffuses the whole clip
with frame 0 as the reference image; stage 2 splits frame 0 off as the
reference and diffuses frames 1: (the condition rows keep their deltas
against frame 0, the mouth landmarks keep the reference's off-by-one slice).
The frozen LFG teacher gives the flow/occlusion targets and the reference
feature; with cached teacher tensors in the batch it is skipped.

The update is optax's ``chain(clip_by_global_norm(2.0), adam(cosine_decay(
lr, total_steps), b1=0.9, b2=0.99))``, written out: clip by ``max/norm``
only when ``norm >= max``, Adam with bias correction and eps 1e-8 outside the
square root, the learning rate of the step count before its increment. A
step whose gradient has a non-finite element changes neither the parameters
nor the optimizer or schedule state, while the step count advances and the
EMA still moves, as in the JAX package.

With ``use_fft_floss`` the floss is the temporal-FFT one of the JAX
package (``hf_loss_2`` of the predicted flow against the teacher's, along
the frames). ``remat`` recomputes the UNet's forward inside the backward,
as ``jax.checkpoint`` around the JAX loss's denoise call: 'full' recomputes
all of it (non-reentrant ``torch.utils.checkpoint``), 'dots' keeps the
outputs of the contractions (mm, addmm, bmm, baddbmm) and recomputes the
rest, as ``dots_saveable`` does; K1 then runs again inside the backward.
:meth:`DMTrainer.snapshot` gives the training monitor's panels.

The UNet runs in attn_mode 'local' by default, so each of its temporal
attentions goes through K1 forward and K2 backward
(:class:`dawn_tpu_torch.ops.local_attention.LocalAttentionPacked`); the JAX
trainer's default 'full' computes the same function. Parameters stay f32;
``compute_dtype`` is the UNet's compute dtype. The trainer lives on the card
unless the caller passes ``device="cpu"``.

Across processes, :meth:`DMTrainer.make_sharded_step` takes the JAX
package's ('data', 'seq') step (``dawn_tpu/train/train_dm.py:396-454``):
every rank receives the whole batch, keeps its rows ('data') and its
diffused frames ('seq'), runs the UNet sharded over 'seq' (halo exchange,
K5 and K6 in every temporal attention), and contributes its share of each
globally averaged loss term; one all-reduce of the gradients then gives the
gradient of the global loss, and the update is the same on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.models.dm.diffusion import GaussianDiffusion
from dawn_tpu_torch.models.dm.flow_diffusion import FaceLocEncoder, generate_bbox_mask
from dawn_tpu_torch.models.dm.unet3d import Unet3D
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.ops.fourier import hf_loss_2
from dawn_tpu_torch.parallel.mesh import Mesh, all_gather_grad, all_reduce_sum
from dawn_tpu_torch.train import to_device
from dawn_tpu_torch.train.augment import color_jitter_video, jitter_factors


def generate_mouth_mask(mouth_lmk: torch.Tensor, latent_size: int,
                        img_size: int) -> torch.Tensor:
    """(B, T, ls, ls, 1) f32 mask of each frame's mouth-landmark box at latent
    resolution; mouth_lmk (B, T, K, 2) are xy pixel coordinates."""
    scale = latent_size / img_size
    x0 = torch.floor(mouth_lmk[..., 0].amin(dim=-1) * scale).to(torch.int32)
    x1 = torch.ceil(mouth_lmk[..., 0].amax(dim=-1) * scale).to(torch.int32)
    y0 = torch.floor(mouth_lmk[..., 1].amin(dim=-1) * scale).to(torch.int32)
    y1 = torch.ceil(mouth_lmk[..., 1].amax(dim=-1) * scale).to(torch.int32)
    idx = torch.arange(latent_size, device=mouth_lmk.device)
    rows, cols = idx[None, None, :, None], idx[None, None, None, :]
    mask = ((rows >= y0[..., None, None]) & (rows <= y1[..., None, None])
            & (cols >= x0[..., None, None]) & (cols <= x1[..., None, None]))
    return mask.float()[..., None]


@dataclasses.dataclass
class DMTrainConfig:
    img_size: int = 128
    fea_channels: int = 256       # LFG bottleneck width
    pose_dim: int = 6
    win_width: int = 40
    stage: int = 1                # 1: fixed clips, frame 0 diffused too; 2: frame 0 split off
    lr: float = 2e-4
    total_steps: int = 250_000
    grad_clip: float = 2.0
    floss_weight: float = 0.15
    mouth_weight: float = 0.15
    null_cond_prob: float = 0.1
    use_fft_floss: bool = False   # floss = mean |rfft(teacher flow) - rfft(predicted flow)|
    color_jitter: bool = True
    remat: str = "none"           # 'none' | 'dots' | 'full': recompute the UNet in the backward
    compute_dtype: torch.dtype = torch.float32
    ema_decay: Optional[float] = 0.9999

    @property
    def latent_size(self) -> int:
        return self.img_size // 4


def cosine_decay(count: int, total_steps: int) -> float:
    """optax.cosine_decay_schedule's factor at ``count`` (alpha 0)."""
    return 0.5 * (1.0 + math.cos(math.pi * min(count, total_steps) / total_steps))


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam's update: mu and nu moving averages, bias correction by
    the incremented count, mu_hat / (sqrt(nu_hat) + eps), scaled by -lr.
    With ``weight_decay`` it is optax.adamw's: weight_decay * p (the
    parameter before the update) is added to that direction before the
    scaling by -lr. The learning rate is the group's ``lr`` (set by the
    schedule)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                                         count=0)
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            count = self.state[params[0]]["count"] + 1
            for p in params:
                self.state[p]["count"] = count
            mu_hat = torch._foreach_div(mus, 1 - b1 ** count)
            den = torch._foreach_sqrt(torch._foreach_div(nus, 1 - b2 ** count))
            torch._foreach_add_(den, eps)
            torch._foreach_div_(mu_hat, den)
            wd = group.get("weight_decay", 0.0)       # absent from older checkpoints
            if wd:
                torch._foreach_add_(mu_hat, params, alpha=wd)
            torch._foreach_add_(params, mu_hat, alpha=-group["lr"])


# the contractions whose outputs remat 'dots' keeps (jax's dots_saveable)
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
REMAT = ("none", "dots", "full")


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> Tuple[float, bool]:
    """optax.clip_by_global_norm in place: when the global norm is at least
    ``max_norm`` every gradient becomes (g / norm) * max_norm. Returns the
    norm and whether every element of every gradient is finite (then the
    gradients are left as they are)."""
    finite = bool(torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if finite and norm >= max_norm:
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, max_norm)
    return float(norm), finite


class DMTrainer:
    """The UNet under training, the frozen teacher and mask encoder, the
    optimizer, its schedule, the EMA of the parameters and the step count.
    Weights are random (torch's default init, from the caller's seed) until
    loaded."""

    TEACHER_KEYS = ("real_vid_grid", "real_vid_conf", "ref_img_fea")

    def __init__(self, config: DMTrainConfig = DMTrainConfig(),
                 flow_ae: Optional[FlowAE] = None,
                 unet_kw: Optional[Dict[str, Any]] = None, device=None, seed: int = 0):
        if config.remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, not {config.remat!r}")
        self.config = config
        self.device = resolve_device(device)
        self.in_channels = 3 + config.fea_channels + 16
        kw: Dict[str, Any] = dict(dim=64, channels=self.in_channels,
                                  cond_pose=config.pose_dim, win_width=config.win_width,
                                  attn_mode="local", dtype=config.compute_dtype)
        kw.update(unet_kw or {})
        self.unet = Unet3D(**kw).to(self.device).train()
        self.diffusion = GaussianDiffusion(timesteps=1000, sampling_timesteps=20,
                                           null_cond_prob=config.null_cond_prob)
        self.flow_ae = (flow_ae or FlowAE()).to(self.device).eval().requires_grad_(False)
        self.face_loc = FaceLocEncoder().to(self.device).eval().requires_grad_(False)
        self.optimizer = OptaxAdam(self.unet.parameters(), lr=config.lr)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda count: cosine_decay(count, config.total_steps))
        self.ema = ([p.detach().clone() for p in self.unet.parameters()]
                    if config.ema_decay is not None else None)
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ----------------------------------------------------------------- inputs
    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: to_device(v, self.device) for k, v in batch.items()}

    def prepare_inputs(self, batch, jitter: Optional[Dict[str, torch.Tensor]] = None):
        """(jittered) video, reference image, condition rows and mouth
        landmarks, with the stage's frame-0 handling. ``jitter`` holds the
        color-jitter factors; they are drawn when jitter is on and none are
        given."""
        video = batch["video"].float() / 255.0
        if self.config.color_jitter:
            video = color_jitter_video(video, jitter, self.generator)
        ref_img = video[:, 0]
        cond, mouth_lmk = self.prepare_cond(batch)
        if self.config.stage == 2:
            video = video[:, 1:]
        return video, ref_img, cond, mouth_lmk

    def prepare_cond(self, batch):
        """Condition rows (audio ++ pose delta ++ blink delta against frame
        0) and mouth landmarks, with the stage's frame-0 slice."""
        pose = batch["pose"][..., : self.config.pose_dim].float()
        blink = batch["blink"].float()
        cond = torch.cat([batch["hubert"].float(), pose - pose[:, :1], blink - blink[:, :1]],
                         dim=-1)
        mouth_lmk = batch.get("mouth_lmk")
        if self.config.stage == 2:
            cond = cond[:, 1:]
            if mouth_lmk is not None:
                mouth_lmk = mouth_lmk[:, :-1]
        return cond, mouth_lmk

    @torch.no_grad()
    def teacher_precompute(self, video_255) -> Dict[str, torch.Tensor]:
        """The frozen teacher's three tensors for the cached-teacher mode;
        stage 2 splits frame 0 off as the reference first."""
        video = torch.as_tensor(video_255, device=self.device).float() / 255.0
        ref_img = video[:, 0]
        if self.config.stage == 2:
            video = video[:, 1:]
        return self.flow_ae.teacher_outputs(ref_img, video)

    # ------------------------------------------------------------------- loss
    def denoiser(self):
        """The UNet call of the loss, ``(x, t, cond, drop) -> eps``, under the
        config's ``remat``. The cond-drop mask comes in as an argument, so
        the recomputed forward draws nothing; the RNG state is kept anyway."""
        if self.config.remat == "none":
            return self.unet
        kw = dict(use_reentrant=False, preserve_rng_state=True)
        if self.config.remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 list(DOT_OPS))

        def denoise(x, t, cond, drop):
            return checkpoint(self.unet, x, t, cond, drop, **kw)
        return denoise

    def loss_fn(self, batch: Dict[str, torch.Tensor], draws: Optional[Dict[str, Any]] = None,
                mesh: Optional[Mesh] = None):
        """Total loss and the metrics {loss, floss, mouth_loss, total}.

        batch: video (B, T, H, W, 3) in [0, 255], hubert (B, T, 1024), pose
        (B, T, P), blink (B, T, 2), bbox (B, 6), optional mouth_lmk (B, T, K,
        2); or the TEACHER_KEYS instead of video (cached teacher: no teacher
        pass, no color jitter). ``draws`` may give the random draws of the
        step: 't' (B,), 'noise' (the x_start shape), 'drop' (B, T) bool and
        'jitter' (the color-jitter factors); what it lacks is drawn from the
        trainer's generator.

        With ``mesh`` the batch and the draws are the whole step's (what
        ``draws`` lacks is drawn at the whole batch's shapes), this rank
        keeps its rows and diffused frames, and the terms are its shares of
        the global means: their sums over the ranks are the global loss."""
        cfg = self.config
        draws = draws or {}
        rows = frames = slice(None)
        if mesh is not None:
            draws = self._whole_draws(batch, draws)
            rows = mesh.rows(batch["bbox"].shape[0])
            batch = {k: v[rows] for k, v in batch.items()}
            draws = {k: ({j: f[rows] for j, f in v.items()} if k == "jitter" else v[rows])
                     for k, v in draws.items()}
        if "real_vid_grid" in batch:
            teacher = {k: batch[k].float() for k in self.TEACHER_KEYS}
            cond, mouth_lmk = self.prepare_cond(batch)
            if mesh is not None:
                frames = mesh.frames(cond.shape[1])
                teacher.update({k: teacher[k][:, frames] for k in self.TEACHER_KEYS[:2]})
        else:
            video, ref_img, cond, mouth_lmk = self.prepare_inputs(batch, draws.get("jitter"))
            if mesh is not None:
                frames = mesh.frames(cond.shape[1])
                video = video[:, frames]
            with torch.no_grad():
                teacher = self.flow_ae.teacher_outputs(ref_img, video)
        cond = cond[:, frames]
        b, t = teacher["real_vid_grid"].shape[:2]
        x_start = torch.cat([teacher["real_vid_grid"], teacher["real_vid_conf"] * 2.0 - 1.0],
                            dim=-1)
        with torch.no_grad():
            mask_emb = self.face_loc(generate_bbox_mask(batch["bbox"], cfg.img_size))
        fea = teacher["ref_img_fea"]
        fea_t = fea[:, None].expand((b, t) + fea.shape[1:])
        mask_t = mask_emb[:, None].expand((b, t) + mask_emb.shape[1:])

        tvec = draws.get("t")
        if tvec is None:
            tvec = torch.randint(0, self.diffusion.timesteps, (b,), generator=self.generator,
                                 device=self.device)
        tvec = torch.as_tensor(tvec, device=self.device).long()
        noise, drop = (None if draws.get(k) is None
                       else torch.as_tensor(draws[k], device=self.device) for k in ("noise", "drop"))
        if mesh is not None:
            noise, drop = noise[:, frames], drop[:, frames]
        loss_elem, pred_x0, _ = self.diffusion.p_losses(
            self.denoiser(), x_start, tvec, fea_t, mask_t, cond, noise=noise, drop=drop,
            generator=self.generator, group=self.unet.seq.group())

        mmask = (None if mouth_lmk is None else
                 generate_mouth_mask(mouth_lmk[:, frames].float(), cfg.latent_size, cfg.img_size))
        floss = self._floss(pred_x0, x_start, mesh)
        if mesh is None:
            eps_loss = loss_elem.mean()
            if mmask is not None:
                mouth_loss = (loss_elem * mmask).sum() / mmask.sum().clamp_min(1.0)
        else:
            eps_loss = loss_elem.sum() / (loss_elem.numel() * mesh.size)
            if mmask is not None:
                mask_sum = all_reduce_sum(mmask.sum(), mesh.group(None))
                mouth_loss = (loss_elem * mmask).sum() / mask_sum.clamp_min(1.0)
        if mmask is None:
            mouth_loss = torch.zeros((), device=self.device)
        total = eps_loss + cfg.floss_weight * floss + cfg.mouth_weight * mouth_loss
        metrics = {"loss": eps_loss, "floss": floss, "mouth_loss": mouth_loss, "total": total}
        return total, metrics

    def _floss(self, pred_x0: torch.Tensor, x_start: torch.Tensor,
               mesh: Optional[Mesh]) -> torch.Tensor:
        """The MSE of the thresholded x0 prediction, or with ``use_fft_floss``
        the mean of ``hf_loss_2`` of its flow channels against the teacher's
        along the frames. With ``mesh``, this rank's share of the global
        mean: the FFT needs the whole clip, so a 'seq' rank gathers its
        row's frames, and the row's 'seq' ranks share the row's sum."""
        if self.config.use_fft_floss:
            pred, real = pred_x0[..., :2], x_start[..., :2]
            if mesh is not None:
                pred, real = (all_gather_grad(v, mesh.group("seq"), 1) for v in (pred, real))
            err = hf_loss_2(pred, real, dim=1)
        else:
            err = (pred_x0 - x_start).square()
        return err.mean() if mesh is None else err.sum() / (err.numel() * mesh.size)

    def _whole_draws(self, batch, draws: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The step's draws at the whole batch's shapes: those given, the
        rest from the trainer's generator, which holds the same state on
        every rank."""
        dev, gen = self.device, self.generator
        b = batch["bbox"].shape[0]
        if "real_vid_grid" in batch:
            t = batch["real_vid_grid"].shape[1]
        else:
            t = batch["video"].shape[1] - (1 if self.config.stage == 2 else 0)
        out = {k: torch.as_tensor(v, device=dev) for k, v in draws.items() if k != "jitter"}
        if self.config.color_jitter and "video" in batch:
            jitter = draws.get("jitter") or jitter_factors(b, gen, dev)
            out["jitter"] = {k: torch.as_tensor(v, device=dev) for k, v in jitter.items()}
        if "t" not in out:
            out["t"] = torch.randint(0, self.diffusion.timesteps, (b,), generator=gen, device=dev)
        if "noise" not in out:
            ls = self.config.latent_size
            out["noise"] = torch.randn((b, t, ls, ls, 3), generator=gen, device=dev)
        if "drop" not in out:
            out["drop"] = torch.rand((b, t), generator=gen, device=dev) < self.config.null_cond_prob
        return out

    # ------------------------------------------------------------------- step
    def train_step(self, batch: Dict[str, Any], draws: Optional[Dict[str, Any]] = None,
                   mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """One optimizer step; returns the metrics as floats, with
        'grads_finite' 1.0 or 0.0 and 'grad_norm' (before clipping). With
        ``mesh``, see :meth:`make_sharded_step`."""
        batch = self._batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        with self.unet.sharded_over(mesh):
            total, metrics = self.loss_fn(batch, draws, mesh)
            total.backward()
        grads = [p.grad for p in self.unet.parameters() if p.grad is not None]
        if mesh is not None:
            # each rank's grads are those of its share: their sum is the
            # gradient of the global loss
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh.group(None))
            for g, f in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(f.view_as(g))
            metrics = dict(zip(metrics, all_reduce_sum(
                torch.stack([v.detach() for v in metrics.values()]), mesh.group(None))))
        norm, finite = self.apply_gradients(grads)
        out = {k: v.item() for k, v in metrics.items()}
        out.update(grads_finite=float(finite), grad_norm=norm)
        return out

    def apply_gradients(self, grads: List[torch.Tensor]) -> Tuple[float, bool]:
        """The step's update from the UNet's ``.grad`` tensors ``grads``:
        clip them by their global norm, take the Adam and schedule step
        unless a gradient is not finite, clear the gradients, count the step
        and update the EMA. Returns (the norm before clipping, finite)."""
        norm, finite = clip_by_global_norm_(grads, self.config.grad_clip)
        if finite:
            self.optimizer.step()
            self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        if self.ema is not None:
            d = self.config.ema_decay
            with torch.no_grad():
                params = [p.detach() for p in self.unet.parameters()]
                torch._foreach_mul_(self.ema, d)
                torch._foreach_add_(self.ema, params, alpha=1 - d)
        return norm, finite

    def make_sharded_step(self, mesh: Mesh):
        """The train step over ``mesh`` (``dawn_tpu/train/train_dm.py:396-454``):
        ``step(batch, draws=None)``, called on every rank with the whole
        batch and the same draws (or none: every rank's generator draws the
        same). The batch rows go over 'data', the diffused frames over
        'seq' (the JAX spec table, ``:421-432``: every per-frame key is cut
        to the rank's frames, bbox and the per-video teacher feature to its
        rows only); stage 2 takes frame 0 of the whole clip as the reference
        on every rank. The noise, timesteps, condition drops and jitter
        factors are drawn for the whole batch and cut. The eps, floss and
        mouth terms are global means (the mouth mask's sum all-reduced), so
        each rank's loss is its share, and one all-reduce (sum) of the
        gradients gives the gradient of the global loss. Clipping, the NaN
        rollback, Adam and the EMA then run as in :meth:`train_step`, the
        same on every rank; the metrics are all-reduced. The diffused frame
        count must divide over 'seq', and T / seq must cover win_width."""
        def step(batch, draws=None):
            return self.train_step(batch, draws, mesh)
        return step

    # ------------------------------------------------------------- monitoring
    @torch.no_grad()
    def snapshot(self, batch: Dict[str, Any], max_frames: int = 4,
                 draws: Optional[Dict[str, Any]] = None,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The training monitor's panels (``dawn_tpu/train/train_dm.py:329-394``)
        for the first ``max_frames`` frames of the batch's first clip: the
        teacher's reconstruction of the clip from its frame 0, one noisy
        denoise at t = timesteps // 2 with the EMA weights (the parameters
        without an EMA), and the real and the predicted flow both decoded by
        the frozen generator from frame 0. ``draws`` may give 'noise' (1, T,
        h, w, 3) and 'drop' (1, T); what it lacks is drawn from a generator
        of its own seeded with ``seed`` (default: the trainer's step), never
        from the training generator, whose state every rank of a sharded run
        must keep alike while only one of them takes snapshots. Returns numpy
        panels of T frames each:
        'real_frames', 'real_decode', 'fake_decode' (T, H, W, 3) in [0, 1],
        and the uint8 figures 'real_flow_fig', 'fake_flow_fig',
        'real_conf_fig', 'fake_conf_fig' (T, S, S, 3) at the image size."""
        from dawn_tpu_torch.utils.misc import conf2fig, flow2fig

        cfg, draws = self.config, draws or {}
        video = to_device(batch["video"][:1], self.device).float() / 255.0
        t = min(max_frames, video.shape[1])
        video = video[:, :t]
        part = {k: to_device(batch[k][:1, :t], self.device).float()
                for k in ("hubert", "pose", "blink")}
        pose, blink = part["pose"][..., : cfg.pose_dim], part["blink"]
        cond = torch.cat([part["hubert"], pose - pose[:, :1], blink - blink[:, :1]], dim=-1)
        teacher = self.flow_ae.reconstruct_video(video[:, 0], video)
        x_start = torch.cat([teacher["real_vid_grid"], teacher["real_vid_conf"] * 2 - 1], -1)
        bbox = to_device(batch["bbox"][:1], self.device).float()
        mask_emb = self.face_loc(generate_bbox_mask(bbox, cfg.img_size))
        fea = teacher["ref_img_fea"]
        fea_t = fea[:, None].expand((1, t) + fea.shape[1:])
        mask_t = mask_emb[:, None].expand((1, t) + mask_emb.shape[1:])
        noise, drop = (None if draws.get(k) is None
                       else torch.as_tensor(np.asarray(draws[k]), device=self.device)
                       for k in ("noise", "drop"))
        gen = torch.Generator(device=self.device).manual_seed(
            self.step if seed is None else seed)
        tvec = torch.full((1,), self.diffusion.timesteps // 2, device=self.device)
        names = [n for n, _ in self.unet.named_parameters()]
        weights = dict(zip(names, self.ema or [p for p in self.unet.parameters()]))

        def denoise(x, tv, c, d):
            return torch.func.functional_call(self.unet, weights, (x, tv, c, d))

        _, pred_x0, _ = self.diffusion.p_losses(denoise, x_start, tvec, fea_t, mask_t, cond,
                                                noise=noise, drop=drop, generator=gen)
        fake_grid, fake_conf = pred_x0[..., :2], (pred_x0[..., 2:3] + 1) * 0.5
        dec = self.flow_ae.generator.decode_with_flow(video[0, :1].repeat(t, 1, 1, 1),
                                                      fake_grid[0], fake_conf[0])
        real_grid = teacher["real_vid_grid"][0].cpu().numpy()
        fake_grid = fake_grid[0].cpu().numpy()
        real_conf = teacher["real_vid_conf"][0, ..., 0].cpu().numpy()
        fake_conf = fake_conf[0, ..., 0].cpu().numpy()
        ls, size = real_grid.shape[1], cfg.img_size
        return {
            "real_frames": video[0].cpu().numpy(),
            "real_decode": teacher["real_out_vid"][0].cpu().numpy(),
            "fake_decode": dec["prediction"].cpu().numpy(),
            "real_flow_fig": np.stack([flow2fig(g, grid_size=ls, img_size=size)
                                       for g in real_grid]),
            "fake_flow_fig": np.stack([flow2fig(g, grid_size=ls, img_size=size)
                                       for g in fake_grid]),
            "real_conf_fig": np.stack([conf2fig(c, size) for c in real_conf]),
            "fake_conf_fig": np.stack([conf2fig(c, size) for c in fake_conf]),
        }

    # ------------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, Any]:
        """UNet, optimizer, schedule, EMA and step: what a run resumes from
        (the frozen teacher and mask encoder come from their own weights)."""
        return {"unet": self.unet.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "ema": self.ema, "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.unet.load_state_dict(state["unet"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        if self.ema is not None:
            with torch.no_grad():
                for e, s in zip(self.ema, state["ema"]):
                    e.copy_(s)
        self.step = int(state["step"])
