"""LFG (flow autoencoder) training: reconstruction and equivariance.

Port of ``dawn_tpu/train/train_lfg.py`` (reference LFG/train.py and
LFG/modules/model.py ReconstructionModel, :141-216). One step runs the four
LFG nets with train-mode BatchNorm on a (source, driving) pair and minimises

- the multi-scale perceptual loss: at each scale of ``scales`` both frames
  go through ``anti_alias_downsample`` and VGG19 (:class:`Vgg19Features`,
  frozen), and each of its five taps adds weight x mean |f(pred) - f(gt)|,
  the ground truth's features without gradient;
- the shift equivariance: the driving frame is warped by a random thin-plate
  spline (:func:`random_tps_params`, :func:`tps_warp_coordinates`), the
  region predictor runs on the warped frame, and its region centres mapped
  back through the warp must be the driving frame's;
- the affine equivariance: the warp's Jacobian at those centres
  (:func:`tps_jacobian`, closed form) times the warped frame's region
  affines, left-multiplied by the inverse of the driving affines, must be
  the identity.

The region predictor runs three times a step (source, driving, warped
frame), and each run moves its running statistics in turn, as the
reference's consecutive forwards do. The update is optax's ``adam(lr,
b1=0.5, b2=0.999)`` (eps 1e-8) with the reference's MultiStepLR as optax's
``piecewise_constant_schedule``: the rate is multiplied by ``milestone_gamma``
from step ``m * steps_per_epoch`` on for each milestone m, read at the step
count before its increment. The trainer lives on the card unless the caller
passes ``device="cpu"``.

Across processes, :meth:`LFGTrainer.make_sharded_step` is the JAX package's
data-parallel step (``:214``): every rank receives the whole batch and the
same warp draws, keeps its rows, sums each BatchNorm's statistics over the
ranks (so they are the whole batch's, as GSPMD makes them in JAX) and
contributes its share of each loss term; one all-reduce of the gradients
then gives the gradient of the whole batch's loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.models.lfg.blocks import set_bn_group
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.models.lfg.vgg import Vgg19Features
from dawn_tpu_torch.models.lfg.warp import anti_alias_downsample, make_coordinate_grid
from dawn_tpu_torch.ops.resample import grid_sample
from dawn_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from dawn_tpu_torch.train import to_device
from dawn_tpu_torch.train.train_dm import OptaxAdam
from dawn_tpu_torch.weights.checkpoints import lfg_reference_state


# ------------------------------------------------------------- random warps

def random_tps_params(batch: int, sigma_affine: float = 0.05, sigma_tps: float = 0.005,
                      points_tps: int = 5, generator: Optional[torch.Generator] = None,
                      device=None, draws: Optional[Dict[str, Any]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A random affine plus TPS warp per sample (model.py Transform.__init__):
    theta (B, 2, 3) = I + sigma_affine N(0, 1), the control points (K, 2) on
    a points_tps^2 grid, their weights (B, 1, K) = sigma_tps N(0, 1). The
    standard normals come from ``draws`` ('affine' (B, 2, 3), 'tps' (B, 1,
    K)) when given, else from ``generator``."""
    k = points_tps ** 2
    draws = draws or {}
    noise = [to_device(draws[n], device) if n in draws else
             torch.randn(shape, generator=generator, device=device)
             for n, shape in (("affine", (batch, 2, 3)), ("tps", (batch, 1, k)))]
    theta = noise[0] * sigma_affine + torch.eye(2, 3, device=device)
    control_points = make_coordinate_grid(points_tps, points_tps, device=device).reshape(-1, 2)
    return theta, control_points, noise[1] * sigma_tps


def tps_warp_coordinates(coords: torch.Tensor, theta: torch.Tensor,
                         control_points: torch.Tensor, control_params: torch.Tensor
                         ) -> torch.Tensor:
    """Warp coordinates (B, N, 2) (model.py:107-127): the affine, plus the
    scalar TPS term s = sum_k w_k r_k^2 log(r_k + 1e-6), r_k the L1 distance
    to control point k, added to both coordinates."""
    transformed = torch.einsum("bij,bnj->bni", theta[:, :, :2], coords) + theta[:, None, :, 2]
    d = coords[:, :, None, :] - control_points[None, None]      # (B, N, K, 2)
    dist = d.abs().sum(-1)
    kern = dist ** 2 * torch.log(dist + 1e-6)
    return transformed + (kern * control_params).sum(-1)[..., None]


def tps_jacobian(points: torch.Tensor, theta: torch.Tensor, control_points: torch.Tensor,
                 control_params: torch.Tensor) -> torch.Tensor:
    """The Jacobian (B, R, 2, 2) of :func:`tps_warp_coordinates` at points
    (B, R, 2), in closed form: the affine part plus ds/dc, added to both
    rows, with ds/dc_j = sum_k w_k (2 r log(r + 1e-6) + r^2 / (r + 1e-6))
    sign(c_j - p_kj). Differentiable in the points (the gradient of the
    affine equivariance reaches the region centres through it)."""
    d = points[:, :, None, :] - control_points[None, None]      # (B, R, K, 2)
    dist = d.abs().sum(-1)
    dkern = 2 * dist * torch.log(dist + 1e-6) + dist ** 2 / (dist + 1e-6)
    ds = ((dkern * control_params)[..., None] * torch.sign(d)).sum(2)   # (B, R, 2)
    return theta[:, None, :, :2] + ds[:, :, None, :]


def milestone_factor(count: int, boundaries: Sequence[int], gamma: float) -> float:
    """optax.piecewise_constant_schedule's factor at ``count``: gamma for each
    boundary b with count >= b."""
    return gamma ** sum(count >= b for b in sorted(set(boundaries)))


# ---------------------------------------------------------------- trainer

@dataclasses.dataclass
class LFGTrainConfig:
    lr: float = 2e-4
    scales: Tuple[float, ...] = (1, 0.5, 0.25, 0.125)
    perceptual_weights: Tuple[float, ...] = (10, 10, 10, 10, 10)
    equivariance_shift: float = 10.0
    equivariance_affine: float = 10.0
    sigma_affine: float = 0.05
    sigma_tps: float = 0.005
    points_tps: int = 5
    epoch_milestones: Tuple[int, ...] = (60, 90)
    steps_per_epoch: int = 0  # 0: no milestone decay (constant rate)
    milestone_gamma: float = 0.1


class LFGTrainer:
    """The four LFG nets under training (train-mode BatchNorm), the frozen
    VGG19, the optimizer, its schedule, the step count and the generator of
    the warp draws (seeded with 0). Weights
    are torch's default init (from the caller's seed) until loaded."""

    def __init__(self, config: LFGTrainConfig = LFGTrainConfig(),
                 flow_ae: Optional[FlowAE] = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        bn = dict(train_bn=True)
        self.flow_ae = (flow_ae or FlowAE(generator_kw=bn, region_kw=bn, bg_kw=bn, flow_kw=bn)
                        ).to(self.device)
        self.vgg = Vgg19Features().to(self.device).eval().requires_grad_(False)
        self.optimizer = OptaxAdam(self.flow_ae.parameters(), lr=config.lr, b1=0.5, b2=0.999)
        boundaries = ([m * config.steps_per_epoch for m in config.epoch_milestones]
                      if config.steps_per_epoch else [])
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer,
            lambda count: milestone_factor(count, boundaries, config.milestone_gamma))
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    # ----------------------------------------------------------------- loss
    def _perceptual(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """The multi-scale VGG pyramid L1 (model.py:178-187)."""
        cfg = self.config
        total = pred.new_zeros(())
        for scale in cfg.scales:
            fp = self.vgg(anti_alias_downsample(pred, scale))
            with torch.no_grad():
                fg = self.vgg(anti_alias_downsample(gt, scale))
            for w, a, b in zip(cfg.perceptual_weights, fp, fg):
                total = total + w * (a - b).abs().mean()
        return total

    def loss_fn(self, batch: Dict[str, torch.Tensor], draws: Optional[Dict[str, Any]] = None,
                share: float = 1.0):
        """Total loss and the metrics {perceptual, equivariance_shift,
        equivariance_affine, total}. batch: 'source' and 'driving' (B, H, W,
        3) in [0, 1]; ``draws`` may give the warp's standard normals
        ('affine' (B, 2, 3), 'tps' (B, 1, 25)), else they are drawn from the
        trainer's generator. Each term is multiplied by ``share`` (this
        rank's part of a data-parallel batch)."""
        cfg = self.config
        src, drv = batch["source"], batch["driving"]
        b, h, w = drv.shape[:3]
        fa = self.flow_ae
        src_params = fa.region_predictor(src)
        drv_params = fa.region_predictor(drv)
        bg = fa.bg_predictor(src, drv)
        motion = fa.pixelwise_flow_predictor(src, drv_params, src_params, bg)
        out = fa.generator(src, motion)
        losses = {"perceptual": self._perceptual(out["prediction"], drv)}

        # equivariance under a random TPS warp (model.py:189-215)
        theta, cp, cw = (x.to(drv.dtype) for x in random_tps_params(
            b, cfg.sigma_affine, cfg.sigma_tps, cfg.points_tps, self.generator, self.device,
            draws))
        grid = make_coordinate_grid(h, w, drv.dtype, self.device).reshape(1, -1, 2).expand(
            b, h * w, 2)
        warped_grid = tps_warp_coordinates(grid, theta, cp, cw)
        transformed = grid_sample(drv, warped_grid.reshape(b, h, w, 2))
        trans_params = fa.region_predictor(transformed)
        recovered = tps_warp_coordinates(trans_params["shift"], theta, cp, cw)
        losses["equivariance_shift"] = cfg.equivariance_shift * (
            drv_params["shift"] - recovered).abs().mean()
        if cfg.equivariance_affine > 0:
            jac = tps_jacobian(trans_params["shift"], theta, cp, cw)
            normed = torch.linalg.inv(drv_params["affine"]) @ (jac @ trans_params["affine"])
            eye = torch.eye(2, dtype=drv.dtype, device=self.device)
            losses["equivariance_affine"] = cfg.equivariance_affine * (
                eye - normed).abs().mean()
        losses = {k: v * share for k, v in losses.items()}
        total = sum(losses.values())
        losses["total"] = total
        return total, losses

    # ----------------------------------------------------------------- step
    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: to_device(v, self.device).float() for k, v in batch.items()}

    @contextlib.contextmanager
    def _bn_group(self, group):
        set_bn_group(self.flow_ae, group)
        try:
            yield
        finally:
            set_bn_group(self.flow_ae, None)

    def train_step(self, batch: Dict[str, Any], draws: Optional[Dict[str, Any]] = None,
                   mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """One optimizer step; returns the metrics as floats. With ``mesh``,
        see :meth:`make_sharded_step`."""
        batch = self._batch(batch)
        group, share = None, 1.0
        if mesh is not None:
            if mesh.shape["seq"] != 1:
                raise ValueError(f"the LFG step shards over 'data' only, not {mesh.shape}")
            b = batch["source"].shape[0]
            draws = draws or {
                "affine": torch.randn((b, 2, 3), generator=self.generator, device=self.device),
                "tps": torch.randn((b, 1, self.config.points_tps ** 2),
                                   generator=self.generator, device=self.device)}
            rows = mesh.rows(b)
            batch = {k: v[rows] for k, v in batch.items()}
            draws = {k: to_device(v, self.device)[rows] for k, v in draws.items()}
            group, share = mesh.group("data"), 1.0 / mesh.shape["data"]
        self.optimizer.zero_grad(set_to_none=True)
        with self._bn_group(group):
            total, metrics = self.loss_fn(batch, draws, share)
            total.backward()
        if group is not None:
            grads = [p.grad for p in self.flow_ae.parameters() if p.grad is not None]
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
            for g, f in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(f.view_as(g))
            metrics = dict(zip(metrics, all_reduce_sum(
                torch.stack([v.detach() for v in metrics.values()]), group)))
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return {k: v.item() for k, v in metrics.items()}

    def make_sharded_step(self, mesh: Mesh):
        """The data-parallel step over ``mesh`` ('data' only):
        ``step(batch, draws=None)``, called on every rank with the whole
        batch and the same draws (or none: every rank's generator draws the
        same). Each rank keeps its rows; BatchNorm statistics are summed
        over the ranks, each loss term is the rank's share of the whole
        batch's mean, and one all-reduce (sum) of the gradients gives the
        gradient of the whole batch's loss, so the update and the running
        statistics are the same on every rank; the metrics are
        all-reduced."""
        def step(batch, draws=None):
            return self.train_step(batch, draws, mesh)
        return step

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> Dict[str, Any]:
        """The four nets in the reference ``LFG_*.pth`` layout (the flow
        predictor nested in the generator), the optimizer, its schedule, the
        step count and the warp generator's state."""
        return {**lfg_reference_state(self.flow_ae), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step,
                "rng": self.generator.get_state()}

    def load_checkpoint(self, path: str) -> None:
        """Resume from a saved :meth:`state_dict` (the nets read strictly)."""
        self.flow_ae.load_reference_checkpoint(path)
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        self.generator.set_state(state["rng"].cpu())
