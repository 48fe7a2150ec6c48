"""PBnet CVAE + PatchGAN training.

Port of ``dawn_tpu/train/train_pbnet.py`` (reference
PBnet/src/train/train_cvae_ganloss_ann_eye.py: the 1-D conv PatchGAN over
pose sequences :51-88 with BCE real/fake, AdamW with a cosine schedule for
G and D, the KL annealing of cae.py:66-85, gradient clipping at 2.0; and
trainer_gan_ann.py's joint G + D step :63).

One step: G (the CVAE, in training mode: dropout on, no eval window) runs
on the batch; its loss is the CVAE's mixed loss plus the GAN term, the BCE
of the current D on G's output against "real". D's loss is the BCE of D on
the masked ground-truth motion change against "real" plus on G's output
(from the G before its update, detached) against "fake". Each of G and D
has its own optax ``chain(clip_by_global_norm(2.0), adamw(cosine_decay_
schedule(lr, total_steps)))``: b1 0.9, b2 0.999, eps 1e-8, weight decay
1e-4 (added as lr * wd * p inside the update), the schedule read at the
count before its increment, and no guard against non-finite gradients.

Across processes, :meth:`PBnetTrainer.make_sharded_step` is the JAX
package's data-parallel step (``:137``): every rank receives the whole
batch, draws the whole batch's z noise, dropout masks, MMD samples and
Hessian-penalty directions, keeps its rows, and contributes its share of
each loss (see :mod:`dawn_tpu_torch.models.pbnet.losses`: sums over the
whole batch's counts, the whole batch's extremes, its gathered z); one
all-reduce of the G and D gradients together then gives the gradients of
the whole batch's losses. The trainer lives on the card unless the caller
passes ``device="cpu"``.

The Hessian penalty ('hp') is taken of the encoder's posterior mean, with
no dropout, as a function of the motion change against frame 0 (the
reference's ``model.return_latent``; the JAX trainer passes no function
for it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.models.pbnet.cvae import CVAE, PBnetParams
from dawn_tpu_torch.models.pbnet.losses import no_reduce
from dawn_tpu_torch.parallel.mesh import GroupReduce, Mesh, all_reduce_sum
from dawn_tpu_torch.train import to_device
from dawn_tpu_torch.train.train_dm import OptaxAdam, clip_by_global_norm_, cosine_decay

WEIGHT_DECAY = 1e-4     # optax.adamw's default, which the JAX trainer keeps


class PatchGAN1D(nn.Module):
    """The 1-D conv discriminator over (B, T, D) motion sequences (:51-74):
    four k=4 convs with padding 1 (strides 2, 2, 1, 1), LeakyReLU 0.2, and
    LayerNorm (epsilon 1e-6, flax's) over the channels after conv2 and
    conv3. Channels-last in and out: (B, T, D) -> (B, T', 1); T >= 12."""

    def __init__(self, in_dim: int, base: int = 64):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, base, 4, stride=2, padding=1)
        self.conv2 = nn.Conv1d(base, base * 2, 4, stride=2, padding=1)
        self.norm2 = nn.LayerNorm(base * 2, eps=1e-6)
        self.conv3 = nn.Conv1d(base * 2, base * 4, 4, stride=1, padding=1)
        self.norm3 = nn.LayerNorm(base * 4, eps=1e-6)
        self.conv4 = nn.Conv1d(base * 4, 1, 4, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def conv(layer, h):               # channels-last in and out
            return layer(h.transpose(1, 2)).transpose(1, 2)

        h = F.leaky_relu(conv(self.conv1, x), 0.2)
        h = F.leaky_relu(self.norm2(conv(self.conv2, h)), 0.2)
        h = F.leaky_relu(self.norm3(conv(self.conv3, h)), 0.2)
        return conv(self.conv4, h)


def _bce_sum(logits: torch.Tensor, real: bool) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy against all-1 or all-0 labels,
    summed."""
    labels = torch.ones_like(logits) if real else torch.zeros_like(logits)
    return F.binary_cross_entropy_with_logits(logits, labels, reduction="sum")


@dataclasses.dataclass
class PBnetTrainConfig:
    lr: float = 1e-4
    total_steps: int = 100_000
    grad_clip: float = 2.0
    gan_weight: float = 1.0
    kind: str = "pose"             # 'pose' (6-d) | 'blink' (2-d)


class PBnetTrainer:
    """G (the CVAE, in training mode), D (:class:`PatchGAN1D`), their
    optimizers and schedules, the step count and the generator of the z
    noise and dropout (seeded with 0).
    Weights are torch's default init (from the caller's seed) until
    loaded."""

    def __init__(self, config: PBnetTrainConfig = PBnetTrainConfig(),
                 hp: Optional[PBnetParams] = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        if hp is None:
            dims = dict(pose=(6, 0), blink=(2, 0))[config.kind]
            hp = PBnetParams(pos_dim=dims[0], eye_dim=dims[1])
        self.model = CVAE(hp, device=self.device).train()
        self.disc = PatchGAN1D(hp.feature_dim).to(self.device)
        self.optimizers, self.schedulers = [], []
        for module in (self.model, self.disc):
            opt = OptaxAdam(module.parameters(), lr=config.lr, b1=0.9, b2=0.999,
                            weight_decay=WEIGHT_DECAY)
            self.optimizers.append(opt)
            self.schedulers.append(torch.optim.lr_scheduler.LambdaLR(
                opt, lambda count: cosine_decay(count, config.total_steps)))
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    # ----------------------------------------------------------------- loss
    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: to_device(v, self.device) for k, v in batch.items()}

    @staticmethod
    def _mask(batch) -> Optional[torch.Tensor]:
        if "lengths" not in batch:
            return None
        t = batch["x"].shape[1]
        return torch.arange(t, device=batch["x"].device)[None, :] < batch["lengths"][:, None]

    @staticmethod
    def _x_delta(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The motion change against frame 0, zero on padded frames (collate
        zero-pads x, so real and fake are padded alike)."""
        x_delta = x - x[:, :1]
        return x_delta if mask is None else x_delta * mask[..., None]

    def g_loss(self, batch: Dict[str, torch.Tensor], epoch: float = 0,
               draws: Optional[Dict[str, Any]] = None, total=no_reduce,
               shard: Optional[Tuple[int, slice]] = None):
        """The CVAE's mixed loss plus the GAN term (trainer_gan_ann.py:27-63):
        (total, the terms, G's output). batch: 'x' (B, T, D), 'hubert' (B,
        T, 1024), optional 'lengths' (B,): the losses are then masked to the
        valid frames and G's output is zero on the padded ones. ``draws``
        may give 'eps' (the z noise, B x T x latent), 'mmd' and 'hp'.
        ``shard``: see ``CVAE.forward``."""
        draws = draws or {}
        x = batch["x"].float()
        mask = self._mask(batch)
        eps = draws.get("eps")
        out = self.model(x, batch["hubert"], mask, generator=self.generator,
                         eps=None if eps is None else to_device(eps, self.device), shard=shard)

        def encode_fn(x_delta):
            return self.model.encoder(x[:, :1] + x_delta, batch["hubert"].float(), mask)["mu"]

        mixed, losses = self.model.compute_loss(out, self._x_delta(x, mask), mask, epoch,
                                                self.generator, draws, encode_fn, total, shard)
        logits = self.disc(out["output"])
        g_gan = _bce_sum(logits, True) / total(logits.new_tensor(float(logits.numel())))
        losses["g_gan"] = g_gan
        return mixed + self.config.gan_weight * g_gan, losses, out["output"]

    def d_loss(self, real: torch.Tensor, fake: torch.Tensor, total=no_reduce) -> torch.Tensor:
        """BCE of D on ``real`` against "real" plus on ``fake`` (detached)
        against "fake", each averaged."""
        rl, fl = self.disc(real), self.disc(fake.detach())
        return (_bce_sum(rl, True) / total(rl.new_tensor(float(rl.numel())))
                + _bce_sum(fl, False) / total(fl.new_tensor(float(fl.numel()))))

    # ----------------------------------------------------------------- step
    def train_step(self, batch: Dict[str, Any], epoch: float = 0,
                   draws: Optional[Dict[str, Any]] = None,
                   mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """One step of G and D; returns the metrics as floats (the loss
        terms, 'mixed', 'g_gan', 'd_loss', 'g_total'). ``epoch`` drives the
        KL annealing. With ``mesh``, see :meth:`make_sharded_step`."""
        batch = self._batch(batch)
        total, group, shard = no_reduce, None, None
        if mesh is not None:
            if mesh.shape["seq"] != 1:
                raise NotImplementedError(
                    f"the sharded PBnet step shards over 'data' only (mesh {mesh.shape})")
            n = batch["x"].shape[0]
            shard = (n, mesh.rows(n))
            batch = {k: v[shard[1]] for k, v in batch.items()}
            draws = dict(draws or {})
            if "eps" in draws:
                draws["eps"] = to_device(draws["eps"], self.device)[shard[1]]
            if "hp" in draws:
                draws["hp"] = to_device(draws["hp"], self.device)[:, shard[1]]
            group = mesh.group("data")
            if group is not None:
                total = GroupReduce(group)
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=True)
        g_params, d_params = list(self.model.parameters()), list(self.disc.parameters())
        g_total, metrics, fake = self.g_loss(batch, epoch, draws, total, shard)
        g_total.backward(inputs=g_params)       # G's GAN term through the current D
        d_total = self.d_loss(self._x_delta(batch["x"].float(), self._mask(batch)), fake,
                              total)
        d_total.backward(inputs=d_params)
        metrics = dict(metrics, d_loss=d_total, g_total=g_total)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in g_params + d_params]
        if group is not None:
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
            grads = list(flat.split([g.numel() for g in grads]))
            metrics = dict(zip(metrics, all_reduce_sum(
                torch.stack([v.detach() for v in metrics.values()]), group)))
        for p, g in zip(g_params + d_params, grads):
            p.grad = g.view_as(p)
        for params, opt, sched in zip((g_params, d_params), self.optimizers, self.schedulers):
            clip_by_global_norm_([p.grad for p in params], self.config.grad_clip)
            opt.step()
            sched.step()
            opt.zero_grad(set_to_none=True)
        self.step += 1
        return {k: float(v.detach()) for k, v in metrics.items()}

    def make_sharded_step(self, mesh: Mesh):
        """The data-parallel step over ``mesh`` ('data' only): ``step(batch,
        epoch=0, draws=None)``, called on every rank with the whole batch and
        the same draws (or none: every rank's generator draws the same z
        noise for the whole batch). Each rank keeps its rows and contributes
        its share of each loss (the masked means' frame counts and the
        other means' entry counts are all-reduced), and one all-reduce (sum)
        of the G and D gradients together gives the gradients of the whole
        batch's losses; clipping and the updates then run as in
        :meth:`train_step`, the same on every rank, and the metrics are
        all-reduced. Every loss of the registry is taken over the whole
        batch. The z noise, the dropout masks, the MMD samples and the
        Hessian-penalty directions are drawn for the whole batch by every
        rank's generator (the same state on every rank) and each rank keeps
        its rows, so the step draws what the unsharded step draws; given
        draws are the whole batch's ('hp' (k, B, T, D), 'mmd' (B*T,
        latent))."""
        def step(batch, epoch=0, draws=None):
            return self.train_step(batch, epoch, draws, mesh)
        return step

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> Dict[str, Any]:
        """G, D, their optimizers and schedules, the step count and the
        generator's state: what a run resumes from."""
        return {"g": self.model.state_dict(), "d": self.disc.state_dict(),
                "optimizers": [o.state_dict() for o in self.optimizers],
                "schedulers": [s.state_dict() for s in self.schedulers],
                "step": self.step, "rng": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["g"])
        self.disc.load_state_dict(state["d"])
        for opt, s in zip(self.optimizers, state["optimizers"]):
            opt.load_state_dict(s)
        for sched, s in zip(self.schedulers, state["schedulers"]):
            sched.load_state_dict(s)
        self.step = int(state["step"])
        self.generator.set_state(state["rng"].cpu())
