"""PBnet loss registry: every loss the reference's trainer can be configured
with (PBnet/src/models/tools/losses.py ``_matching_`` :154-156): rc, rcw,
kl, reg, ssim, var, mmd, hp.

Port of ``dawn_tpu/models/pbnet/losses.py``. All functions take masked
(B, T, D) motion tensors. The JAX package's two intended differences from
the reference stay:

- ``reg`` smooths the model's output (the reference's MSE between
  consecutive ground-truth deltas has no gradient);
- masked frames are left out by multiplication, with the reference's masked
  means, except ``kl``, which the reference averages over padded frames
  too (losses.py:67-71), as here.

``mmd`` and ``hp`` take their noise as tensors, or draw it from an explicit
``torch.Generator``.

For a data-parallel step every loss takes ``total``, the reductions over
the ranks (:class:`OneRank` here, ``dawn_tpu_torch.parallel.mesh.
GroupReduce`` across processes): called on a count it sums it over the
ranks, and ``sum``, ``min``, ``max`` and ``gather`` reduce a tensor. Each
loss then gives this rank's share of the whole batch's loss, and the
shares of the ranks add up to it:

- ``rc``, ``rcw``, ``reg``, ``kl``: the rank's sum over the whole batch's
  count;
- ``ssim``: the joint min and max are the whole batch's, and the mean of
  the SSIM map is a sum over the whole batch's count;
- ``var``: the rank's sum of per-(sequence, dim) variances over the whole
  batch's count, gated by the whole batch's mean;
- ``mmd``: computed on the whole batch's gathered z, divided by the number
  of ranks;
- ``hp``: the max over the ranks, divided by their number; its directions
  are drawn for the whole batch (``shard``) and cut to the rank's rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class OneRank:
    """The reductions of a loss over one rank: each is the identity."""

    size = 1

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        return count

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    min = max = gather = sum


no_reduce = OneRank()


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, total=no_reduce) -> torch.Tensor:
    """The mean over valid frames; x (B, T, D), mask (B, T)."""
    denom = total(mask.sum()).clamp_min(1.0) * x.shape[-1]
    return (x * mask[..., None]).sum() / denom


def rc_loss(out, x_delta, mask, total=no_reduce, **_):
    """MSE on the motion change over valid frames (losses.py:9-21)."""
    return _masked_mean((out - x_delta).square(), mask, total)


def rcw_loss(out, x_delta, mask, total=no_reduce, **_):
    """Per-dimension weighted MSE (losses.py:37-59): the rotations weighted
    3x for 6- or 7-d pose, the blink dims 3x in the joint 8-d layout."""
    w = {6: [3, 3, 3, 1, 1, 1], 7: [3, 3, 3, 1, 1, 1, 0.5],
         8: [3, 3, 3, 0, 0, 0, 3, 3]}.get(out.shape[-1], [1.0] * out.shape[-1])
    w = torch.tensor(w, dtype=out.dtype, device=out.device)
    return _masked_mean((out * w - x_delta * w).square(), mask, total)


def reg_loss(out, x_delta, mask, total=no_reduce, **_):
    """Temporal smoothness of the output (see the module docstring)."""
    d = out[:, 1:] - out[:, :-1]
    m = mask[:, 1:] * mask[:, :-1]
    denom = total(m.sum()).clamp_min(1.0) * out.shape[-1]
    return (d.square() * m[..., None]).sum() / denom


def kl_loss(mu, logvar, mask=None, total=no_reduce, **_):
    """Gaussian KL to N(0, 1), averaged over every entry, padded frames
    included, as the reference does (losses.py:67-71)."""
    kl = -0.5 * (1.0 + logvar - mu.square() - logvar.exp())
    return kl.sum() / total(kl.new_tensor(float(kl.numel())))


# ------------------------------------------------------------------ ssim

def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim_map(a: torch.Tensor, b: torch.Tensor, window_size: int = 3, val_range: float = 1.0,
             sigma: float = 0.5) -> torch.Tensor:
    """The 2-D SSIM map of (B, H, W) maps with a Gaussian window
    (ssim_loss.py:7-37: sigma 0.5, C1 = (0.01 v)^2, C2 = (0.03 v)^2), zero
    padded; its mean is the SSIM (the JAX package's ``ssim_2d``)."""
    win = torch.as_tensor(_gaussian_window(window_size, sigma), dtype=a.dtype,
                          device=a.device)[None, None]
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x[:, None], win, padding=pad)[:, 0]

    mu1, mu2 = filt(a), filt(b)
    s11 = filt(a * a) - mu1 * mu1
    s22 = filt(b * b) - mu2 * mu2
    s12 = filt(a * b) - mu1 * mu2
    c1 = (0.01 * val_range) ** 2
    c2 = (0.03 * val_range) ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)
    return num / den


def ssim_loss(out, x_delta, mask, total=no_reduce, **_):
    """1 - SSIM over the (frames x dims) map after a joint min/max
    normalisation (losses.py:73-98 ssimnorm_loss, window 3)."""
    lo = total.min(torch.minimum(x_delta.min(), out.min()))
    hi = total.max(torch.maximum(x_delta.max(), out.max()))
    scale = (hi - lo).clamp_min(1e-8)
    a = (x_delta - lo) / scale
    b = (out - lo) / scale
    ratio = ssim_map(a * mask[..., None], b * mask[..., None], window_size=3, val_range=1.0)
    return 1.0 / total.size - ratio.sum() / total(ratio.new_tensor(float(ratio.numel())))


def var_loss(out, x_delta, mask, total=no_reduce, **_):
    """The mean per-(sequence, dim) temporal variance of the output, zeroed
    when the whole batch's mean lies outside (0, 3) (losses.py:126-143
    comput_var_loss)."""
    v = out.var(dim=1, unbiased=True)
    share = v.sum() / total(v.new_tensor(float(v.numel())))
    whole = total.sum(share.detach())
    return torch.where((whole > 0) & (whole < 3), share, torch.zeros_like(share))


# ------------------------------------------------------------------- mmd

def _mmd_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = (x[:, None] - y[None]).square().mean(-1) / x.shape[-1]
    return torch.exp(-d)


def mmd_loss(z, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, total=no_reduce, **_):
    """Gaussian-kernel MMD between q(z) and N(0, 1) samples (mmd.py:17-22),
    z flattened to (N, latent) as the reference's batch['z'] (the whole
    batch's, gathered over the ranks). ``noise`` (N, latent) are the N(0, 1)
    samples, drawn from ``generator`` unless given."""
    zf = total.gather(z.reshape(-1, z.shape[-1]))
    true = (torch.randn(zf.shape, generator=generator, device=zf.device, dtype=zf.dtype)
            if noise is None else torch.as_tensor(noise, dtype=zf.dtype, device=zf.device))
    return (_mmd_kernel(true, true).mean() + _mmd_kernel(zf, zf).mean()
            - 2.0 * _mmd_kernel(true, zf).mean()) / total.size


# ------------------------------------------------- hessian penalty (hp)

def hessian_penalty(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, k: int = 2,
                    epsilon: float = 0.1, dzs: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, total=no_reduce,
                    shard: Optional[Tuple[int, slice]] = None) -> torch.Tensor:
    """The Hessian penalty (Peebles et al. 2020, arXiv 2008.10599) of ``fn``'s
    output with respect to ``x``: the variance of central second
    differences along k Rademacher directions, max-reduced
    (hessian_penalty.py defaults k=2, epsilon=0.1, reduction=max). ``dzs``
    (k, *x.shape) are the directions times epsilon, drawn from ``generator``
    unless given; with ``shard`` = (n, rows), x holds the rows ``rows`` of a
    batch of n, and the directions are drawn for the whole batch and cut.
    The reference applies it to the encoder's latent (losses.py:62-64
    through model.return_latent)."""
    if dzs is None:
        n, rows = shard or (x.shape[0], slice(None))
        signs = torch.randint(0, 2, (k, n) + tuple(x.shape[1:]), generator=generator,
                              device=x.device)[:, rows].to(x.dtype)
        dzs = epsilon * (2.0 * signs - 1.0)
    dzs = torch.as_tensor(dzs, dtype=x.dtype, device=x.device)
    center = fn(x)
    seconds = torch.stack([(fn(x + dz) - 2.0 * center + fn(x - dz)) / epsilon ** 2
                           for dz in dzs])
    return total.max(seconds.var(dim=0, unbiased=True).max()) / total.size


_matching_: Dict[str, Callable] = {
    "rc": rc_loss, "rcw": rcw_loss, "reg": reg_loss, "kl": kl_loss,
    "ssim": ssim_loss, "var": var_loss, "mmd": mmd_loss,
}


def get_loss_function(ltype: str) -> Callable:
    return _matching_[ltype]


def get_loss_names():
    return list(_matching_.keys()) + ["hp"]
