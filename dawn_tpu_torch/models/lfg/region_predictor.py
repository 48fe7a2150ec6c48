"""Region predictor: 10 region heatmaps -> shift and PCA affine.

Port of ``dawn_tpu/models/lfg/region_predictor.py`` (reference
LFG/modules/region_predictor.py:28-118), channels-last, BatchNorm in train
mode when built with ``train_bn``. Module names follow the reference
``state_dict`` (``predictor.encoder.down_blocks.{i}``, ``regions``).

The affine of each region is u diag(sqrt(s)) from the SVD of its 2x2
covariance. The SVD's column signs reach the flow through
``source_affine @ inv(driving_affine)``, so they must be those of the JAX
package, whose CPU SVD is LAPACK ``sgesdd`` (as the reference's
``torch.svd`` on the CPU is). :func:`svd2x2` computes that SVD in closed
form, with sgesdd's own steps for a 2x2 matrix, so the card and the CPU give
the same signs:

1. a Householder reflection H1 maps the first column (a, b) to (beta, 0),
   beta = -sign(a) hypot(a, b) (``slarfg``), giving the upper bidiagonal
   [[beta, e], [0, h]] = H1 C;
2. that 2x2 is diagonalized by LAPACK's ``slasv2`` rotations; its left
   rotation (cos, sin) gives the bidiagonal's left vectors
   [[cos, -sin], [sin, cos]] (``sbdsqr``). When ``|e|`` is below sbdsqr's
   relative split threshold the matrix counts as diagonal: the vectors stay
   the identity, swapped into decreasing order of the singular values;
3. U = H1 @ those vectors (``sormbr``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch.models.lfg.blocks import Hourglass, conv
from dawn_tpu_torch.models.lfg.warp import anti_alias_downsample, make_coordinate_grid

_EPS = float(np.finfo(np.float32).eps) / 2        # LAPACK slamch('E') in single precision
_SPLIT_TOL = max(10.0, min(100.0, _EPS ** -0.125)) * _EPS   # sbdsqr's relative tolerance


def _slasv2_left(f, g, h):
    """Left rotation (cos, sin) and the singular values (|max|, |min|) of
    the upper triangular [[f, g], [0, h]], as LAPACK ``slasv2`` computes
    them (elementwise over tensors)."""
    one = torch.ones_like(f)
    swap = h.abs() > f.abs()
    ft, ht = torch.where(swap, h, f), torch.where(swap, f, h)
    fa, ha = ft.abs(), ht.abs()
    gt, ga = g, g.abs()
    safe_ga = torch.where(ga == 0, one, ga)
    safe_ft = torch.where(ft == 0, one, ft)

    # normal case
    d = fa - ha
    l = torch.where(d == fa, one, d / torch.where(fa == 0, one, fa))
    m = gt / safe_ft
    t = 2.0 - l
    mm, tt = m * m, t * t
    s = torch.sqrt(tt + mm)
    r = torch.where(l == 0, m.abs(), torch.sqrt(l * l + mm))
    a = 0.5 * (s + r)
    ssmin, ssmax = ha / a, fa * a
    t_tiny = torch.where(l == 0, torch.copysign(2 * one, ft) * torch.copysign(one, gt),
                         gt / torch.where(d == 0, one, torch.copysign(d, ft)) + m / t)
    t = torch.where(mm == 0, t_tiny, (m / (s + t) + m / (r + l)) * (1.0 + a))
    l = torch.sqrt(t * t + 4.0)
    crt, srt = 2.0 / l, t / l
    clt, slt = (crt + srt * m) / a, (ht / safe_ft) * srt / a

    # very large g against f (f/g below eps)
    huge = (ga > fa) & (fa / safe_ga < _EPS)
    clt = torch.where(huge, one, clt)
    slt = torch.where(huge, ht / torch.where(gt == 0, one, gt), slt)
    crt = torch.where(huge, one, crt)
    srt = torch.where(huge, ft / torch.where(gt == 0, one, gt), srt)
    ssmax = torch.where(huge, ga, ssmax)
    ssmin = torch.where(huge, torch.where(ha > 1, fa / (safe_ga / torch.where(ha == 0, one, ha)),
                                          (fa / safe_ga) * ha), ssmin)
    # diagonal
    diag = ga == 0
    clt, slt = torch.where(diag, one, clt), torch.where(diag, 0 * one, slt)
    crt, srt = torch.where(diag, one, crt), torch.where(diag, 0 * one, srt)
    ssmax, ssmin = torch.where(diag, fa, ssmax), torch.where(diag, ha, ssmin)

    csl = torch.where(swap, srt, clt)
    snl = torch.where(swap, crt, slt)
    return csl, snl, ssmax.abs(), ssmin.abs()


def svd2x2(c: torch.Tensor):
    """(U, S) of a batch of 2x2 matrices (..., 2, 2) with the column signs of
    LAPACK ``sgesdd`` (see the module docstring); S descending, U @
    diag(S) @ V^T = c."""
    a, b = c[..., 0, 0], c[..., 1, 0]          # the first column
    cc, dd = c[..., 0, 1], c[..., 1, 1]
    one = torch.ones_like(a)
    # 1. Householder on the first column: H1 = I - tau v v^T, v = (1, v2)
    reflect = b != 0
    beta = -torch.copysign(torch.hypot(a, b), a)
    safe_beta = torch.where(reflect, beta, one)
    tau = torch.where(reflect, (beta - a) / safe_beta, 0 * one)
    v2 = torch.where(reflect, b / torch.where(reflect, a - beta, one), 0 * one)
    diag0 = torch.where(reflect, beta, a)
    w = cc + v2 * dd
    e = cc - tau * w
    h = dd - tau * w * v2
    # 2. the bidiagonal's left vectors
    csl, snl, smax, smin = _slasv2_left(diag0, e, h)
    fa, ha = diag0.abs(), h.abs()
    mu = ha * (fa / torch.where(fa + e.abs() == 0, one, fa + e.abs()))
    thresh = _SPLIT_TOL * torch.minimum(fa, mu) / np.sqrt(2.0)
    split = e.abs() <= thresh
    order = ha > fa                            # split: sort into decreasing order
    u00 = torch.where(split, torch.where(order, 0 * one, one), csl)
    u10 = torch.where(split, torch.where(order, one, 0 * one), snl)
    u01 = torch.where(split, torch.where(order, one, 0 * one), -snl)
    u11 = torch.where(split, torch.where(order, 0 * one, one), csl)
    s0 = torch.where(split, torch.maximum(fa, ha), smax)
    s1 = torch.where(split, torch.minimum(fa, ha), smin)
    # 3. U = H1 @ U_bd, column by column
    w0, w1 = u00 + v2 * u10, u01 + v2 * u11
    u = torch.stack([torch.stack([u00 - tau * w0, u01 - tau * w1], dim=-1),
                     torch.stack([u10 - tau * w0 * v2, u11 - tau * w1 * v2], dim=-1)],
                    dim=-2)
    return u, torch.stack([s0, s1], dim=-1)


class RegionPredictor(nn.Module):
    """The PCA-affine predictor of the DAWN LFG configs (estimate_affine and
    pca_based on); the FOMM regression head (pca_based off) is not ported."""

    def __init__(self, block_expansion: int = 32, num_regions: int = 10,
                 num_channels: int = 3, max_features: int = 1024, num_blocks: int = 5,
                 temperature: float = 0.1, scale_factor: float = 0.25, pad: int = 3,
                 train_bn: bool = False):
        super().__init__()
        self.temperature, self.scale_factor = temperature, scale_factor
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks, max_features,
                                   train_bn=train_bn)
        self.regions = nn.Conv2d(self.predictor.out_filters, num_regions, 7, padding=pad)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (N, H, W, 3) in [0, 1] -> 'shift' (N, R, 2), 'heatmap' (N, R, h,
        w), 'covar', 'affine' and 'u' (N, R, 2, 2), and 'd' (N, R, 2)."""
        if self.scale_factor != 1:
            x = anti_alias_downsample(x, self.scale_factor)
        feature_map = self.predictor(x)
        prediction = conv(feature_map, self.regions,
                          torch.promote_types(feature_map.dtype, torch.float32))
        n, h, w, r = prediction.shape
        heat = F.softmax(prediction.reshape(n, h * w, r) / self.temperature,
                         dim=1).reshape(n, h, w, r)
        grid = make_coordinate_grid(h, w, heat.dtype, heat.device)
        mean = torch.einsum("nhwr,hwc->nrc", heat, grid)
        d = grid[None, :, :, None, :] - mean[:, None, None, :, :]         # (n, h, w, r, 2)
        covar = torch.einsum("nhwri,nhwrj,nhwr->nrij", d, d, heat)
        u, s = svd2x2(covar)
        return {"shift": mean, "heatmap": heat.permute(0, 3, 1, 2), "covar": covar,
                "affine": u * torch.sqrt(s)[..., None, :], "u": u, "d": torch.sqrt(s)}
