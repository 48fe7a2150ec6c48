"""Image resampling on channels-last tensors, torch semantics.

Port of ``dawn_tpu/ops/resample.py``. The JAX package reimplements these torch
ops exactly; here they are the torch ops themselves, wrapped for the NHWC
layout: bilinear ``grid_sample`` (align_corners=False, zeros padding unless
asked), bilinear and nearest ``interpolate``, and 2x2 average pooling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dawn_tpu_torch.ops.convs import _nchw, _nhwc


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """img (N, H, W, C), grid (N, Ho, Wo, 2) xy in [-1, 1] -> (N, Ho, Wo, C)."""
    out = F.grid_sample(_nchw(img), grid.to(img.dtype), mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    return _nhwc(out)


def grid_sample_shared(img: torch.Tensor, grid: torch.Tensor,
                       align_corners: bool = False,
                       padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ONE source per batch row at T flow fields.

    img (B, H, W, C); grid (B, T, Ho, Wo, 2) -> (B, T, Ho, Wo, C). The T
    grids are laid end to end as one (T*Ho*Wo, 1) sampling grid, so the
    source is never broadcast over T."""
    b, t, ho, wo, _ = grid.shape
    out = F.grid_sample(_nchw(img), grid.to(img.dtype).reshape(b, t * ho * wo, 1, 2),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)          # (B, C, P, 1)
    return out.reshape(b, img.shape[-1], t, ho, wo).permute(0, 2, 3, 4, 1)


def interpolate_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` on NHWC."""
    return _nhwc(F.interpolate(_nchw(img), size=(out_h, out_w), mode="bilinear",
                               align_corners=False))


def interpolate_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` on NHWC."""
    return _nhwc(F.interpolate(_nchw(img), size=(out_h, out_w), mode="nearest"))


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``nn.AvgPool2d(2)`` on NHWC."""
    return _nhwc(F.avg_pool2d(_nchw(x), 2))
