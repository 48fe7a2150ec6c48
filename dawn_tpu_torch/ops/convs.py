"""Convolutions on channels-last (N, H, W, C) tensors with torch weights.

The port keeps torch's own weight layouts: Conv2d (O, I, kh, kw) and
ConvTranspose2d (I, O, kh, kw). The JAX package stores the transposed-conv
kernel spatially flipped in HWIO (``dawn_tpu/models/dm/unet3d.py:692-710``);
:func:`unflip_conv_transpose_weight` undoes that once, when weights cross.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None,
                stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ``F.conv2d`` on NHWC input; weight (O, I, kh, kw)."""
    return _nhwc(F.conv2d(_nchw(x), weight, bias, stride=stride,
                          padding=padding))


def conv_transpose2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None,
                          stride: int = 2, padding: int = 1) -> torch.Tensor:
    """torch ``F.conv_transpose2d`` on NHWC input; weight (I, O, kh, kw)."""
    return _nhwc(F.conv_transpose2d(_nchw(x), weight, bias, stride=stride,
                                    padding=padding))


def unflip_conv_transpose_weight(w_flipped_hwio: np.ndarray) -> np.ndarray:
    """JAX pre-flipped HWIO (kh, kw, I, O) -> torch ConvTranspose (I, O, kh, kw)."""
    w = np.asarray(w_flipped_hwio)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def conv_transpose2d_torch(x: torch.Tensor, weight_flipped_hwio, bias=None,
                           stride: int = 2, padding: int = 1) -> torch.Tensor:
    """Same call as ``conv_transpose2d_torch`` of ``dawn_tpu/ops/convs.py``: NHWC input,
    the JAX package's pre-flipped HWIO kernel."""
    w = torch.as_tensor(unflip_conv_transpose_weight(weight_flipped_hwio),
                        dtype=x.dtype, device=x.device)
    return conv_transpose2d_nhwc(x, w, bias, stride, padding)
