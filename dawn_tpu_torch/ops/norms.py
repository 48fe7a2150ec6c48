"""Normalization primitives of the DM UNet, channels-last.

Port of the channel LayerNorm of ``dawn_tpu/ops/norms.py`` and
``dawn_tpu/models/dm/unet3d.py:56-70``: gamma only, biased variance, and
statistics in float32 whatever the activation dtype.
"""

from __future__ import annotations

import torch


def channel_layer_norm_core(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) over the last axis, in float32."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def channel_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with gamma only; returns x's dtype."""
    return (channel_layer_norm_core(x, eps) * gamma.reshape(-1)).to(x.dtype)


def video_group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of a (B, T, H, W, C) video with statistics joint over
    (T, H, W, C/G), as torch ``nn.GroupNorm`` on (B, C, T, H, W) computes
    them. Float32 statistics; returns x's dtype."""
    b, t, h, w, c = x.shape
    xg = x.float().reshape(b, t * h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, h, w, c)
    return (y * weight + bias).to(x.dtype)
