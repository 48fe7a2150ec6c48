"""Normalization primitives of the DM UNet, channels-last.

Port of the channel LayerNorm of ``dawn_tpu/ops/norms.py`` and
``dawn_tpu/models/dm/unet3d.py:56-70``: gamma only, biased variance, and
statistics in float32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dawn_tpu_torch.parallel.mesh import all_reduce_sum


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
                     bias: torch.Tensor, eps: float = 1e-5,
                     group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """GroupNorm of a (B, T, H, W, C) video with statistics joint over
    (T, H, W, C/G), as torch ``nn.GroupNorm`` on (B, C, T, H, W) computes
    them. Float32 statistics; returns x's dtype.

    With ``group``, x holds this rank's frames of a video sharded over the
    group's ranks (equal counts), and the statistics are the whole video's:
    two f32 passes, an all-reduced sum for the mean, then an all-reduced
    centred sum of squares, both differentiable."""
    b, t, h, w, c = x.shape
    xg = x.float().reshape(b, t * h * w, num_groups, c // num_groups)
    if group is None:
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    else:
        count = xg.shape[1] * xg.shape[3] * dist.get_world_size(group)
        mean = all_reduce_sum(xg.sum(dim=(1, 3), keepdim=True), group) / count
        var = all_reduce_sum((xg - mean).square().sum(dim=(1, 3), keepdim=True),
                             group) / count
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, h, w, c)
    return (y * weight + bias).to(x.dtype)
