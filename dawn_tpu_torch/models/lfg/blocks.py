"""LFG conv building blocks, channels-last, BatchNorm in eval mode.

Port of the inference side of ``dawn_tpu/models/lfg/blocks.py`` (reference
LFG/modules/util.py:70-214): the four conv blocks and the Hourglass
encoder/decoder of the region, background and flow predictors. BatchNorm
uses its running statistics and computes in f32; convs run in the block's
compute dtype. Module names follow the reference ``state_dict``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch.ops.convs import conv2d_nhwc
from dawn_tpu_torch.ops.resample import avg_pool_2x2, interpolate_nearest


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype) -> torch.Tensor:
    """``layer`` on an NHWC tensor in the compute dtype."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return conv2d_nhwc(x.to(dtype), layer.weight.to(dtype), bias,
                       stride=layer.stride[0], padding=layer.padding[0])


def batch_norm(x: torch.Tensor, norm: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm on NHWC, in f32; returns x's dtype."""
    inv = torch.rsqrt(norm.running_var + norm.eps) * norm.weight
    return (x.float() * inv + (norm.bias - norm.running_mean * inv)).to(x.dtype)


class SameBlock2d(nn.Module):
    """conv(k7, p3) + BN + relu."""

    def __init__(self, in_features: int, out_features: int, dtype, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, kernel_size,
                              padding=kernel_size // 2)
        self.norm = nn.BatchNorm2d(out_features)
        self.dtype = dtype

    def forward(self, x):
        return F.relu(batch_norm(conv(x, self.conv, self.dtype), self.norm))


class DownBlock2d(nn.Module):
    """conv(k3, p1) + BN + relu + avgpool2."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = nn.BatchNorm2d(out_features)
        self.dtype = dtype

    def forward(self, x):
        return avg_pool_2x2(F.relu(batch_norm(conv(x, self.conv, self.dtype), self.norm)))


class UpBlock2d(nn.Module):
    """nearest x2 + conv(k3, p1) + BN + relu."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = nn.BatchNorm2d(out_features)
        self.dtype = dtype

    def forward(self, x):
        n, h, w, c = x.shape
        x = interpolate_nearest(x.to(self.dtype), h * 2, w * 2)
        return F.relu(batch_norm(conv(x, self.conv, self.dtype), self.norm))


class ResBlock2d(nn.Module):
    """(BN-relu-conv) x2 + residual."""

    def __init__(self, features: int, dtype):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        h = conv(F.relu(batch_norm(x, self.norm1)), self.conv1, self.dtype)
        h = conv(F.relu(batch_norm(h, self.norm2)), self.conv2, self.dtype)
        return h + x


class HourglassEncoder(nn.Module):
    """``num_blocks`` DownBlock2d; returns [input, every block's output]."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=torch.float32):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock2d(in_features if i == 0 else min(max_features, block_expansion * 2 ** i),
                        min(max_features, block_expansion * 2 ** (i + 1)), dtype)
            for i in range(num_blocks))

    def forward(self, x) -> List[torch.Tensor]:
        outs = [x]
        for blk in self.down_blocks:
            outs.append(blk(outs[-1]))
        return outs


class HourglassDecoder(nn.Module):
    """UpBlock2d from the deepest feature up, each output concatenated with
    the encoder feature of its resolution; ends with
    ``block_expansion + in_features`` channels."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=torch.float32):
        super().__init__()
        ups = []
        for i in range(num_blocks)[::-1]:
            fin = (1 if i == num_blocks - 1 else 2) * min(max_features,
                                                          block_expansion * 2 ** (i + 1))
            ups.append(UpBlock2d(fin, min(max_features, block_expansion * 2 ** i), dtype))
        self.up_blocks = nn.ModuleList(ups)
        self.out_filters = block_expansion + in_features

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        xs = list(xs)
        out = xs.pop()
        for up in self.up_blocks:
            out = up(out)
            out = torch.cat([out, xs.pop().to(out.dtype)], dim=-1)
        return out


class Hourglass(nn.Module):
    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=torch.float32):
        super().__init__()
        self.encoder = HourglassEncoder(block_expansion, in_features, num_blocks,
                                        max_features, dtype)
        self.decoder = HourglassDecoder(block_expansion, in_features, num_blocks,
                                        max_features, dtype)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))
