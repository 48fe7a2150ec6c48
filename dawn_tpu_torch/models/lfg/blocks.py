"""LFG conv building blocks, channels-last.

Port of ``dawn_tpu/models/lfg/blocks.py`` (reference LFG/modules/util.py:70-214):
the four conv blocks and the Hourglass encoder/decoder of the region,
background and flow predictors. Convs run in the block's compute dtype;
BatchNorm computes in f32 (:class:`BatchNorm`). Every block takes an
explicit ``train_bn`` flag, as the JAX package's blocks do: BatchNorm
follows that flag and never ``nn.Module.training``, so a caller's
``.train()`` on a parent module does not switch an inference or teacher
net to batch statistics. Module names follow the reference ``state_dict``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch.ops.convs import conv2d_nhwc
from dawn_tpu_torch.ops.resample import avg_pool_2x2, interpolate_nearest
from dawn_tpu_torch.parallel.mesh import all_reduce_sum


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype) -> torch.Tensor:
    """``layer`` on an NHWC tensor in the compute dtype."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return conv2d_nhwc(x.to(dtype), layer.weight.to(dtype), bias,
                       stride=layer.stride[0], padding=layer.padding[0])


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d on NHWC, in f32 (or x's dtype if wider); returns x's
    dtype (the JAX package's
    ``SyncBatchNorm``, and the reference's SynchronizedBatchNorm2d).

    Without ``train_bn`` it normalises by the running statistics. With it,
    by the batch's: the sum, the sum of squares and the count per channel
    in f32, all-reduced over ``group`` when one is set (one differentiable
    all-reduce, so the statistics and their gradient are those of the
    whole batch over the ranks), mean = s / n and var = ss / n - mean^2;
    each call then moves the running statistics by momentum 0.1 towards
    the mean and the unbiased variance var * n / (n - 1)."""

    def __init__(self, features: int, train_bn: bool = False):
        super().__init__(features)
        self.train_bn = train_bn
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.train_bn:
            c = xf.shape[-1]
            flat = xf.reshape(-1, c)
            stats = all_reduce_sum(torch.cat([flat.sum(0), flat.square().sum(0),
                                              flat.new_full((1,), flat.shape[0])]), self.group)
            s, ss, cnt = stats[:c], stats[c:2 * c], stats[2 * c]
            mean = s / cnt
            var = ss / cnt - mean.square()
            with torch.no_grad():
                unbiased = var * (cnt / (cnt - 1.0).clamp_min(1.0))
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xf * inv + (self.bias - mean * inv)).to(x.dtype)


def set_bn_group(module: nn.Module, group) -> None:
    """Sum the batch statistics of every BatchNorm in ``module`` over the
    process ``group`` (None: this process's batch alone)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class SameBlock2d(nn.Module):
    """conv(k7, p3) + BN + relu."""

    def __init__(self, in_features: int, out_features: int, dtype, kernel_size: int = 7,
                 train_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, kernel_size,
                              padding=kernel_size // 2)
        self.norm = BatchNorm(out_features, train_bn)
        self.dtype = dtype

    def forward(self, x):
        return F.relu(self.norm(conv(x, self.conv, self.dtype)))


class DownBlock2d(nn.Module):
    """conv(k3, p1) + BN + relu + avgpool2."""

    def __init__(self, in_features: int, out_features: int, dtype, train_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm(out_features, train_bn)
        self.dtype = dtype

    def forward(self, x):
        return avg_pool_2x2(F.relu(self.norm(conv(x, self.conv, self.dtype))))


class UpBlock2d(nn.Module):
    """nearest x2 + conv(k3, p1) + BN + relu."""

    def __init__(self, in_features: int, out_features: int, dtype, train_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm(out_features, train_bn)
        self.dtype = dtype

    def forward(self, x):
        n, h, w, c = x.shape
        x = interpolate_nearest(x.to(self.dtype), h * 2, w * 2)
        return F.relu(self.norm(conv(x, self.conv, self.dtype)))


class ResBlock2d(nn.Module):
    """(BN-relu-conv) x2 + residual."""

    def __init__(self, features: int, dtype, train_bn: bool = False):
        super().__init__()
        self.norm1 = BatchNorm(features, train_bn)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = BatchNorm(features, train_bn)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        h = conv(F.relu(self.norm1(x)), self.conv1, self.dtype)
        h = conv(F.relu(self.norm2(h)), self.conv2, self.dtype)
        return h + x


class HourglassEncoder(nn.Module):
    """``num_blocks`` DownBlock2d; returns [input, every block's output]."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=torch.float32, train_bn: bool = False):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock2d(in_features if i == 0 else min(max_features, block_expansion * 2 ** i),
                        min(max_features, block_expansion * 2 ** (i + 1)), dtype, train_bn)
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
                 max_features: int = 256, dtype=torch.float32, train_bn: bool = False):
        super().__init__()
        ups = []
        for i in range(num_blocks)[::-1]:
            fin = (1 if i == num_blocks - 1 else 2) * min(max_features,
                                                          block_expansion * 2 ** (i + 1))
            ups.append(UpBlock2d(fin, min(max_features, block_expansion * 2 ** i), dtype,
                                 train_bn))
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
                 max_features: int = 256, dtype=torch.float32, train_bn: bool = False):
        super().__init__()
        self.encoder = HourglassEncoder(block_expansion, in_features, num_blocks,
                                        max_features, dtype, train_bn)
        self.decoder = HourglassDecoder(block_expansion, in_features, num_blocks,
                                        max_features, dtype, train_bn)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))
