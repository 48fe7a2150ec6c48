"""Inflated 3D Inception (I3D) — the standard FVD feature backbone, in torch.

Port of ``dawn_tpu/evaluate/i3d.py``: Kinetics-400 I3D (Carreira &
Zisserman 2017), whose released weights every FVD implementation shares
(``rgb_imagenet.pt`` from the public pytorch-i3d release). The module tree
and its state-dict names are pytorch-i3d's (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_3b.b1a.bn.running_mean``, ``logits.conv3d.bias``, ...), so the
release file loads strictly (:func:`dawn_tpu_torch.weights.i3d_convert.load_i3d`)
and the JAX package's ``convert_i3d`` reads the port's ``state_dict()``.

The layers are cuDNN's ``conv3d`` and PyTorch's pools on NCDHW: the JAX
package computes them with XLA convolutions, outside any Pallas kernel.
What the two frameworks do differently and this module does as JAX does:

- TF 'SAME' padding puts the odd element at the end, for the stride-2 convs
  and for every max pool; the pools pad with -inf;
- BatchNorm's eps is 1e-3;
- the logits head is a VALID (2, 7, 7) average pool, then the mean over
  what is left (and the 1x1x1 logits conv between the two for logits);
- the resize to 224^2 antialiases when it shrinks, as
  ``jax.image.resize(..., "bilinear")`` does.

Public functions take channels-last videos, (N, T, H, W, 3), as the JAX
package's do.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (branch channels [b0, b1a, b1b, b2a, b2b, b3b]) per inception module
INCEPTION_CFG = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}

BN_EPS = 1e-3


def tf_same_pad(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                value: float = 0.0) -> torch.Tensor:
    """TF 'SAME' padding of (B, C, T, H, W): per dim the total
    max((ceil(n / s) - 1) * s + k - n, 0), the odd element at the end."""
    pads = []
    for dim, (k, s) in enumerate(zip(kernel, stride)):
        n = x.shape[2 + dim]
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    flat = [p for lohi in reversed(pads) for p in lohi]     # (W_lo, W_hi, H_lo, ...)
    return F.pad(x, flat, value=value) if any(flat) else x


class Unit3D(nn.Module):
    """pytorch-i3d's Unit3D: a TF-SAME conv3d, BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, use_bias: bool = False, relu: bool = True):
        super().__init__()
        self.kernel, self.stride, self.relu = tuple(kernel), tuple(stride), relu
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, self.stride, padding=0, bias=use_bias)
        self.bn = nn.BatchNorm3d(cout, eps=BN_EPS, momentum=0.01) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(tf_same_pad(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class MaxPool3dSame(nn.Module):
    """A max pool with TF 'SAME' padding by -inf."""

    def __init__(self, kernel: Sequence[int], stride: Sequence[int]):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(tf_same_pad(x, self.kernel, self.stride, -math.inf),
                            self.kernel, self.stride)


class InceptionModule(nn.Module):
    def __init__(self, cin: int, cfg: Sequence[int]):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = cfg
        self.b0 = Unit3D(cin, b0)
        self.b1a = Unit3D(cin, b1a)
        self.b1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.b2a = Unit3D(cin, b2a)
        self.b2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.b3a = MaxPool3dSame((3, 3, 3), (1, 1, 1))
        self.b3b = Unit3D(cin, b3b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(self.b3a(x))], dim=1)


class InceptionI3d(nn.Module):
    """I3D with the released channel plan (a 7x7x7/2 stem, two conv blocks,
    nine inception modules, the (2, 7, 7) average pool and a 1x1x1 logits
    conv). ``width_divisor`` divides every width (tests run it at 1/8)."""

    def __init__(self, num_classes: int = 400, width_divisor: int = 1):
        super().__init__()
        s = lambda c: max(1, c // width_divisor)  # noqa: E731
        self.Conv3d_1a_7x7 = Unit3D(3, s(64), (7, 7, 7), (2, 2, 2))
        self.MaxPool3d_2a_3x3 = MaxPool3dSame((1, 3, 3), (1, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(s(64), s(64))
        self.Conv3d_2c_3x3 = Unit3D(s(64), s(192), (3, 3, 3))
        self.MaxPool3d_3a_3x3 = MaxPool3dSame((1, 3, 3), (1, 2, 2))
        cin = s(192)
        for name, cfg in INCEPTION_CFG.items():
            cfg = [s(c) for c in cfg]
            self.add_module(name, InceptionModule(cin, cfg))
            cin = cfg[0] + cfg[2] + cfg[4] + cfg[5]
        self.MaxPool3d_4a_3x3 = MaxPool3dSame((3, 3, 3), (2, 2, 2))
        self.MaxPool3d_5a_2x2 = MaxPool3dSame((2, 2, 2), (2, 2, 2))
        self.logits = Unit3D(cin, num_classes, use_bn=False, use_bias=True, relu=False)

    def forward(self, video: torch.Tensor, features: bool = True) -> torch.Tensor:
        """video (B, T, H, W, 3) in [-1, 1] (224^2, T >= 9 recommended) ->
        the averaged pre-logits embedding (B, 1024), the usual FVD feature,
        or with ``features=False`` the time-averaged logits (B, 400)."""
        x = video.permute(0, 4, 1, 2, 3)
        x = self.MaxPool3d_2a_3x3(self.Conv3d_1a_7x7(x))
        x = self.MaxPool3d_3a_3x3(self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x)))
        x = self.MaxPool3d_4a_3x3(self.Mixed_3c(self.Mixed_3b(x)))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = self.Mixed_5c(self.Mixed_5b(self.MaxPool3d_5a_2x2(x)))
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        if not features:
            x = self.logits(x)
        return x.mean(dim=(2, 3, 4))


def preprocess_videos(videos, size: int = 224, device=None) -> torch.Tensor:
    """(N, T, H, W, 3) float in [0, 1] (numpy or tensor) -> (N, T, size,
    size, 3) in [-1, 1] on ``device``: frame by frame bilinear, half-pixel
    centres, antialiased when it shrinks (``jax.image.resize``'s
    'bilinear')."""
    x = torch.as_tensor(videos, dtype=torch.float32, device=device)
    n, t, h, w, c = x.shape
    if (h, w) != (size, size):
        frames = x.reshape(n * t, h, w, c).permute(0, 3, 1, 2)
        frames = F.interpolate(frames, size=(size, size), mode="bilinear",
                               align_corners=False, antialias=True)
        x = frames.permute(0, 2, 3, 1).reshape(n, t, size, size, c)
    return x * 2.0 - 1.0


@torch.no_grad()
def i3d_video_features(model: InceptionI3d, videos: np.ndarray, batch: int = 4) -> np.ndarray:
    """(N, T, H, W, 3) in [0, 1] -> (N, 1024) f32 I3D features, ``batch``
    videos at a time on the model's device."""
    device = model.logits.conv3d.weight.device
    out = [model(preprocess_videos(videos[i:i + batch], device=device)).float().cpu().numpy()
           for i in range(0, len(videos), batch)]
    return np.concatenate(out, axis=0)


def fvd_i3d(model: InceptionI3d, real: np.ndarray, fake: np.ndarray, batch: int = 4) -> float:
    """Frechet Video Distance with the I3D backbone (the Frechet math of
    :func:`dawn_tpu_torch.evaluate.metrics.frechet_distance`)."""
    from dawn_tpu_torch.evaluate.metrics import frechet_distance
    return frechet_distance(i3d_video_features(model, real, batch),
                            i3d_video_features(model, fake, batch))
