"""VGG19 feature slices of the LFG perceptual loss.

Port of ``dawn_tpu/models/lfg/vgg.py`` (reference LFG/modules/model.py
Vgg19, :19-60): ImageNet normalisation, then the first 29 layers of
torchvision's ``vgg19().features`` (13 convs with their ReLUs and four 2x2
max pools), giving the five ReLU outputs after the convs at positions 0, 5,
10, 19 and 28. The parameters keep torchvision's names (``features.{i}.
weight``), so torchvision's ``vgg19-dcbb9e9d.pth`` loads with
:meth:`Vgg19Features.load_torchvision` and no converter (its later layers
and classifier are skipped). Without that file the weights are torch's
default init from the caller's seed.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from dawn_tpu_torch.ops.convs import _nchw, _nhwc

# torchvision vgg19.features conv positions through the last tap
VGG19_CONVS = [
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256), (16, 256),
    (19, 512), (21, 512), (23, 512), (25, 512),
    (28, 512),
]
POOL_BEFORE = (5, 10, 19, 28)     # max pools at positions 4, 9, 18, 27
TAPS = (0, 5, 10, 19, 28)         # feature taps, after the conv's ReLU
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


class Vgg19Features(nn.Module):
    """x (N, H, W, 3) in [0, 1] -> the five tapped ReLU maps, channels-last."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        fin = 3
        for pos, width in VGG19_CONVS:
            if pos in POOL_BEFORE:
                layers.append(nn.MaxPool2d(2, 2))
            assert len(layers) == pos
            layers += [nn.Conv2d(fin, width, 3, padding=1), nn.ReLU()]
            fin = width
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.from_numpy(MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.from_numpy(STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = (_nchw(x) - self.mean) / self.std
        feats = []
        for i, layer in enumerate(self.features):
            h = layer(h)
            if i - 1 in TAPS:           # the ReLU after a tapped conv
                feats.append(_nhwc(h))
        return feats

    def load_torchvision(self, path: str) -> List[str]:
        """torchvision's VGG19 file (``features.{i}.*``) into this module;
        returns the entries skipped (the later layers and the classifier)."""
        from dawn_tpu_torch.weights.checkpoints import load_strict
        return load_strict(self, torch.load(path, map_location="cpu", weights_only=True), path)
