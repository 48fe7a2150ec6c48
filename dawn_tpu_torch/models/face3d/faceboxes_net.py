"""FaceBoxes, the face detector of stage 1, in the reference's layout.

Port of ``dawn_tpu/models/face3d/faceboxes_net.py``, the network of the
reference's FaceBoxesProd.pth (FaceBoxes/models/faceboxes.py): rapidly
digested conv layers with CReLU, three inception blocks, and loc/conf heads
over the anchor strides 32, 64 and 128. NCHW; the state_dict names are the
release file's (``conv1.conv``/``.bn``, ``inception{1,2,3}.branch*.conv``/
``.bn``, ``conv3_1`` ... ``conv4_2``, ``loc.{i}``, ``conf.{i}``). Inference
only: BatchNorm uses its running statistics. The input is a BGR image minus
the BGR mean (``pipeline/face_prep.py``); the outputs are laid out as the
anchors of ``priors.prior_boxes``: each cell's anchors, cells row-major,
the three strides in turn. conf is softmaxed, as the reference's 'test'
phase does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch import resolve_device


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CRelu(nn.Module):
    """Conv + BatchNorm, then relu of (x, -x) stacked on channels."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, padding: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(torch.cat([x, -x], dim=1))


class Inception(nn.Module):
    """Four 32-channel branches over 128 channels."""

    def __init__(self):
        super().__init__()
        self.branch1x1 = BasicConv2d(128, 32, 1)
        self.branch1x1_2 = BasicConv2d(128, 32, 1)
        self.branch3x3_reduce = BasicConv2d(128, 24, 1)
        self.branch3x3 = BasicConv2d(24, 32, 3, padding=1)
        self.branch3x3_reduce_2 = BasicConv2d(128, 24, 1)
        self.branch3x3_2 = BasicConv2d(24, 32, 3, padding=1)
        self.branch3x3_3 = BasicConv2d(32, 32, 3, padding=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b2 = self.branch1x1_2(F.avg_pool2d(x, 3, stride=1, padding=1))
        b3 = self.branch3x3(self.branch3x3_reduce(x))
        b4 = self.branch3x3_3(self.branch3x3_2(self.branch3x3_reduce_2(x)))
        return torch.cat([b1, b2, b3, b4], dim=1)


class FaceBoxesNet(nn.Module):
    """(N, 3, H, W) BGR-mean-subtracted image -> (loc (N, A, 4), conf (N, A, 2))."""

    # anchors per cell of each head: 21 at stride 32 (densified), 1 at 64 and 128
    ANCHORS = (21, 1, 1)
    CLASSES = 2          # background, face

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = CRelu(3, 24, 7, 4, 3)
        self.conv2 = CRelu(48, 64, 5, 2, 2)
        self.inception1 = Inception()
        self.inception2 = Inception()
        self.inception3 = Inception()
        self.conv3_1 = BasicConv2d(128, 128, 1)
        self.conv3_2 = BasicConv2d(128, 256, 3, stride=2, padding=1)
        self.conv4_1 = BasicConv2d(256, 128, 1)
        self.conv4_2 = BasicConv2d(128, 256, 3, stride=2, padding=1)
        chans = (128, 256, 256)
        self.loc = nn.ModuleList(nn.Conv2d(c, a * 4, 3, padding=1)
                                 for c, a in zip(chans, self.ANCHORS))
        self.conf = nn.ModuleList(nn.Conv2d(c, a * self.CLASSES, 3, padding=1)
                                  for c, a in zip(chans, self.ANCHORS))
        self.device = resolve_device(device)
        self.to(self.device).eval()

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.conv1(x.to(self.device, torch.float32))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = F.max_pool2d(self.conv2(x), 3, stride=2, padding=1)
        f1 = self.inception3(self.inception2(self.inception1(x)))     # stride 32, 128 ch
        f2 = self.conv3_2(self.conv3_1(f1))                           # stride 64, 256 ch
        f3 = self.conv4_2(self.conv4_1(f2))                           # stride 128, 256 ch
        n = x.shape[0]

        def heads(layers, width):
            return torch.cat([layer(f).permute(0, 2, 3, 1).reshape(n, -1, width)
                              for layer, f in zip(layers, (f1, f2, f3))], dim=1)

        return heads(self.loc, 4), torch.softmax(heads(self.conf, self.CLASSES), dim=-1)
