"""MobileNet-V1, the 3DDFA 3DMM regressor of stage 1 ('mb1_120x120'), in the
reference's layout.

Port of ``dawn_tpu/models/face3d/mobilenet.py`` (the reference's
extract_init_states/models/mobilenet_v1.py ``mobilenet_1``): conv1, 13
depthwise-separable blocks, global average pool, fc to the 62 parameters.
NCHW; the state_dict names are the release file's (``conv1``, ``bn1``,
``dw2_1.conv_dw``/``.bn_dw``/``.conv_sep``/``.bn_sep`` ... ``dw6``, ``fc``),
read by ``convert_mobilenet`` (``dawn_tpu/models/face3d/mobilenet.py:
65-103``). The input is the 120x120 crop as (x - 127.5) / 128; the output
is z-scored (``param_mean_std_62d_120x120.pkl`` undoes it). Inference only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch import resolve_device

# (name, out_channels, stride) for widen_factor 1.0
DW_BLOCKS = [
    ("dw2_1", 64, 1), ("dw2_2", 128, 2),
    ("dw3_1", 128, 1), ("dw3_2", 256, 2),
    ("dw4_1", 256, 1), ("dw4_2", 512, 2),
    ("dw5_1", 512, 1), ("dw5_2", 512, 1), ("dw5_3", 512, 1),
    ("dw5_4", 512, 1), ("dw5_5", 512, 1), ("dw5_6", 1024, 2),
    ("dw6", 1024, 1),
]


class DepthWiseBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv_dw = nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False)
        self.bn_dw = nn.BatchNorm2d(cin, eps=1e-5)
        self.conv_sep = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn_sep = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        x = F.relu(self.bn_dw(self.conv_dw(x)))
        return F.relu(self.bn_sep(self.conv_sep(x)))


class MobileNetV1(nn.Module):
    """(N, 3, 120, 120) -> (N, num_classes). ``widen_factor`` scales every
    width by plain int() truncation, as mobilenet_v1.py:67-84 does (0.5 is
    the mb05_120x120 config point)."""

    def __init__(self, num_classes: int = 62, widen_factor: float = 1.0, device=None):
        super().__init__()
        wf = widen_factor
        self.conv1 = nn.Conv2d(3, int(32 * wf), 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(int(32 * wf), eps=1e-5)
        cin = int(32 * wf)
        for name, feats, stride in DW_BLOCKS:
            self.add_module(name, DepthWiseBlock(cin, int(feats * wf), stride))
            cin = int(feats * wf)
        self.fc = nn.Linear(cin, num_classes)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.to(self.device, torch.float32))))
        for name, _, _ in DW_BLOCKS:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))
