"""The 3DDFA model zoo's other 3DMM regressors, in the reference's layouts.

Port of ``dawn_tpu/models/face3d/backbones.py`` (the reference's
extract_init_states/models/{mobilenet_v3,resnet}.py and the arch factory of
utils/onnx.py:17): ``MobileNetV3`` (small and large) and ``ResNet22``, NCHW,
with the state_dict names that ``convert_mobilenet_v3`` and
``convert_resnet22`` read (``backbones.py:229-316``), and
:func:`get_backbone`. The released DAWN checkpoints use MobileNet-V1
(``mobilenet.py``); these take the same slot for any zoo checkpoint.
Inference only: BatchNorm uses its running statistics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch import resolve_device


def _make_divisible(x: float, by: int = 8) -> int:
    # extract_init_states/models/mobilenet_v3.py:71-73
    return int(math.ceil(x / by) * by)


def _hswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _hsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
    return [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False),
            nn.BatchNorm2d(cout, eps=1e-5)]


class SEModule(nn.Module):
    """Squeeze-excite with an h-sigmoid gate (mobilenet_v3.py:44-60)."""

    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // reduction, bias=False), nn.ReLU(),
                                nn.Linear(c // reduction, c, bias=False))

    def forward(self, x):
        return x * _hsigmoid(self.fc(x.mean(dim=(2, 3))))[:, :, None, None]


class MobileBottleneck(nn.Module):
    """pw-expand / dw / SE / pw-linear with an optional residual
    (mobilenet_v3.py:76-119; SE sits before the post-dw activation).
    ``conv`` holds the reference's indices: 0-1 pw, 3-4 dw, 5 SE (an
    identity without one), 7-8 pw-linear."""

    def __init__(self, inp: int, oup: int, kernel: int, stride: int, exp: int, se: bool,
                 nl: str):
        super().__init__()
        self.act = _hswish if nl == "HS" else F.relu
        self.residual = stride == 1 and inp == oup
        pw, pw_bn = _conv_bn(inp, exp, 1)
        dw, dw_bn = _conv_bn(exp, exp, kernel, stride, groups=exp)
        lin, lin_bn = _conv_bn(exp, oup, 1)
        self.conv = nn.Sequential(pw, pw_bn, nn.Identity(), dw, dw_bn,
                                  SEModule(exp) if se else nn.Identity(), nn.Identity(),
                                  lin, lin_bn)

    def forward(self, x):
        c = self.conv
        h = self.act(c[1](c[0](x)))
        h = self.act(c[5](c[4](c[3](h))))
        h = c[8](c[7](h))
        return x + h if self.residual else h


# (kernel, exp, out, se, nl, stride): mobilenet_v3.py Tables 1/2
V3_SETTINGS = {
    "large": [
        (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
        (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
        (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
        (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
        (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
        (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
        (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
        (5, 960, 160, True, "HS", 1),
    ],
    "small": [
        (3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
        (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
        (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
        (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
        (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
        (5, 576, 96, True, "HS", 1),
    ],
}


class MobileNetV3(nn.Module):
    """mobilenet_v3.py:122-230 (small or large, widen_factor): ``features``
    = [stem conv-bn, the bottlenecks, tail conv-bn, pool, head 1x1 conv with
    bias], then ``fc``."""

    def __init__(self, num_classes: int = 62, widen_factor: float = 1.0, mode: str = "small",
                 device=None):
        super().__init__()
        wf = widen_factor
        last_channel = _make_divisible(1280 * wf) if wf > 1.0 else 1280
        layers = [nn.Sequential(*_conv_bn(3, 16, 3, stride=2))]
        cin = 16
        for k, exp, c, se, nl, s in V3_SETTINGS[mode]:
            cout = _make_divisible(c * wf)
            layers.append(MobileBottleneck(cin, cout, k, s, _make_divisible(exp * wf), se, nl))
            cin = cout
        last_conv = _make_divisible((960 if mode == "large" else 576) * wf)
        layers += [nn.Sequential(*_conv_bn(cin, last_conv, 1)), nn.Identity(),
                   nn.Conv2d(last_conv, last_channel, 1)]
        self.features = nn.Sequential(*layers)
        self.fc = nn.Linear(last_channel, num_classes)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    def forward(self, x):
        f = self.features
        x = _hswish(f[0](x.to(self.device, torch.float32)))
        for block in f[1:-3]:
            x = block(x)
        x = _hswish(f[-3](x)).mean(dim=(2, 3), keepdim=True)     # AdaptiveAvgPool2d(1)
        return self.fc(_hswish(f[-1](x)).flatten(1))


class BasicBlock(nn.Module):
    """resnet.py:15-45: 3x3-3x3 residual, a 1x1-conv ``downsample`` where
    the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = (nn.Sequential(*_conv_bn(inplanes, planes, 1, stride))
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


RESNET22_LAYERS = ((128, 3), (256, 4), (512, 3))   # resnet.py:135-142


class ResNet22(nn.Module):
    """resnet.py:47-132: 5x5/2 and 3x3 stems, three stride-2 stages, a 1x1
    conv head and a global pool."""

    def __init__(self, num_classes: int = 62, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 5, 2, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(32, eps=1e-5)
        self.conv2 = nn.Conv2d(32, 64, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64, eps=1e-5)
        cin = 64
        for li, (planes, blocks) in enumerate(RESNET22_LAYERS):
            layer = []
            for bi in range(blocks):
                layer.append(BasicBlock(cin, planes, 2 if bi == 0 else 1))
                cin = planes
            self.add_module(f"layer{li + 1}", nn.Sequential(*layer))
        self.conv_param = nn.Conv2d(cin, num_classes, 1)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.to(self.device, torch.float32))))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv_param(x).mean(dim=(2, 3))


def get_backbone(arch: str, device=None, **kw) -> nn.Module:
    """The regressor of a 3DDFA-zoo arch name ('mobilenet', 'mobilenet_v3',
    'resnet22'); ``kw`` as the reference configs: num_classes, widen_factor,
    mode. The JAX function returns its converter beside the module; the
    port's modules load the reference state_dicts as they are."""
    num_classes = kw.get("num_classes", 62)
    if arch == "mobilenet":
        from dawn_tpu_torch.models.face3d.mobilenet import MobileNetV1
        return MobileNetV1(num_classes, kw.get("widen_factor", 1.0), device=device)
    if arch == "mobilenet_v3":
        return MobileNetV3(num_classes, kw.get("widen_factor", 1.0), kw.get("mode", "small"),
                           device=device)
    if arch == "resnet22":
        return ResNet22(num_classes, device=device)
    raise ValueError(f"unknown 3DDFA backbone arch: {arch!r}")
