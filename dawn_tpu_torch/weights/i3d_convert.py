"""pytorch-i3d checkpoint -> the port's :class:`InceptionI3d`.

Port of ``dawn_tpu/weights/i3d_convert.py``. The public FVD backbone weights
are state dicts of the pytorch-i3d ``InceptionI3d`` module, whose names the
port's module keeps, so nothing is renamed or transposed: the file is read
with ``torch.load(weights_only=True)`` (tensors only, no code) and loaded
strictly. A file written before BatchNorm had ``num_batches_tracked`` loads
too (PyTorch fills that counter in).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.evaluate.i3d import InceptionI3d


def load_i3d(path_or_state_dict: Union[str, Mapping[str, torch.Tensor]],
             device=None) -> InceptionI3d:
    """A pytorch-i3d ``.pt``/``.pth`` state dict (a path, or the loaded
    dict; a trainer's ``{'state_dict': ...}`` wrapper is unwrapped) -> the
    I3D in eval mode on ``device`` (the card unless 'cpu'). The class count
    and the width come from the file (the released file: 400 classes, full
    width)."""
    sd = path_or_state_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    num_classes = int(sd["logits.conv3d.weight"].shape[0])
    width_divisor = 64 // int(sd["Conv3d_1a_7x7.conv3d.weight"].shape[0])
    model = InceptionI3d(num_classes, width_divisor)
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device)).eval()
