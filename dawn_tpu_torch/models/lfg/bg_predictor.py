"""Background motion predictor: one 3x3 affine transform from (source, driving).

Port of ``dawn_tpu/models/lfg/bg_predictor.py`` (reference
LFG/modules/bg_motion_predictor.py:15-58) for bg_type 'affine', the one the
DAWN configs use, channels-last, BatchNorm in train mode when built with
``train_bn``. Module names follow the reference ``state_dict``
(``encoder.down_blocks.{i}``, ``fc``).
"""

from __future__ import annotations

import torch
from torch import nn

from dawn_tpu_torch.models.lfg.blocks import HourglassEncoder


class BGMotionPredictor(nn.Module):
    def __init__(self, block_expansion: int = 32, num_channels: int = 3,
                 max_features: int = 1024, num_blocks: int = 5, bg_type: str = "affine",
                 train_bn: bool = False):
        super().__init__()
        if bg_type != "affine":
            raise NotImplementedError(f"bg_type {bg_type!r} is not ported (only 'affine')")
        self.encoder = HourglassEncoder(block_expansion, num_channels * 2, num_blocks,
                                        max_features, train_bn=train_bn)
        self.fc = nn.Linear(min(max_features, block_expansion * 2 ** num_blocks), 6)
        with torch.no_grad():          # the reference starts at the identity
            self.fc.weight.zero_()
            self.fc.bias.copy_(torch.tensor([1., 0., 0., 0., 1., 0.]))

    def forward(self, source_image: torch.Tensor, driving_image: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) pair -> (N, 3, 3) affine transform of the background."""
        bs = source_image.shape[0]
        feats = self.encoder(torch.cat([source_image, driving_image], dim=-1))
        pred = self.fc(feats[-1].mean(dim=(1, 2))).reshape(bs, 2, 3)
        last = torch.tensor([0., 0., 1.], dtype=pred.dtype, device=pred.device)
        return torch.cat([pred, last.expand(bs, 1, 3)], dim=1)
