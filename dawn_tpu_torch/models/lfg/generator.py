"""LFG flow-warping generator (Johnson architecture).

Port of ``dawn_tpu/models/lfg/generator.py:61-185``: ``encode`` gives the skip
pyramid of a source image, ``compute_fea`` its bottleneck feature (the
diffusion's image condition), and ``decode_with_flow_batched`` decodes
(B, T) flow and occlusion videos against the B sources, each encoded once,
all frames in one batch, every warp gathering the shared source.
``decode`` warps and decodes one frame per source (``:74-95``, through
``decode_shared``), and
``decode_with_flow`` (``:133-149``) decodes a (T, h, w) flow video against
one source (``decode_shared``) or against T sources, one a frame
(``decode``). Calling the module is the training path's motion transfer:
one flow per source. Module
names follow the reference generator's ``state_dict``; BatchNorm runs in
train mode when built with ``train_bn``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import torch
from torch import nn

from dawn_tpu_torch.models.lfg.blocks import (DownBlock2d, ResBlock2d, SameBlock2d,
                                              UpBlock2d, conv)
from dawn_tpu_torch.models.lfg.warp import apply_optical_shared, deform_input_shared


class LFGGenerator(nn.Module):
    def __init__(self, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 512, num_down_blocks: int = 2,
                 num_bottleneck_blocks: int = 6, dtype=torch.float32, train_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.first = SameBlock2d(num_channels, block_expansion, dtype, train_bn=train_bn)
        down, up = [], []
        for i in range(num_down_blocks):
            fin = min(max_features, block_expansion * 2 ** i)
            fout = min(max_features, block_expansion * 2 ** (i + 1))
            down.append(DownBlock2d(fin, fout, dtype, train_bn))
        for i in range(num_down_blocks):
            fin = min(max_features, block_expansion * 2 ** (num_down_blocks - i))
            fout = min(max_features, block_expansion * 2 ** (num_down_blocks - i - 1))
            up.append(UpBlock2d(fin, fout, dtype, train_bn))
        self.down_blocks = nn.ModuleList(down)
        self.up_blocks = nn.ModuleList(up)
        bottleneck_features = min(max_features, block_expansion * 2 ** num_down_blocks)
        self.bottleneck = nn.Sequential(OrderedDict(
            (f"r{i}", ResBlock2d(bottleneck_features, dtype, train_bn))
            for i in range(num_bottleneck_blocks)))
        self.final = nn.Conv2d(block_expansion, num_channels, 7, padding=3)

    def encode(self, source_image: torch.Tensor) -> List[torch.Tensor]:
        """Skip pyramid [s0 (full res), ..., s_n (bottleneck)] of (N, H, W, 3)."""
        out = self.first(source_image)
        skips = [out]
        for blk in self.down_blocks:
            out = blk(out)
            skips.append(out)
        return skips

    def compute_fea(self, source_image: torch.Tensor) -> torch.Tensor:
        """Bottleneck feature (N, H/4, W/4, 256)."""
        return self.encode(source_image)[-1]

    def decode(self, source_image: torch.Tensor, skips: List[torch.Tensor],
               optical_flow: torch.Tensor, occlusion_map: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """Warp + decode, one frame per source: the sources (N, H, W, 3), their
        skips, flow (N, h, w, 2) and occlusion (N, h, w, 1) share the batch N
        (:meth:`decode_shared` with one frame a source). Returns (N, H, W, 3)
        'prediction' and 'deformed'."""
        out = self.decode_shared(source_image, skips, optical_flow[:, None],
                                 occlusion_map[:, None])
        return {k: v[:, 0] for k, v in out.items()}

    def decode_shared(self, source_image: torch.Tensor, skips: List[torch.Tensor],
                      optical_flow: torch.Tensor, occlusion_map: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """Warp + decode with per-identity skips; flow (B, T, h, w, 2), occlusion
        (B, T, h, w, 1). Returns (B, T, H, W, 3) 'prediction' and 'deformed'."""
        b, t = optical_flow.shape[:2]
        out = apply_optical_shared(skips[-1], optical_flow, occlusion_map)
        out = self.bottleneck(out)
        for i, up in enumerate(self.up_blocks):
            out = apply_optical_shared(skips[-(i + 1)], optical_flow, occlusion_map, out)
            out = up(out)
        out = apply_optical_shared(skips[0], optical_flow, occlusion_map, out)
        out = torch.sigmoid(conv(out, self.final, self.dtype))
        out = apply_optical_shared(source_image.to(out.dtype), optical_flow,
                                   occlusion_map, out)
        return {
            "prediction": out.reshape((b, t) + out.shape[1:]).float(),
            "deformed": deform_input_shared(source_image, optical_flow).float(),
        }

    def decode_with_flow(self, source_image: torch.Tensor, optical_flow: torch.Tensor,
                         occlusion_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Decode a flow video: flow (T, h, w, 2), occlusion (T, h, w, 1), and
        one source (1, H, W, 3), encoded once and shared by the T frames, or T
        sources (T, H, W, 3), one a frame. Returns (T, H, W, 3) 'prediction'
        and 'deformed'."""
        t = optical_flow.shape[0]
        skips = self.encode(source_image)
        if source_image.shape[0] == 1 and t > 1:
            out = self.decode_shared(source_image, skips, optical_flow[None],
                                     occlusion_map[None])
            return {k: v[0] for k, v in out.items()}
        return self.decode(source_image, skips, optical_flow, occlusion_map)

    def decode_with_flow_batched(self, source_image: torch.Tensor,
                                 optical_flow: torch.Tensor,
                                 occlusion_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        """source_image (B, H, W, 3); flow (B, T, h, w, 2); occlusion (B, T, h, w, 1)."""
        return self.decode_shared(source_image, self.encode(source_image),
                                  optical_flow, occlusion_map)

    def forward(self, source_image: torch.Tensor, motion_params: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Motion transfer of (N, H, W, 3) sources by their own flows:
        ``motion_params`` holds 'optical_flow' (N, h, w, 2) and
        'occlusion_map' (N, h, w, 1) from the pixelwise flow predictor.
        Returns 'prediction' and 'deformed' (N, H, W, 3), 'bottle_neck_feat'
        and the two motion tensors."""
        skips = self.encode(source_image)
        flow, occ = motion_params["optical_flow"], motion_params["occlusion_map"]
        return {**self.decode(source_image, skips, flow, occ), "bottle_neck_feat": skips[-1],
                "optical_flow": flow, "occlusion_map": occ}
