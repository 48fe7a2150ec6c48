"""Pixelwise flow predictor: sparse region motions -> dense flow + occlusion.

Port of ``dawn_tpu/models/lfg/pixelwise_flow.py`` (reference
LFG/modules/pixelwise_flow_predictor.py:17-138), channels-last, BatchNorm
in train mode when built with ``train_bn``. All region warps of the source
go through one batched ``grid_sample`` over the (num_regions + 1)
hypotheses. Module names follow the reference ``state_dict``
(``hourglass.encoder.down_blocks.{i}``, ``mask``, ``occlusion``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from dawn_tpu_torch.models.lfg.blocks import Hourglass, conv
from dawn_tpu_torch.models.lfg.warp import (anti_alias_downsample, make_coordinate_grid,
                                            region2gaussian)
from dawn_tpu_torch.ops.resample import grid_sample


class PixelwiseFlowPredictor(nn.Module):
    """The DAWN LFG configuration: covariance heatmaps, the deformed source in
    the hourglass input, and an occlusion map (``use_covar_heatmap``,
    ``use_deformed_source`` and ``estimate_occlusion_map`` on)."""

    def __init__(self, block_expansion: int = 64, num_blocks: int = 5,
                 max_features: int = 1024, num_regions: int = 10, num_channels: int = 3,
                 scale_factor: float = 0.25, revert_axis_swap: bool = True,
                 train_bn: bool = False):
        super().__init__()
        self.scale_factor, self.revert_axis_swap = scale_factor, revert_axis_swap
        r1 = num_regions + 1
        self.hourglass = Hourglass(block_expansion, r1 * (num_channels + 1), num_blocks,
                                   max_features, train_bn=train_bn)
        self.mask = nn.Conv2d(self.hourglass.out_filters, r1, 7, padding=3)
        self.occlusion = nn.Conv2d(self.hourglass.out_filters, 1, 7, padding=3)

    def heatmap_representations(self, h, w, driving_params, source_params):
        """Gaussian difference heatmaps with a zero background channel
        first: (N, R+1, h, w)."""
        heatmap = (region2gaussian(driving_params["shift"], driving_params["covar"], h, w)
                   - region2gaussian(source_params["shift"], source_params["covar"], h, w))
        return torch.cat([torch.zeros_like(heatmap[:, :1]), heatmap], dim=1)

    def sparse_motions(self, h, w, driving_params, source_params, bg_params=None):
        """Per-hypothesis driving->source coordinates (N, R+1, h, w, 2): the
        background transform first, then one per region."""
        shift_d, shift_s = driving_params["shift"], source_params["shift"]
        n = shift_d.shape[0]
        identity = make_coordinate_grid(h, w, shift_d.dtype, shift_d.device)
        coord = identity[None, None] - shift_d[:, :, None, None, :]
        affine = source_params["affine"] @ torch.linalg.inv(driving_params["affine"])
        if self.revert_axis_swap:
            affine = affine * torch.sign(affine[:, :, 0:1, 0:1])
        coord = torch.einsum("nrij,nrhwj->nrhwi", affine, coord)
        driving_to_source = coord + shift_s[:, :, None, None, :]
        bg_grid = identity[None, None].expand(n, 1, h, w, 2)
        if bg_params is not None:
            homo = torch.cat([bg_grid, torch.ones_like(bg_grid[..., :1])], dim=-1)
            warped = torch.einsum("nij,nrhwj->nrhwi", bg_params, homo)
            bg_grid = warped[..., :2] / warped[..., 2:3]
        return torch.cat([bg_grid, driving_to_source], dim=1)

    def deformed_source(self, source_image, sparse_motions):
        """The source warped by every hypothesis: (N, R+1, h, w, C)."""
        n, h, w, c = source_image.shape
        r1 = sparse_motions.shape[1]
        src = source_image[:, None].expand(n, r1, h, w, c).reshape(n * r1, h, w, c)
        out = grid_sample(src, sparse_motions.reshape(n * r1, h, w, 2))
        return out.reshape(n, r1, h, w, c)

    def forward(self, source_image: torch.Tensor, driving_region_params,
                source_region_params, bg_params: Optional[torch.Tensor] = None, *,
                source_downsampled: bool = False) -> Dict[str, torch.Tensor]:
        """source_image (N, H, W, 3), already anti-alias-downsampled when
        ``source_downsampled``. Returns 'optical_flow' (N, h, w, 2) and
        'occlusion_map' (N, h, w, 1)."""
        if self.scale_factor != 1 and not source_downsampled:
            source_image = anti_alias_downsample(source_image, self.scale_factor)
        n, h, w, _ = source_image.shape
        heatmap = self.heatmap_representations(h, w, driving_region_params,
                                               source_region_params)
        sparse_motion = self.sparse_motions(h, w, driving_region_params,
                                            source_region_params, bg_params)
        # per hypothesis (heatmap, deformed rgb) channel groups, as the
        # reference concatenates them before flattening
        deformed = self.deformed_source(source_image, sparse_motion)
        inp = torch.cat([heatmap[..., None], deformed], dim=-1)        # (n, r+1, h, w, 1+c)
        inp = inp.permute(0, 2, 3, 1, 4).reshape(n, h, w, -1)
        prediction = self.hourglass(inp)
        head = torch.promote_types(prediction.dtype, torch.float32)
        mask = torch.softmax(conv(prediction, self.mask, head), dim=-1)
        return {"optical_flow": torch.einsum("nrhwc,nhwr->nhwc", sparse_motion, mask),
                "occlusion_map": torch.sigmoid(conv(prediction, self.occlusion, head))}
