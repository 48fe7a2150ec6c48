"""Flow warping and region geometry of the LFG nets, channels-last.

Port of ``dawn_tpu/models/lfg/warp.py``: flows are normalized [-1, 1] xy
grids; a flow whose size differs from the warped tensor's is first resized
bilinearly (align_corners=False), and so is the occlusion map. Also the
anti-aliased downsample of the predictors' inputs and the region-to-gaussian
heatmap of the flow predictor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dawn_tpu_torch.ops.convs import _nchw, _nhwc
from dawn_tpu_torch.ops.resample import (grid_sample, grid_sample_shared,
                                         interpolate_bilinear)


def deform_input_shared(inp: torch.Tensor, optical_flow: torch.Tensor) -> torch.Tensor:
    """Warp ONE source (B, H, W, C) by T flows (B, T, h, w, 2) -> (B, T, H, W, C)."""
    b, t, h_old, w_old, _ = optical_flow.shape
    _, h, w, _ = inp.shape
    if (h_old, w_old) != (h, w):
        optical_flow = interpolate_bilinear(
            optical_flow.reshape(b * t, h_old, w_old, 2), h, w).reshape(b, t, h, w, 2)
    return grid_sample_shared(inp, optical_flow)


def apply_optical_shared(input_skip: torch.Tensor, optical_flow: torch.Tensor,
                         occlusion_map: Optional[torch.Tensor] = None,
                         input_previous: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp a shared (B, H, W, C) skip by (B, T, ...) flows and blend with
    the decoder stream: warp * occ + previous * (1 - occ). ``input_previous``
    and the result are flattened (B*T, H, W, C)."""
    b, t = optical_flow.shape[:2]
    out = deform_input_shared(input_skip, optical_flow)
    out = out.reshape((b * t,) + out.shape[2:])
    if occlusion_map is not None:
        occ = occlusion_map.reshape((b * t,) + occlusion_map.shape[2:])
        if occ.shape[1:3] != out.shape[1:3]:
            occ = interpolate_bilinear(occ, out.shape[1], out.shape[2])
        occ = occ.to(out.dtype)
        if input_previous is not None:
            out = out * occ + input_previous.to(out.dtype) * (1 - occ)
        else:
            out = out * occ
    return out


def deform_input(inp: torch.Tensor, optical_flow: torch.Tensor) -> torch.Tensor:
    """Warp ``inp`` (N, H, W, C) by a flow grid (N, h, w, 2)."""
    _, h_old, w_old, _ = optical_flow.shape
    _, h, w, _ = inp.shape
    if (h_old, w_old) != (h, w):
        optical_flow = interpolate_bilinear(optical_flow, h, w)
    return grid_sample(inp, optical_flow)


def make_coordinate_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) in [-1, 1], x = 2 * i / (size - 1) - 1."""
    x = 2 * (np.arange(w) / (w - 1)) - 1
    y = 2 * (np.arange(h) / (h - 1)) - 1
    grid = np.stack([np.broadcast_to(x[None, :], (h, w)),
                     np.broadcast_to(y[:, None], (h, w))], axis=-1)
    return torch.as_tensor(grid, dtype=dtype, device=device)


def anti_alias_downsample(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Gaussian blur, then keep every (1/scale)-th pixel (the reference's
    AntiAliasInterpolation2d); x (N, H, W, C)."""
    if scale == 1.0:
        return x
    sigma = (1 / scale - 1) / 2
    ks = 2 * round(sigma * 4) + 1
    ka = ks // 2
    kb = ka - 1 if ks % 2 == 0 else ka
    grid = np.arange(ks, dtype=np.float64)
    g1 = np.exp(-((grid - (ks - 1) / 2) ** 2) / (2 * sigma ** 2))
    kernel = np.outer(g1, g1)
    kernel = torch.as_tensor((kernel / kernel.sum()).astype(np.float32), dtype=x.dtype,
                             device=x.device)
    c = x.shape[-1]
    out = F.conv2d(F.pad(_nchw(x), (ka, kb, ka, kb)), kernel.expand(c, 1, ks, ks),
                   groups=c)
    step = int(1 / scale)
    return _nhwc(out)[:, ::step, ::step, :]


def region2gaussian(center: torch.Tensor, covar: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Gaussian heatmaps exp(-d^T covar^-1 d / 2) of region centres (..., 2)
    with covariances (..., 2, 2) on the (h, w) grid -> (..., h, w)."""
    grid = make_coordinate_grid(h, w, center.dtype, center.device)
    d = grid - center[..., None, None, :]                          # (..., h, w, 2)
    covar_inv = torch.linalg.inv(covar)[..., None, None, :, :]     # (..., 1, 1, 2, 2)
    under = torch.einsum("...i,...ij,...j->...", d, covar_inv, d)
    return torch.exp(-0.5 * under)
