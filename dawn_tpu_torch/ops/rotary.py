"""Rotary position embedding with rotary-embedding-torch semantics.

Port of ``dawn_tpu/ops/rotary.py``: interleaved GPT-J pair rotation,
theta=10000, and partial rotation when ``rot_dim < head_dim`` (only the first
``rot_dim`` channels turn; the rest pass through).
"""

from __future__ import annotations

import numpy as np
import torch


def rotary_cos_sin(seq_len: int, rot_dim: int, theta: float = 10000.0,
                   dtype=torch.float32, device=None, offset: int = 0):
    """(cos, sin), each (seq_len, rot_dim) with pairwise-repeated frequencies,
    for the frame positions offset, ..., offset + seq_len - 1 (a rank of a
    seq-sharded video passes its first frame's global position)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, rot_dim, 2)[: rot_dim // 2] / rot_dim))
    positions = np.arange(offset, offset + seq_len, dtype=np.float64)
    freqs = np.repeat(np.outer(positions, inv_freq), 2, axis=-1)
    return (torch.as_tensor(np.cos(freqs), dtype=dtype, device=device),
            torch.as_tensor(np.sin(freqs), dtype=dtype, device=device))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first rot_dim channels of x (..., d); cos/sin broadcast
    against x[..., :rot_dim] (the JAX layout puts seq at axis -2)."""
    rot_dim = cos.shape[-1]
    xr = x[..., :rot_dim]
    rotated = xr * cos + rotate_half(xr) * sin
    if rot_dim == x.shape[-1]:
        return rotated
    return torch.cat([rotated, x[..., rot_dim:]], dim=-1)
