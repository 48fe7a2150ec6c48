"""Exact linearly interpolated quantile along the last axis.

Port of ``dawn_tpu/ops/quantile.py::quantile_nonneg``: pos = q*(n-1), result =
v[floor(pos)]*(1-frac) + v[floor(pos)+1]*frac over the sorted row. The two
order statistics come from ``torch.kthvalue``; ``torch.quantile`` is avoided
because it refuses inputs above 2^24 elements (a batch of 7 videos at 256^2
and 200 frames holds 17.2M). A NaN anywhere in a row makes that row NaN.
"""

from __future__ import annotations

import torch


def quantile_nonneg(x: torch.Tensor, q: float) -> torch.Tensor:
    """q-quantile of each row of the (B, N) float tensor x; returns (B,) f32."""
    if x.ndim != 2:
        raise ValueError(f"expected (B, N), got {tuple(x.shape)}")
    n = x.shape[-1]
    xf = x.float()
    pos = q * (n - 1)
    k_lo = int(pos)
    frac = pos - k_lo
    lo = torch.kthvalue(xf, k_lo + 1, dim=-1).values
    if frac == 0.0 or k_lo + 1 > n - 1:
        out = lo
    else:
        hi = torch.kthvalue(xf, k_lo + 2, dim=-1).values
        out = lo * (1.0 - frac) + hi * frac
    return torch.where(torch.isnan(xf).any(dim=-1),
                       torch.full_like(out, float("nan")), out)
