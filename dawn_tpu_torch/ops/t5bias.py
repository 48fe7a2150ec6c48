"""T5-style relative position bias and the sliding-window mask.

Port of ``dawn_tpu/ops/t5bias.py``: the bucket math of the reference's
RelativePositionBias (num_buckets=32, max_distance=32 in the DM UNet) and its
additive -1e8 window mask. The bias depends on (j - i) only, so windowed
attention needs just the (heads, 2w+1) vector of ``t5_bias_windowed_vector``.
"""

from __future__ import annotations

import numpy as np
import torch


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket indices with torch ``.long()`` truncation."""
    rel = np.asarray(relative_position, dtype=np.int64)
    ret = np.zeros_like(rel)
    n = -rel

    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)

    max_exact = num_buckets // 2
    is_small = n < max_exact
    # float32 log then truncation toward zero, as the reference computes it;
    # n is clamped to >= 1 inside the log (those entries are is_small)
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1).astype(np.float32) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


def t5_bucket_ids(n: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """(n, n) bucket ids for rel = j - i."""
    q = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    return relative_position_bucket(k - q, num_buckets, max_distance)


def t5_bias_matrix(embedding: torch.Tensor, n: int, num_buckets: int = 32,
                   max_distance: int = 128) -> torch.Tensor:
    """Full (heads, n, n) bias from a (num_buckets, heads) embedding table."""
    ids = torch.from_numpy(t5_bucket_ids(n, num_buckets, max_distance))
    return embedding[ids.to(embedding.device)].permute(2, 0, 1)


def window_mask(n: int, window: int) -> torch.Tensor:
    """(n, n) additive f32 mask: 0 where |j - i| <= window, -1e8 outside."""
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    return torch.from_numpy(
        np.where(np.abs(rel) > window, -1e8, 0.0).astype(np.float32))


def t5_bias_windowed_vector(embedding: torch.Tensor, window: int,
                            num_buckets: int = 32,
                            max_distance: int = 128) -> torch.Tensor:
    """(heads, 2*window+1) bias values for rel in [-window, window]."""
    ids = relative_position_bucket(np.arange(-window, window + 1),
                                   num_buckets, max_distance)
    return embedding[torch.from_numpy(ids).to(embedding.device)].t().contiguous()
