"""The benchmark's own arithmetic: the card's peak rates, the in-band pairs
of windowed attention, and the bytes and operations of one windowed
attention call.

Copied from the program so that a later change to the program cannot move
the yardstick: ``card_peaks`` and ``band_pairs`` from
``dawn_tpu_torch/utils/profiling.py``, the bytes of one call from
``chip_smoke.py``'s K1 bound (each input read once, the output written
once, the bias vector read once). Nothing here imports the program.
"""

from __future__ import annotations

from typing import Tuple

# Dense peak rates from NVIDIA's data sheets: (bytes/s, bf16 FLOP/s, f32 FLOP/s)
PEAKS = {"PCIe": (2.0e12, 756e12, 51e12), "NVL": (3.9e12, 835e12, 60e12),
         "SXM": (3.35e12, 989e12, 67e12)}


def card_peaks(name: str) -> Tuple[str, Tuple[float, float, float]]:
    """(H100 part, (bytes/s, bf16 FLOP/s, f32 FLOP/s)) for a device name as
    ``torch.cuda.get_device_name`` gives it; the SXM part when the name
    names none of them."""
    for key, rates in PEAKS.items():
        if key in name:
            return key, rates
    return "SXM", PEAKS["SXM"]


def band_pairs(t: int, w: int) -> int:
    """In-band (query, key) pairs of one (sequence, head) of windowed
    attention over ``t`` frames at window ``w``."""
    return sum(min(t - 1, i + w) - max(0, i - w) + 1 for i in range(t))


def attention_flops(n: int, t: int, heads: int, dim_head: int, window: int) -> int:
    """Operations of one windowed attention forward: Q K^T and P V over the
    in-band pairs, 4 x head_dim a pair."""
    return 4 * dim_head * band_pairs(t, window) * n * heads


def attention_bytes(n: int, t: int, heads: int, dim_head: int, itemsize: int,
                    bias_elements: int, bias_itemsize: int = 4) -> int:
    """Least bytes of one windowed attention forward: q, k and v read once,
    the output written once, the (heads, 2w+1) bias read once."""
    return 4 * n * t * heads * dim_head * itemsize + bias_elements * bias_itemsize


def roofline_seconds(flops: float, nbytes: float, rates) -> float:
    """The least time the card could take: operations over the bf16 peak or
    bytes over the memory rate, whichever is larger."""
    return max(flops / rates[1], nbytes / rates[0])
