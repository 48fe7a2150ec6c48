"""Plain softmax attention over (B, H, N, D) heads, as the JAX package
computes it outside any Pallas kernel (HuBERT's encoder, PBnet's layers)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor] = None, scale: Optional[float] = None,
           drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v. ``scale`` multiplies the product, for
    a model that scales after it; a model that scales q before the product
    passes q scaled and no ``scale``. ``drop``, when given, is applied to the
    probabilities (torch MultiheadAttention's dropout)."""
    sim = q @ k.transpose(-1, -2)
    if scale is not None:
        sim = sim * scale
    if bias is not None:
        sim = sim + bias
    probs = torch.softmax(sim, dim=-1)
    return (probs if drop is None else drop(probs)) @ v
