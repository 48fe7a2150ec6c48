"""PBnet transformer building blocks.

Port of ``dawn_tpu/models/pbnet/layers.py``: the rotary + bias attention of
the reference's ``transformerdecoder5.py`` (self and cross), its post-norm
decoder layer, and torch's ``nn.TransformerEncoderLayer`` (post-norm, GELU)
written out so that it computes exactly what the JAX layer computes (no fast
path). Module names follow the reference state_dict: ``to_qkv``, ``to_out``,
``ffn.linear1``, ``self_attn.in_proj_weight``.

The layers take ``drop``, a :class:`Dropout` or None: the training
forward's dropout at the JAX layers' places (the encoder layer's attention
probabilities, each sublayer's output before its residual add, and the
feed-forward's hidden activation). None (inference) leaves them out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch.ops.attention import attend
from dawn_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin


class Dropout:
    """Dropout at rate ``p`` drawn from an explicit generator, as flax's
    ``nn.Dropout``: an entry is kept where a uniform draw is below 1 - p
    and scaled by 1 / (1 - p), else zeroed. With ``shard`` = (n, rows),
    ``x`` holds the rows ``rows`` of a batch of n (its first axis): the
    draws are made for the whole batch and this shard's rows kept, so
    every rank of a data-parallel step applies the whole batch's masks."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None,
                 shard: Optional[Tuple[int, slice]] = None):
        self.p, self.generator, self.shard = p, generator, shard

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n, rows = self.shard or (x.shape[0], slice(None))
        u = torch.rand((n, *x.shape[1:]), generator=self.generator, device=x.device)[rows]
        return torch.where(u < 1.0 - self.p, x / (1.0 - self.p), torch.zeros_like(x))


def maybe_drop(drop: Optional[Dropout], x: torch.Tensor) -> torch.Tensor:
    return x if drop is None else drop(x)


def _rotate(z: torch.Tensor, heads: int) -> torch.Tensor:
    """Rotary over the sequence axis of (B, H, N, D), on the first
    min(32, heads) channels of each head (a reference quirk: 4 of 32 at 4
    heads)."""
    cos, sin = rotary_cos_sin(z.shape[-2], min(32, heads), dtype=z.dtype, device=z.device)
    return apply_rotary(z, cos, sin)


class RotaryBiasAttention(nn.Module):
    """Self-attention with partial rotary and an additive position bias; q is
    scaled before the rotary."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (z.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for z in self.to_qkv(x).chunk(3, dim=-1))
        q = _rotate(q * self.dim_head ** -0.5, self.heads)
        out = attend(q, _rotate(k, self.heads), v, pos_bias)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class RotaryBiasCrossAttention(nn.Module):
    """The cross-attention variant: separate q, k, v projections, the same
    rotary (each side at its own positions) and bias."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_q = nn.Linear(dim, hidden, bias=False)
        self.to_k = nn.Linear(dim, hidden, bias=False)
        self.to_v = nn.Linear(dim, hidden, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, q_in, k_in, v_in, pos_bias=None) -> torch.Tensor:
        b, n, _ = q_in.shape

        def split(z):
            return z.reshape(b, z.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q = _rotate(split(self.to_q(q_in)) * self.dim_head ** -0.5, self.heads)
        k = _rotate(split(self.to_k(k_in)), self.heads)
        out = attend(q, k, split(self.to_v(v_in)), pos_bias)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, ff_size: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, ff_size)
        self.linear2 = nn.Linear(ff_size, dim)

    def forward(self, x, drop: Optional[Dropout] = None):
        return self.linear2(maybe_drop(drop, F.gelu(self.linear1(x))))


class PBnetDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention, cross-attention to the
    memory, GELU feed-forward."""

    def __init__(self, dim: int, heads: int, ff_size: int):
        super().__init__()
        self.self_attn = RotaryBiasAttention(dim, heads)
        self.layer_norm1 = nn.LayerNorm(dim)
        self.multihead_attn = RotaryBiasCrossAttention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim)
        self.ffn = FeedForward(dim, ff_size)
        self.layer_norm3 = nn.LayerNorm(dim)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                drop: Optional[Dropout] = None):
        tgt = self.layer_norm1(tgt + maybe_drop(drop, self.self_attn(tgt, tgt_mask)))
        ca = self.multihead_attn(tgt, memory, memory, memory_mask)
        tgt = self.layer_norm2(tgt + maybe_drop(drop, ca))
        return self.layer_norm3(tgt + maybe_drop(drop, self.ffn(tgt, drop)))


class PackedSelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s packed parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), self-attention only, scaled after the
    product as torch scales it."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                drop: Optional[Dropout] = None):
        b, n, c = x.shape
        dh = c // self.heads
        q, k, v = (z.reshape(b, n, self.heads, dh).transpose(1, 2)
                   for z in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        bias = None
        if key_padding_mask is not None:
            bias = torch.zeros(key_padding_mask.shape, dtype=q.dtype, device=q.device)
            bias = bias.masked_fill(key_padding_mask, float("-inf"))[:, None, None, :]
        out = attend(q, k, v, bias, scale=dh ** -0.5, drop=drop)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class TorchTransformerEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-norm, GELU) in the (B, N, C)
    layout."""

    def __init__(self, dim: int, heads: int, ff_size: int):
        super().__init__()
        self.self_attn = PackedSelfAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff_size)
        self.linear2 = nn.Linear(ff_size, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x, key_padding_mask=None, drop: Optional[Dropout] = None):
        """key_padding_mask: (B, N), True where masked."""
        x = self.norm1(x + maybe_drop(drop, self.self_attn(x, key_padding_mask, drop)))
        h = self.linear2(maybe_drop(drop, F.gelu(self.linear1(x))))
        return self.norm2(x + maybe_drop(drop, h))


def sinusoidal_table(max_len: int, d_model: int) -> torch.Tensor:
    """The reference's PositionalEncoding table (transformerreemb6.py:61-79)."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)
