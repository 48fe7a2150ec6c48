"""PBnet encoder and decoder of the deployed 'reemb + rope' family.

Port of ``dawn_tpu/models/pbnet/architectures.py:33-166``
(transformerreemb6.py of the reference):

- the encoder embeds the pose change (x - x0), the first pose and the audio
  into a 384-d stream, runs torch's TransformerEncoder (post-norm, GELU) and
  gives per-frame mu / logvar;
- the decoder turns [first-pose embedding, z, audio embedding] into 64-d
  memory, runs zero queries through a rotary + T5-bias attention and the
  decoder5 stack (hard eval window added as a mask) and gives the pose
  change, padded frames zeroed.

Both take ``drop`` (a ``layers.Dropout``, at the JAX modules' places) for
the training forward; the decoder takes ``eval_mask``: the hard window is
an eval-time mask, and the JAX package's training forward leaves it out.
The GRU, FC and ablation architectures are not ported (ROADMAP queue 1
item 15).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from dawn_tpu_torch.models.pbnet.layers import (Dropout, PBnetDecoderLayer,
                                                RotaryBiasAttention,
                                                TorchTransformerEncoderLayer, maybe_drop,
                                                sinusoidal_table)
from dawn_tpu_torch.ops.norms import channel_layer_norm
from dawn_tpu_torch.ops.t5bias import t5_bias_matrix, window_mask


class PBnetRelPosBias(nn.Module):
    """T5 relative position bias; at eval time, with a window, -1e8 outside
    it (transformerreemb6.py:81-129)."""

    def __init__(self, heads: int, num_buckets: int = 128, max_distance: int = 128,
                 eval_window: Optional[int] = 100):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.eval_window = eval_window
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, n: int, use_eval_mask: bool = True) -> torch.Tensor:
        """(heads, n, n) bias."""
        bias = t5_bias_matrix(self.relative_attention_bias.weight, n, self.num_buckets,
                              self.max_distance)
        if use_eval_mask and self.eval_window is not None:
            bias = bias + window_mask(n, self.eval_window).to(bias.device)
        return bias


class TransformerEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, ff_size: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TorchTransformerEncoderLayer(dim, heads, ff_size)
                                    for _ in range(num_layers))


class EncoderTransformerReemb6(nn.Module):
    """Per-frame posterior q(z | pose, audio)."""

    def __init__(self, pos_dim: int = 6, audio_dim: int = 1024, pose_latent_dim: int = 64,
                 audio_latent_dim: int = 256, ff_size: int = 128, num_layers: int = 2,
                 num_heads: int = 4):
        super().__init__()
        self.latent = audio_latent_dim + 2 * pose_latent_dim
        self.firstposeEmbedding = nn.Linear(pos_dim, pose_latent_dim)
        self.poseEmbedding = nn.Linear(pos_dim, pose_latent_dim)
        self.audioEmbedding = nn.Linear(audio_dim, audio_latent_dim)
        self.seqTransEncoder = TransformerEncoder(self.latent, num_heads, ff_size, num_layers)
        self.mu_layer = nn.Linear(self.latent, audio_latent_dim)
        self.sigma_layer = nn.Linear(self.latent, audio_latent_dim)

    def forward(self, x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None,
                drop: Optional[Dropout] = None) -> Dict[str, torch.Tensor]:
        """x: (B, T, pos_dim) absolute pose; y: (B, T, audio_dim); mask (B, T),
        True where valid. Returns mu, logvar (B, T, audio_latent) and x_delta."""
        b, t, _ = x.shape
        x_ref = x[:, :1]
        dx = x - x_ref
        ref_emb = self.firstposeEmbedding(x_ref).expand(b, t, -1)
        h = torch.cat([ref_emb, self.poseEmbedding(dx), self.audioEmbedding(y)], dim=-1)
        h = maybe_drop(drop, h + sinusoidal_table(t, self.latent).to(h.device)[None])
        kpm = None if mask is None else ~mask.bool()
        for layer in self.seqTransEncoder.layers:
            h = layer(h, kpm, drop)
        return {"mu": self.mu_layer(h), "logvar": self.sigma_layer(h), "x_delta": dx}


class PreNorm(nn.Module):
    """Gamma-only channel LayerNorm before ``fn`` (the reference's
    Residual(PreNorm(LayerNorm, Attention)) names: ``fn.norm.gamma``,
    ``fn.fn``)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.Module()
        self.norm.gamma = nn.Parameter(torch.ones(dim))
        self.fn = fn


class Residual(nn.Module):
    def __init__(self, fn: PreNorm):
        super().__init__()
        self.fn = fn

    def forward(self, x, pos_bias):
        return x + self.fn.fn(channel_layer_norm(x, self.fn.norm.gamma), pos_bias)


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, heads: int, ff_size: int, num_layers: int):
        super().__init__()
        self.decoder_layers = nn.ModuleList(PBnetDecoderLayer(dim, heads, ff_size)
                                            for _ in range(num_layers))


class DecoderTransformerReemb6(nn.Module):
    """p(pose change | z, first pose, audio)."""

    def __init__(self, pos_dim: int = 6, audio_dim: int = 1024, pose_latent_dim: int = 64,
                 audio_latent_dim: int = 256, ff_size: int = 128, num_layers: int = 2,
                 num_heads: int = 4, num_buckets: int = 128, max_distance: int = 128,
                 eval_window: Optional[int] = 100):
        super().__init__()
        d = pose_latent_dim
        self.pose_latent_dim = d
        self.firstposeEmbedding = nn.Linear(pos_dim, d)
        self.audioEmbedding = nn.Linear(audio_dim, audio_latent_dim)
        self.ztimelinear = nn.Linear(d + 2 * audio_latent_dim, d)
        self.time_rel_pos_bias_tgt = PBnetRelPosBias(num_heads, num_buckets, max_distance,
                                                     eval_window)
        self.time_rel_pos_bias_mem = PBnetRelPosBias(num_heads, num_buckets, max_distance,
                                                     eval_window)
        self.init_proj = nn.Linear(d, d)
        self.init_temporal_attn = Residual(PreNorm(d, RotaryBiasAttention(d, num_heads)))
        self.seqTransDecoder = TransformerDecoder(d, num_heads, ff_size, num_layers)
        self.finallayer = nn.Linear(d, pos_dim)

    def forward(self, x: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                mask: Optional[torch.Tensor] = None, drop: Optional[Dropout] = None,
                eval_mask: bool = True) -> torch.Tensor:
        """x: (B, T, pos_dim), only frame 0 used; z: (B, T, audio_latent);
        y: (B, T, audio_dim); mask (B, T), True where valid. Returns the pose
        change (B, T, pos_dim)."""
        b, t, _ = y.shape
        ref_emb = self.firstposeEmbedding(x[:, :1].expand(b, t, -1))
        mem = self.ztimelinear(torch.cat([ref_emb, z, self.audioEmbedding(y)], dim=-1))
        bias_tgt = self.time_rel_pos_bias_tgt(t, eval_mask)[None]
        bias_mem = self.time_rel_pos_bias_mem(t, eval_mask)[None]
        q = self.init_proj(mem.new_zeros(b, t, self.pose_latent_dim))    # time queries
        q = self.init_temporal_attn(q, bias_tgt)
        for layer in self.seqTransDecoder.decoder_layers:
            q = layer(q, mem, bias_tgt, bias_mem, drop)
        out = self.finallayer(q)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out
