"""HuBERT speech encoder: the audio-conditioning backbone (pipeline stage 2).

Port of ``dawn_tpu/models/hubert/model.py``: a 7-layer conv feature
extractor (stride 320, receptive field 400), the feature projection, the
grouped-conv position embedding and a pre-LN ("stable layer norm")
transformer stack; ``HubertConfig.large()`` is hubert-large. Module names
follow the HF ``HubertModel`` state_dict (``feature_extractor.conv_layers.{i}
.conv``, ``encoder.layers.{i}.attention.q_proj``, ...), so the released
weights load with :func:`dawn_tpu_torch.weights.checkpoints.load_hubert_dir`.
The position conv holds the effective kernel; the loader folds HF's weight
norm into it. Attention is a plain matmul and softmax, as JAX computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.ops.attention import attend


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"      # 'layer' (large) | 'group' (base)
    do_stable_layer_norm: bool = True     # pre-LN stack (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def large(cls) -> "HubertConfig":
        return cls()

    @property
    def total_stride(self) -> int:
        s = 1
        for st in self.conv_stride:
            s *= st
        return s


class ConvLayer(nn.Module):
    """VALID conv1d, the layer's norm (LayerNorm over channels, or for
    'group' a per-channel GroupNorm after conv 0 only) and exact GELU."""

    def __init__(self, cfg: HubertConfig, i: int):
        super().__init__()
        fin = cfg.conv_dim[i - 1] if i > 0 else 1
        dim = cfg.conv_dim[i]
        self.conv = nn.Conv1d(fin, dim, cfg.conv_kernel[i], stride=cfg.conv_stride[i],
                              bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        elif i == 0:
            self.layer_norm = nn.GroupNorm(dim, dim, eps=cfg.layer_norm_eps)
        else:
            self.layer_norm = None
        self.channels_last_norm = cfg.feat_extract_norm == "layer"

    def forward(self, x: torch.Tensor) -> torch.Tensor:       # (B, C, S)
        x = self.conv(x)
        if self.channels_last_norm:
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    """Raw waveform (B, S) -> frame features (B, T, conv_dim[-1])."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PosConvEmbedding(nn.Module):
    """Grouped conv over frames (kernel 128, groups 16), padded k // 2; for an
    even kernel the last step is dropped, as HF does."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:       # (B, T, C)
        y = self.conv(x.transpose(1, 2))
        if self.drop_last:
            y = y[..., :-1]
        return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(c, c)
                                                                for _ in range(4))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, c = h.shape
        dh = c // self.heads

        def split(z):
            return z.reshape(b, t, self.heads, dh).transpose(1, 2)

        q = split(self.q_proj(h) * dh ** -0.5)                # q scaled before q k^T
        k, v = split(self.k_proj(h)), split(self.v_proj(h))
        return self.out_proj(attend(q, k, v).transpose(1, 2).reshape(b, t, c))


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, h):
        return self.output_dense(F.gelu(self.intermediate_dense(h)))


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer (the stable-layer-norm variant)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = Attention(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)

    def forward(self, x):
        x = x + self.attention(self.layer_norm(x))
        return x + self.feed_forward(self.final_layer_norm(x))


class Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.pos_conv_embed = PosConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x):
        x = x + self.pos_conv_embed(x)
        if not self.stable:
            x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x) if self.stable else x


class HubertModel(nn.Module):
    """wav (B, S) float32 (zero-mean/unit-var normalized) -> (B, T, hidden).

    Parameters are torch's default init until weights are loaded; the model
    lives on the card unless the caller passes ``device="cpu"``."""

    def __init__(self, config: HubertConfig = HubertConfig.large(), device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.feature_extractor = FeatureExtractor(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config)
        self.to(self.device)
        self.eval()

    @torch.no_grad()
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feature_extractor(wav.to(self.device, torch.float32))
        return self.encoder(self.feature_projection(x))
