"""DAWN video flow-diffusion UNet3D in PyTorch, channels-last.

Port of ``dawn_tpu/models/dm/unet3d.py``: a factorized space/time UNet over
the (flow, occlusion) latent video with per-frame convs, three-way per-frame
cross-attention to audio/pose/eye tokens, per-frame spatial linear attention,
full spatial attention in the middle, and temporal attention over frames with
rotary embedding plus a T5 relative-position bias inside a +-win_width window.

Videos are (B, T, H, W, C). Parameters stay float32; ``dtype`` is the compute
dtype, applied by explicit casts at each layer as the JAX package does (norm
and softmax statistics stay f32). Module names follow the reference
DAWN-pytorch ``state_dict`` (``downs.{i}.3.fn.fn.fn.to_qkv.weight``,
``ups.{i}.4`` a ConvTranspose3d, per-frame convs as Conv3d with kernel
(1, k, k)), so reference checkpoints map onto it by name.

In 'local' attention mode a temporal attention over T <= 256 frames goes
through K1 (:func:`dawn_tpu_torch.ops.local_attention.local_attention_packed`)
on the packed (B*S, T, H*D) layout: the CUDA kernel on the card, its plain
version on the CPU. With grad on it is the autograd Function
``LocalAttentionPacked``, whose backward is K2, so the training step runs one
K1 and one K2 per temporal attention. Longer videos take the JAX package's
split-heads route to :func:`dawn_tpu_torch.ops.local_attention.local_attention`:
K3 on the card (backward K4), the banded form on the CPU.

Sequence parallelism (``seq_mesh``, or :meth:`Unet3D.sharded_over`): each
rank of the mesh's 'seq' axis holds its own frames of the video. Everything
frame by frame runs as before; the video-wide GroupNorm statistics are
all-reduced over the 'seq' ranks, and every temporal attention, in either
attention mode, takes the JAX package's seq route
(``dawn_tpu/models/dm/unet3d.py:512-530``): the packed layout, rotary at the
global frame positions, then
:func:`dawn_tpu_torch.ops.local_attention.seq_sharded_local_attention`
(halo exchange, K5 forward, K6 backward).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch.ops.convs import conv2d_nhwc, conv_transpose2d_nhwc
from dawn_tpu_torch.ops.local_attention import (PACKED_MAX_T, local_attention,
                                                local_attention_packed,
                                                seq_sharded_local_attention,
                                                windowed_full_attention)
from dawn_tpu_torch.ops.norms import channel_layer_norm, video_group_norm
from dawn_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin
from dawn_tpu_torch.ops.t5bias import (t5_bias_matrix, t5_bias_windowed_vector,
                                       window_mask)


def linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """``layer`` applied in the compute dtype."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def frame_conv(x: torch.Tensor, conv: nn.Conv3d, dtype) -> torch.Tensor:
    """A (1, k, k) Conv3d applied frame by frame to a (B, T, H, W, C) video."""
    b, t, h, w, c = x.shape
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    y = conv2d_nhwc(x.reshape(b * t, h, w, c).to(dtype),
                    conv.weight[:, :, 0].to(dtype), bias,
                    stride=conv.stride[1], padding=conv.padding[1])
    return y.reshape(b, t, *y.shape[1:])


class SeqParallel:
    """The sequence-parallel state one Unet3D shares with its GroupNorms and
    temporal attentions: the mesh whose 'seq' axis shards the frames (None:
    not sharded), and ``force_stripe``.

    ``force_stripe`` is a verification hook, not a user feature: it passes
    the JAX package's ``force_stripe`` to every temporal attention, so that
    a mesh of one rank still runs the halo exchange and the stripe kernels,
    the program of an edge rank (``dawn_tpu/ops/local_attention.py:654-661``).
    Only ``chip_smoke.py`` and the tests set it."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.force_stripe = False

    @property
    def active(self) -> bool:
        """True when the seq route is taken: a 'seq' axis of more than one
        rank, or a forced stripe on any mesh."""
        return self.mesh is not None and (self.mesh.shape["seq"] > 1 or self.force_stripe)

    def group(self):
        """The 'seq' process group of the video-wide reductions, when active."""
        return self.mesh.group("seq") if self.active else None


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + 1e-24)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        emb = math.log(10000) / (half - 1)
        emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
        emb = t.float()[:, None] * emb[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class LayerNorm(nn.Module):
    """Channel LayerNorm, gamma only, stored (1, C, 1, 1, 1) as the reference."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, 1))

    def forward(self, x):
        return channel_layer_norm(x, self.gamma)


class LayerNormImg(nn.Module):
    """Channel LayerNorm of the cross-attention, gamma stored as ``g`` (C,)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return channel_layer_norm(x, self.g)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args):
        return x + self.fn(x, *args)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class ToTokens(nn.Module):
    """Rearranges a (B, T, H, W, C) video into the token layout ``fn`` works
    on and back: 'time' gives (B, H*W, T, C), 'space' gives (B*T, H*W, C)."""

    def __init__(self, fn: nn.Module, axis: str):
        super().__init__()
        self.fn = fn
        self.axis = axis

    def forward(self, x, *args):
        b, t, h, w, c = x.shape
        if self.axis == "time":
            y = self.fn(x.permute(0, 2, 3, 1, 4).reshape(b, h * w, t, c), *args)
            return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
        return self.fn(x.reshape(b * t, h * w, c), *args).reshape(b, t, h, w, c)


class Block(nn.Module):
    """Per-frame conv(1,3,3) + video-wide GroupNorm + time scale/shift + SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int, dtype, seq: SeqParallel):
        super().__init__()
        self.proj = nn.Conv3d(dim, dim_out, (1, 3, 3), padding=(0, 1, 1))
        self.norm = nn.GroupNorm(groups, dim_out)
        self.dtype = dtype
        self.seq = seq

    def forward(self, x, scale_shift=None):
        y = frame_conv(x, self.proj, self.dtype)
        y = video_group_norm(y, self.norm.num_groups, self.norm.weight,
                             self.norm.bias, self.norm.eps, self.seq.group())
        if scale_shift is not None:
            scale, shift = scale_shift
            y = y * (scale.to(y.dtype) + 1.0) + shift.to(y.dtype)
        return F.silu(y)


class CondCrossAttention(nn.Module):
    """Cosine-similarity cross-attention of spatial tokens (N, S, dim) to ONE
    condition token (N, context_dim) per frame, with a learned null key/value:
    the softmax runs over the two keys {null, cond}."""

    def __init__(self, dim: int, context_dim: int, out_dim: int, dtype,
                 dim_head: int = 8, heads: int = 8, scale: float = 8.0):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.scale, self.dtype = heads, dim_head, scale, dtype
        self.norm = LayerNormImg(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim, inner * 2, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Sequential(nn.Linear(inner, out_dim, bias=False),
                                    LayerNormImg(out_dim))

    def forward(self, x, context):
        dt, h, d = self.dtype, self.heads, self.dim_head
        q = linear(self.norm(x), self.to_q, dt)
        k, v = linear(context, self.to_kv, dt).chunk(2, dim=-1)
        n, s, inner = q.shape
        q = q.reshape(n, s, h, d)
        null_k = self.null_kv[0].expand(n, 1, h, d)
        null_v = self.null_kv[1].expand(n, 1, h, d)
        k = torch.cat([null_k, k.float().reshape(n, 1, h, d)], dim=1)   # (N, 2, H, D)
        v = torch.cat([null_v, v.float().reshape(n, 1, h, d)], dim=1)
        q = (l2norm(q.float()) * self.q_scale).to(dt)
        k = (l2norm(k) * self.k_scale).to(dt)
        sim = torch.einsum("nshd,nkhd->nhsk", q, k) * self.scale
        attn = torch.softmax(sim.float(), dim=-1)
        out = torch.einsum("nhsk,nkhd->nshd", attn, v).reshape(n, s, inner)
        return self.to_out[1](linear(out, self.to_out[0], dt))


class ResnetBlockCaMul(nn.Module):
    """ResNet block with 3-way condition cross-attention: cond (B, T,
    aud+pose+eye) splits into three tokens, each through SiLU + Linear, each
    cross-attended by the frame's spatial tokens; the sum adds onto block1."""

    def __init__(self, dim: int, dim_out: int, dtype, seq: SeqParallel, time_emb_dim=None,
                 cond_aud=None, cond_pose=None, cond_eye=None, groups: int = 8):
        super().__init__()
        self.dtype = dtype
        self.cond_split = None
        if time_emb_dim is not None:
            self.time_mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
        if cond_aud is not None:
            self.cond_split = (cond_aud, cond_pose, cond_eye)
            self.audio_mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_aud, dim_out * 2))
            self.pose_mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_pose, dim_out * 2))
            self.eye_mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_eye, dim_out * 2))
            self.cross_attn_aud = CondCrossAttention(dim, dim_out * 2, dim_out, dtype)
            self.cross_attn_pose = CondCrossAttention(dim, dim_out * 2, dim_out, dtype)
            self.cross_attn_eye = CondCrossAttention(dim, dim_out * 2, dim_out, dtype)
        self.block1 = Block(dim, dim_out, groups, dtype, seq)
        self.block2 = Block(dim_out, dim_out, groups, dtype, seq)
        self.res_conv = nn.Conv3d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb=None, cond=None):
        b, t, h, w, c = x.shape
        dt = self.dtype
        scale_shift = None
        if time_emb is not None:
            temb = self.time_mlp(time_emb)[:, None, None, None, :]
            scale_shift = temb.chunk(2, dim=-1)
        h_cond = None
        if self.cond_split is not None:
            tokens = x.reshape(b * t, h * w, c)
            parts = cond.split(self.cond_split, dim=-1)
            branches = ((self.audio_mlp, self.cross_attn_aud),
                        (self.pose_mlp, self.cross_attn_pose),
                        (self.eye_mlp, self.cross_attn_eye))
            h_cond = sum(attn(tokens, linear(F.silu(z), mlp[1], dt).reshape(b * t, -1))
                         for z, (mlp, attn) in zip(parts, branches))
            h_cond = h_cond.reshape(b, t, h, w, -1)
        y = self.block1(x, scale_shift)
        if h_cond is not None:
            y = y + h_cond.to(y.dtype)
        y = self.block2(y)
        res = x if isinstance(self.res_conv, nn.Identity) else frame_conv(x, self.res_conv, dt)
        return y + res.to(y.dtype)


class SpatialLinearAttention(nn.Module):
    """Per-frame linear attention over spatial tokens, split-heads form."""

    def __init__(self, dim: int, dtype, heads: int = 8, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, t, h, w, c = x.shape
        dt, nh, d = self.dtype, self.heads, self.dim_head
        y = x.reshape(b * t, h, w, c).to(dt)
        qkv = conv2d_nhwc(y, self.to_qkv.weight.to(dt))
        q, k, v = (z.reshape(b * t, h * w, nh, d)
                   for z in qkv.reshape(b * t, h * w, -1).chunk(3, dim=-1))
        q = (torch.softmax(q.float(), dim=-1) * d ** -0.5).to(dt)
        k = torch.softmax(k.float(), dim=1).to(dt)
        ctx = torch.einsum("nkhd,nkhe->nhde", k, v)
        out = torch.einsum("nhde,nkhd->nkhe", ctx, q).reshape(b * t, h, w, nh * d)
        out = conv2d_nhwc(out, self.to_out.weight.to(dt), self.to_out.bias.to(dt))
        return out.reshape(b, t, h, w, c)


class SpatialFullAttention(nn.Module):
    """Full attention over the spatial tokens (N, S, C) of each frame."""

    def __init__(self, dim: int, dtype, heads: int = 8, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, x):
        n, s, _ = x.shape
        q, k, v = (z.reshape(n, s, self.heads, self.dim_head).transpose(1, 2)
                   for z in linear(x, self.to_qkv, self.dtype).chunk(3, dim=-1))
        out = windowed_full_attention(q * self.dim_head ** -0.5, k, v, None)
        return linear(out.transpose(1, 2).reshape(n, s, -1), self.to_out, self.dtype)


class TemporalAttention(nn.Module):
    """Attention over the frame axis of (B, S, T, C) tokens with rotary
    embedding and the T5 window bias. 'local' runs K1 on the packed
    (B*S, T, H*D) layout for T <= 256 and :func:`local_attention` (K3) on
    the split-heads (B*S, H, T, D) layout above that, as the JAX module
    does; 'full' runs the windowed-full (T, T) form with the caller's
    (1, 1, H, T, T) bias. When ``seq`` is active, T is this rank's frames
    and :func:`seq_sharded_local_attention` runs in either mode. All compute
    the same function."""

    def __init__(self, dim: int, heads: int, dim_head: int, mode: str, window: int,
                 dtype, seq: Optional[SeqParallel] = None):
        super().__init__()
        if mode not in ("local", "full"):
            raise ValueError(f"attn_mode must be 'local' or 'full', got {mode!r}")
        hidden = heads * dim_head
        self.heads, self.dim_head, self.mode, self.window, self.dtype = (
            heads, dim_head, mode, window, dtype)
        self.seq = seq or SeqParallel()
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, x, pos_bias=None, bias_vec=None):
        b, s, t, _ = x.shape
        nh, d = self.heads, self.dim_head
        qkv = linear(x, self.to_qkv, self.dtype).reshape(b * s, t, 3, nh, d)
        if self.seq.active:
            # packed layout, rotary at the global frame positions
            # (dawn_tpu/models/dm/unet3d.py:512-530)
            mesh = self.seq.mesh
            cos, sin = rotary_cos_sin(t, min(32, d), dtype=qkv.dtype, device=x.device,
                                      offset=mesh.index("seq") * t)
            cos, sin = cos[:, None], sin[:, None]
            q, k, v = (z.reshape(b * s, t, nh * d).contiguous() for z in (
                apply_rotary(qkv[:, :, 0] * d ** -0.5, cos, sin),
                apply_rotary(qkv[:, :, 1], cos, sin), qkv[:, :, 2]))
            out = seq_sharded_local_attention(q, k, v, bias_vec, self.window, nh, mesh,
                                              force_stripe=self.seq.force_stripe)
            return linear(out.reshape(b, s, t, nh * d), self.to_out, self.dtype)
        cos, sin = rotary_cos_sin(t, min(32, d), dtype=qkv.dtype, device=x.device)
        if self.mode == "local" and t > PACKED_MAX_T:
            # split heads, scale q, rotate, attend (dawn_tpu/models/dm/unet3d.py:566-589)
            q, k, v = (z.transpose(1, 2) for z in qkv.unbind(2))     # (B*S, H, T, D)
            q = apply_rotary(q * d ** -0.5, cos, sin).contiguous()
            k = apply_rotary(k, cos, sin).contiguous()
            out = local_attention(q, k, v.contiguous(), bias_vec, self.window)
            out = out.transpose(1, 2)                            # (B*S, T, H, D)
            return linear(out.reshape(b, s, t, nh * d), self.to_out, self.dtype)
        cos, sin = cos[:, None], sin[:, None]                    # (T, 1, rot)
        q = apply_rotary(qkv[:, :, 0] * d ** -0.5, cos, sin)     # (B*S, T, H, D)
        k = apply_rotary(qkv[:, :, 1], cos, sin)
        v = qkv[:, :, 2]
        if self.mode == "local":
            q, k, v = (z.reshape(b * s, t, nh * d).contiguous() for z in (q, k, v))
            out = local_attention_packed(q, k, v, bias_vec, self.window, nh)
        else:
            q, k, v = (z.transpose(1, 2).reshape(b, s, nh, t, d) for z in (q, k, v))
            out = windowed_full_attention(q, k, v, pos_bias)     # (B, S, H, T, D)
            out = out.transpose(2, 3)
        return linear(out.reshape(b, s, t, nh * d), self.to_out, self.dtype)


class RelativePositionBias(nn.Module):
    """Holds the T5 bucket table (num_buckets, heads) under the reference's
    name; the bias itself is built by :mod:`dawn_tpu_torch.ops.t5bias`."""

    def __init__(self, heads: int, num_buckets: int, max_distance: int):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)


class Unet3D(nn.Module):
    """The denoiser. Input (B, T, H, W, channels); returns (B, T, H, W, 3)."""

    def __init__(self, dim: int = 64, channels: int = 3 + 256 + 16,
                 out_grid_dim: int = 2, out_conf_dim: int = 1,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), attn_heads: int = 8,
                 attn_dim_head: int = 32, cond_aud: int = 1024, cond_pose: int = 6,
                 cond_eye: int = 2, win_width: int = 40, bias_num_buckets: int = 32,
                 bias_max_distance: int = 32, resnet_groups: int = 8,
                 init_kernel_size: int = 7, attn_mode: str = "full",
                 dtype=torch.float32, fuse_cond: bool = False, seq_mesh=None):
        super().__init__()
        if fuse_cond:
            raise NotImplementedError("fuse_cond=True is not ported yet")
        self.dim, self.attn_mode, self.win_width, self.dtype = dim, attn_mode, win_width, dtype
        self.attn_heads = attn_heads
        self.seq = seq = SeqParallel(seq_mesh)
        heads, dh = attn_heads, attn_dim_head
        time_dim = dim * 4
        cond_kw = dict(seq=seq, time_emb_dim=time_dim, cond_aud=cond_aud, cond_pose=cond_pose,
                       cond_eye=cond_eye, groups=resnet_groups)

        def temporal(d):
            return Residual(PreNorm(d, ToTokens(
                TemporalAttention(d, heads, dh, attn_mode, win_width, dtype, seq), "time")))

        self.time_rel_pos_bias = RelativePositionBias(heads, bias_num_buckets,
                                                      bias_max_distance)
        self.init_conv = nn.Conv3d(channels, dim, (1, init_kernel_size, init_kernel_size),
                                   padding=(0, init_kernel_size // 2, init_kernel_size // 2))
        self.init_temporal_attn = temporal(dim)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), nn.Linear(dim, time_dim),
                                      nn.GELU(), nn.Linear(time_dim, time_dim))

        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlockCaMul(d_in, d_out, dtype, **cond_kw),
                ResnetBlockCaMul(d_out, d_out, dtype, **cond_kw),
                Residual(PreNorm(d_out, SpatialLinearAttention(d_out, dtype, heads))),
                temporal(d_out),
                nn.Conv3d(d_out, d_out, (1, 4, 4), (1, 2, 2), (0, 1, 1))
                if not is_last else nn.Identity(),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlockCaMul(mid, mid, dtype, **cond_kw)
        self.mid_spatial_attn = Residual(PreNorm(mid, ToTokens(
            SpatialFullAttention(mid, dtype, heads), "space")))  # dim_head 32, as JAX
        self.mid_temporal_attn = temporal(mid)
        self.mid_block2 = ResnetBlockCaMul(mid, mid, dtype, **cond_kw)
        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            is_last = ind >= len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlockCaMul(d_out * 2, d_in, dtype, **cond_kw),
                ResnetBlockCaMul(d_in, d_in, dtype, **cond_kw),
                Residual(PreNorm(d_in, SpatialLinearAttention(d_in, dtype, heads))),
                temporal(d_in),
                nn.ConvTranspose3d(d_in, d_in, (1, 4, 4), (1, 2, 2), (0, 1, 1))
                if not is_last else nn.Identity(),
            ]))
        self.final_conv = nn.Sequential(
            ResnetBlockCaMul(dim * 2, dim, dtype, seq, groups=resnet_groups),
            nn.Conv3d(dim, out_grid_dim, 1))
        self.occlusion_map = nn.Sequential(
            ResnetBlockCaMul(dim * 2, dim, dtype, seq, groups=resnet_groups),
            nn.Conv3d(dim, out_conf_dim, 1))

    @contextlib.contextmanager
    def sharded_over(self, mesh):
        """For the duration, the frame axis of every call is sharded over
        ``mesh``'s 'seq' axis (JAX's ``unet.clone(seq_mesh=mesh)``); None
        leaves the UNet as it is."""
        old = self.seq.mesh
        if mesh is not None:
            self.seq.mesh = mesh
        try:
            yield self
        finally:
            self.seq.mesh = old

    def _init_conv(self, x: torch.Tensor, channels: slice, with_bias: bool):
        """init_conv restricted to some input channels (it is linear in them)."""
        b, t, h, w, c = x.shape
        conv, dt = self.init_conv, self.dtype
        y = conv2d_nhwc(x.reshape(b * t, h, w, c).to(dt),
                        conv.weight[:, channels, 0].to(dt),
                        conv.bias.to(dt) if with_bias else None,
                        padding=conv.padding[1])
        return y.reshape(b, t, h, w, -1)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                cond_drop_mask: Optional[torch.Tensor] = None,
                static_feat: Optional[torch.Tensor] = None,
                precompute_static: bool = False) -> torch.Tensor:
        """
        x: (B, T, H, W, channels) noisy latent + image feature + bbox mask,
          or only the 3 noisy channels when ``static_feat`` is given, or the
          (channels-3) feature/mask channels when ``precompute_static``.
        time: (B,) int timesteps. cond: (B, T, cond_dim). cond_drop_mask:
          optional (B, T) bool, True frames get the zero condition.
        static_feat: (B, T, H, W, dim) precomputed init_conv contribution of
          the step-constant channels, so each DDIM step convolves 3 channels.
        precompute_static: return that contribution and nothing else.
        """
        in_dtype = x.dtype
        if precompute_static:
            return self._init_conv(x, slice(3, None), True).to(in_dtype)
        if cond is not None and cond_drop_mask is not None:
            cond = torch.where(cond_drop_mask[..., None], torch.zeros_like(cond), cond)
        if cond is not None:
            cond = cond.to(self.dtype)

        t = x.shape[1]
        rpb = self.time_rel_pos_bias
        emb = rpb.relative_attention_bias.weight
        pos_bias = bias_vec = None
        if self.attn_mode == "local" or self.seq.active:
            bias_vec = t5_bias_windowed_vector(emb, self.win_width, rpb.num_buckets,
                                               rpb.max_distance)
        else:
            pos_bias = (t5_bias_matrix(emb, t, rpb.num_buckets, rpb.max_distance)
                        + window_mask(t, self.win_width).to(emb.device))[None, None]

        if static_feat is None:
            x = self._init_conv(x, slice(None), True)
        else:
            x = self._init_conv(x, slice(0, 3), False) + static_feat.to(self.dtype)
        r = x
        x = self.init_temporal_attn(x, pos_bias, bias_vec)
        temb = self.time_mlp(time)

        hs = []
        for block1, block2, spatial, temporal, down in self.downs:
            x = block1(x, temb, cond)
            x = block2(x, temb, cond)
            x = spatial(x)
            x = temporal(x, pos_bias, bias_vec)
            hs.append(x)
            if isinstance(down, nn.Conv3d):
                x = frame_conv(x, down, self.dtype)

        x = self.mid_block1(x, temb, cond)
        x = self.mid_spatial_attn(x)
        x = self.mid_temporal_attn(x, pos_bias, bias_vec)
        x = self.mid_block2(x, temb, cond)

        for block1, block2, spatial, temporal, up in self.ups:
            x = torch.cat([x, hs.pop()], dim=-1)
            x = block1(x, temb, cond)
            x = block2(x, temb, cond)
            x = spatial(x)
            x = temporal(x, pos_bias, bias_vec)
            if isinstance(up, nn.ConvTranspose3d):
                b, tt, h, w, c = x.shape
                y = conv_transpose2d_nhwc(x.reshape(b * tt, h, w, c).to(self.dtype),
                                          up.weight[:, :, 0].to(self.dtype),
                                          up.bias.to(self.dtype), stride=2, padding=1)
                x = y.reshape(b, tt, *y.shape[1:])

        x = torch.cat([x, r], dim=-1)
        flow = frame_conv(self.final_conv[0](x), self.final_conv[1], torch.float32)
        occ = frame_conv(self.occlusion_map[0](x), self.occlusion_map[1], torch.float32)
        return torch.cat([flow, occ], dim=-1).to(in_dtype)
