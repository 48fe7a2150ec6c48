"""Plain float32 reference of DAWN's stage 4: one portrait and its driving
signals in, a talking-head video out.

A frozen copy of the mathematics of the sampler that the benchmark times
(the face-location encoder, the condition, the LFG source feature, the
Unet3D denoiser with its temporal attention, 20-step eta-DDIM with dynamic
thresholding, the LFG flow-warping decode), written in plain PyTorch under
the module and parameter names of the released DAWN checkpoints, so that
one state dict loads into it and into the program alike. It imports
nothing of the program. Departures from the program, each computing the
same function: the temporal attention is the whole (T, T) softmax with the
window folded into its bias, in blocks of sequences; the quantile of the
dynamic thresholding comes from a sort.

Every product runs in float32 with TF32 off. ``Operands`` rounds the
operands of every matrix product and convolution first: identity for the
reference, and a lower precision for the control (``fp8``: float8 e4m3
with one scale a tensor; ``bf16``). Tensors are channels-last: videos
(B, T, H, W, C), images (B, H, W, C).

This module also makes what a run hands to both sides: the weights
(:func:`seeded_state_dict`) and the inputs of a call (:func:`make_inputs`),
each from a seed, on the given device.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.arith import attention_flops

NEG_INF = -1e9
CONTROL_PRECISION = ("fp8", "bf16")   # the control's operands: the UNet's, the decoder's
ATTN_BLOCK = 512          # sequences per block of the temporal attention
DECODE_BLOCK = 50         # frames per block of the decode
PORTRAIT_CELL = 8         # pixels between the random values of a portrait


class Operands:
    """How the operands of every product are rounded before an f32 product:
    ``f32`` (not at all), ``bf16``, or ``fp8`` (e4m3, one scale a tensor,
    its largest magnitude at 448)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown operand precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        if self.kind == "bf16":
            return x.to(torch.bfloat16).float()
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


# ------------------------------------------------------------------ products

def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matrix products and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def lin(x, weight, bias, ops: Operands):
    return F.linear(ops(x), ops(weight), bias)


def conv2d(x, weight, bias, ops: Operands, stride: int = 1, padding: int = 0):
    """Convolution of an NHWC tensor with a torch (O, I, kh, kw) weight."""
    y = F.conv2d(ops(x).permute(0, 3, 1, 2), ops(weight), bias, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def frame_conv(x, conv: nn.Module, ops: Operands):
    """A (1, k, k) Conv3d applied frame by frame to a (B, T, H, W, C) video."""
    b, t, h, w, c = x.shape
    y = conv2d(x.reshape(b * t, h, w, c), conv.weight[:, :, 0], conv.bias, ops,
               stride=conv.stride[1], padding=conv.padding[1])
    return y.reshape(b, t, *y.shape[1:])


def layer_norm(x, gamma, eps: float = 1e-5):
    """Channel LayerNorm over the last axis, gamma only, biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(-1)


def l2norm(x):
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + 1e-24)


# ------------------------------------------------ positions and the T5 bias

def rotary_cos_sin(seq_len: int, rot_dim: int, device, theta: float = 10000.0):
    """(cos, sin), each (seq_len, rot_dim), pairwise-repeated frequencies."""
    inv_freq = 1.0 / (theta ** (np.arange(0, rot_dim, 2)[: rot_dim // 2] / rot_dim))
    freqs = np.repeat(np.outer(np.arange(seq_len, dtype=np.float64), inv_freq), 2, axis=-1)
    return (torch.as_tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(freqs), dtype=torch.float32, device=device))


def apply_rotary(x, cos, sin):
    """Interleaved (GPT-J) rotation of the first rot_dim channels of x."""
    rot = cos.shape[-1]
    xr = x[..., :rot]
    pairs = xr.unflatten(-1, (-1, 2))
    half = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return torch.cat([xr * cos + half * sin, x[..., rot:]], dim=-1)


def relative_position_bucket(rel: np.ndarray, num_buckets: int, max_distance: int):
    """Bidirectional T5 buckets; the f32 log truncated toward zero."""
    n = -np.asarray(rel, dtype=np.int64)
    num_buckets //= 2
    ret = (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    large = max_exact + (np.log(np.maximum(n, 1).astype(np.float32) / max_exact)
                         / np.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).astype(np.int64)
    return ret + np.where(n < max_exact, n, np.minimum(large, num_buckets - 1))


# ------------------------------------------------------------------ the UNet

class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, 1))

    def forward(self, x):
        return layer_norm(x, self.gamma)


class LayerNormImg(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return layer_norm(x, self.g)


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
    """(B, T, H, W, C) to (B, H*W, T, C) for 'time', (B*T, H*W, C) for 'space'."""

    def __init__(self, fn: nn.Module, axis: str):
        super().__init__()
        self.fn, self.axis = fn, axis

    def forward(self, x, *args):
        b, t, h, w, c = x.shape
        if self.axis == "time":
            y = self.fn(x.permute(0, 2, 3, 1, 4).reshape(b, h * w, t, c), *args)
            return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
        return self.fn(x.reshape(b * t, h * w, c), *args).reshape(b, t, h, w, c)


class Block(nn.Module):
    """Per-frame conv(1,3,3), GroupNorm over the whole video, scale/shift, SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int, ops: Operands):
        super().__init__()
        self.proj = nn.Conv3d(dim, dim_out, (1, 3, 3), padding=(0, 1, 1))
        self.norm = nn.GroupNorm(groups, dim_out)
        self.ops = ops

    def forward(self, x, scale_shift=None):
        y = frame_conv(x, self.proj, self.ops)
        b, t, h, w, c = y.shape
        g = self.norm.num_groups
        yg = y.reshape(b, t * h * w, g, c // g)
        mean = yg.mean(dim=(1, 3), keepdim=True)
        var = (yg - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((yg - mean) * torch.rsqrt(var + self.norm.eps)).reshape(b, t, h, w, c)
        y = y * self.norm.weight + self.norm.bias
        if scale_shift is not None:
            scale, shift = scale_shift
            y = y * (scale + 1.0) + shift
        return F.silu(y)


class CondCrossAttention(nn.Module):
    """Cosine-similarity attention of a frame's spatial tokens to one
    condition token and a learned null token."""

    def __init__(self, dim: int, context_dim: int, out_dim: int, ops: Operands,
                 dim_head: int = 8, heads: int = 8, scale: float = 8.0):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.scale, self.ops = heads, dim_head, scale, ops
        self.norm = LayerNormImg(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim, inner * 2, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Sequential(nn.Linear(inner, out_dim, bias=False), LayerNormImg(out_dim))

    def forward(self, x, context):
        ops, h, d = self.ops, self.heads, self.dim_head
        n, s, _ = x.shape
        q = lin(self.norm(x), self.to_q.weight, None, ops).reshape(n, s, h, d)
        k, v = (z.reshape(n, 1, h, d)
                for z in lin(context, self.to_kv.weight, None, ops).chunk(2, dim=-1))
        k = torch.cat([self.null_kv[0].expand(n, 1, h, d), k], dim=1)
        v = torch.cat([self.null_kv[1].expand(n, 1, h, d), v], dim=1)
        q = l2norm(q) * self.q_scale
        k = l2norm(k) * self.k_scale
        sim = torch.einsum("nshd,nkhd->nhsk", ops(q), ops(k)) * self.scale
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("nhsk,nkhd->nshd", ops(attn), ops(v)).reshape(n, s, h * d)
        return self.to_out[1](lin(out, self.to_out[0].weight, None, ops))


class ResnetBlockCaMul(nn.Module):
    """Two Blocks; the time embedding scales and shifts the first, and the
    sum of three condition cross-attentions (audio, pose, eye) is added
    onto it."""

    def __init__(self, dim: int, dim_out: int, ops: Operands, time_emb_dim=None,
                 cond_aud=None, cond_pose=None, cond_eye=None, groups: int = 8):
        super().__init__()
        self.ops = ops
        self.cond_split = None
        self.has_time = time_emb_dim is not None
        if time_emb_dim is not None:
            self.time_mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
        if cond_aud is not None:
            self.cond_split = (cond_aud, cond_pose, cond_eye)
            self.audio_mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_aud, dim_out * 2))
            self.pose_mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_pose, dim_out * 2))
            self.eye_mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_eye, dim_out * 2))
            self.cross_attn_aud = CondCrossAttention(dim, dim_out * 2, dim_out, ops)
            self.cross_attn_pose = CondCrossAttention(dim, dim_out * 2, dim_out, ops)
            self.cross_attn_eye = CondCrossAttention(dim, dim_out * 2, dim_out, ops)
        self.block1 = Block(dim, dim_out, groups, ops)
        self.block2 = Block(dim_out, dim_out, groups, ops)
        self.res_conv = nn.Conv3d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb=None, cond=None):
        b, t, h, w, c = x.shape
        ops = self.ops
        scale_shift = None
        if self.has_time and time_emb is not None:
            temb = lin(F.silu(time_emb), self.time_mlp[1].weight, self.time_mlp[1].bias, ops)
            scale_shift = temb[:, None, None, None, :].chunk(2, dim=-1)
        y = self.block1(x, scale_shift)
        if self.cond_split is not None:
            tokens = x.reshape(b * t, h * w, c)
            branches = ((self.audio_mlp, self.cross_attn_aud),
                        (self.pose_mlp, self.cross_attn_pose),
                        (self.eye_mlp, self.cross_attn_eye))
            h_cond = sum(attn(tokens, lin(F.silu(z), mlp[1].weight, mlp[1].bias, ops)
                              .reshape(b * t, -1))
                         for z, (mlp, attn) in zip(cond.split(self.cond_split, dim=-1),
                                                   branches))
            y = y + h_cond.reshape(b, t, h, w, -1)
        y = self.block2(y)
        res = x if isinstance(self.res_conv, nn.Identity) else frame_conv(x, self.res_conv, ops)
        return y + res


class SpatialLinearAttention(nn.Module):
    def __init__(self, dim: int, ops: Operands, heads: int = 8, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head, self.ops = heads, dim_head, ops
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, t, h, w, c = x.shape
        ops, nh, d = self.ops, self.heads, self.dim_head
        qkv = conv2d(x.reshape(b * t, h, w, c), self.to_qkv.weight, None, ops)
        q, k, v = (z.reshape(b * t, h * w, nh, d)
                   for z in qkv.reshape(b * t, h * w, -1).chunk(3, dim=-1))
        q = torch.softmax(q, dim=-1) * d ** -0.5
        k = torch.softmax(k, dim=1)
        ctx = torch.einsum("nkhd,nkhe->nhde", ops(k), ops(v))
        out = torch.einsum("nhde,nkhd->nkhe", ops(ctx), ops(q)).reshape(b * t, h, w, nh * d)
        out = conv2d(out, self.to_out.weight, self.to_out.bias, ops)
        return out.reshape(b, t, h, w, c)


class SpatialFullAttention(nn.Module):
    def __init__(self, dim: int, ops: Operands, heads: int = 8, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head, self.ops = heads, dim_head, ops
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, x):
        n, s, _ = x.shape
        ops = self.ops
        q, k, v = (z.reshape(n, s, self.heads, self.dim_head).transpose(1, 2)
                   for z in lin(x, self.to_qkv.weight, None, ops).chunk(3, dim=-1))
        sim = ops(q * self.dim_head ** -0.5) @ ops(k).transpose(-1, -2)
        out = ops(torch.softmax(sim, dim=-1)) @ ops(v)
        return lin(out.transpose(1, 2).reshape(n, s, -1), self.to_out.weight, None, ops)


def windowed_attention(q, k, v, bias_vec, window: int, ops: Operands):
    """softmax(q k^T + b[j - i]) v over keys with |j - i| <= window, for
    (N, T, H, D) q (scaled and rotated), k and v; (H, 2w+1) bias. The whole
    (T, T) scores in blocks of ATTN_BLOCK sequences."""
    n, t, h, d = q.shape
    rel = torch.arange(t, device=q.device)[None, :] - torch.arange(t, device=q.device)[:, None]
    bias = bias_vec[:, rel.clamp(-window, window) + window]
    bias = bias.masked_fill(rel.abs() > window, NEG_INF)                   # (H, T, T)
    out = torch.empty_like(q)
    for i in range(0, n, ATTN_BLOCK):
        qi, ki, vi = (z[i:i + ATTN_BLOCK].transpose(1, 2) for z in (q, k, v))
        p = torch.softmax(ops(qi) @ ops(ki).transpose(-1, -2) + bias, dim=-1)
        out[i:i + ATTN_BLOCK] = (ops(p) @ ops(vi)).transpose(1, 2)
    return out


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, window: int, ops: Operands):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head, self.window, self.ops = heads, dim_head, window, ops
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, x, bias_vec):
        b, s, t, _ = x.shape
        nh, d = self.heads, self.dim_head
        qkv = lin(x, self.to_qkv.weight, None, self.ops).reshape(b * s, t, 3, nh, d)
        cos, sin = rotary_cos_sin(t, min(32, d), x.device)
        cos, sin = cos[:, None], sin[:, None]
        q = apply_rotary(qkv[:, :, 0] * d ** -0.5, cos, sin)
        k = apply_rotary(qkv[:, :, 1], cos, sin)
        out = windowed_attention(q, k, qkv[:, :, 2], bias_vec, self.window, self.ops)
        return lin(out.reshape(b, s, t, nh * d), self.to_out.weight, None, self.ops)


class RelativePositionBias(nn.Module):
    def __init__(self, heads: int, num_buckets: int, max_distance: int):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def windowed(self, window: int):
        """(heads, 2w+1) bias for offsets -w..w."""
        ids = relative_position_bucket(np.arange(-window, window + 1), self.num_buckets,
                                       self.max_distance)
        emb = self.relative_attention_bias.weight
        return emb[torch.from_numpy(ids).to(emb.device)].t()


class Unet3D(nn.Module):
    """The denoiser: (B, T, H, W, 3) noisy latent, the step-constant part of
    the init conv, timesteps and condition in; (B, T, H, W, 3) noise out."""

    def __init__(self, ops: Operands, dim: int = 64, channels: int = 275,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), attn_heads: int = 8,
                 attn_dim_head: int = 32, cond_aud: int = 1024, cond_pose: int = 6,
                 cond_eye: int = 2, win_width: int = 40, bias_num_buckets: int = 32,
                 bias_max_distance: int = 32, resnet_groups: int = 8,
                 init_kernel_size: int = 7, out_grid_dim: int = 2, out_conf_dim: int = 1):
        super().__init__()
        self.ops, self.win_width = ops, win_width
        heads, dh, time_dim = attn_heads, attn_dim_head, dim * 4
        kw = dict(time_emb_dim=time_dim, cond_aud=cond_aud, cond_pose=cond_pose,
                  cond_eye=cond_eye, groups=resnet_groups)

        def temporal(d):
            return Residual(PreNorm(d, ToTokens(
                TemporalAttention(d, heads, dh, win_width, ops), "time")))

        self.time_rel_pos_bias = RelativePositionBias(heads, bias_num_buckets,
                                                      bias_max_distance)
        self.init_conv = nn.Conv3d(channels, dim, (1, init_kernel_size, init_kernel_size),
                                   padding=(0, init_kernel_size // 2, init_kernel_size // 2))
        self.init_temporal_attn = temporal(dim)
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(dim, time_dim), nn.GELU(),
                                      nn.Linear(time_dim, time_dim))
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs, self.ups = nn.ModuleList(), nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlockCaMul(d_in, d_out, ops, **kw),
                ResnetBlockCaMul(d_out, d_out, ops, **kw),
                Residual(PreNorm(d_out, SpatialLinearAttention(d_out, ops, heads))),
                temporal(d_out),
                nn.Identity() if last else nn.Conv3d(d_out, d_out, (1, 4, 4), (1, 2, 2),
                                                     (0, 1, 1))]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlockCaMul(mid, mid, ops, **kw)
        self.mid_spatial_attn = Residual(PreNorm(mid, ToTokens(
            SpatialFullAttention(mid, ops, heads), "space")))
        self.mid_temporal_attn = temporal(mid)
        self.mid_block2 = ResnetBlockCaMul(mid, mid, ops, **kw)
        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            last = ind >= len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlockCaMul(d_out * 2, d_in, ops, **kw),
                ResnetBlockCaMul(d_in, d_in, ops, **kw),
                Residual(PreNorm(d_in, SpatialLinearAttention(d_in, ops, heads))),
                temporal(d_in),
                nn.Identity() if last else nn.ConvTranspose3d(d_in, d_in, (1, 4, 4),
                                                              (1, 2, 2), (0, 1, 1))]))
        self.final_conv = nn.Sequential(
            ResnetBlockCaMul(dim * 2, dim, ops, groups=resnet_groups),
            nn.Conv3d(dim, out_grid_dim, 1))
        self.occlusion_map = nn.Sequential(
            ResnetBlockCaMul(dim * 2, dim, ops, groups=resnet_groups),
            nn.Conv3d(dim, out_conf_dim, 1))
        self.dim = dim

    def static_part(self, feat):
        """The init conv's contribution of the step-constant channels (the
        source feature and the mask embedding, (B, 1, H, W, C-3)), bias
        included."""
        b, t, h, w, c = feat.shape
        conv = self.init_conv
        y = conv2d(feat.reshape(b * t, h, w, c), conv.weight[:, 3:, 0], conv.bias, self.ops,
                   padding=conv.padding[1])
        return y.reshape(b, t, *y.shape[1:])

    def time_embedding(self, time):
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=time.device)
                         * -(math.log(10000) / (half - 1)))
        emb = time.float()[:, None] * freq[None, :]
        emb = torch.cat([emb.sin(), emb.cos()], dim=-1)
        ops = self.ops
        emb = F.gelu(lin(emb, self.time_mlp[1].weight, self.time_mlp[1].bias, ops))
        return lin(emb, self.time_mlp[3].weight, self.time_mlp[3].bias, ops)

    def forward(self, x, time, cond, static):
        b, t, h, w, _ = x.shape
        ops = self.ops
        bias_vec = self.time_rel_pos_bias.windowed(self.win_width)
        conv = self.init_conv
        x = conv2d(x.reshape(b * t, h, w, 3), conv.weight[:, :3, 0], None, ops,
                   padding=conv.padding[1]).reshape(b, t, h, w, -1) + static
        r = x
        x = self.init_temporal_attn(x, bias_vec)
        temb = self.time_embedding(time)
        hs = []
        for block1, block2, spatial, temporal, down in self.downs:
            x = block1(x, temb, cond)
            x = block2(x, temb, cond)
            x = spatial(x)
            x = temporal(x, bias_vec)
            hs.append(x)
            if isinstance(down, nn.Conv3d):
                x = frame_conv(x, down, ops)
        x = self.mid_block1(x, temb, cond)
        x = self.mid_spatial_attn(x)
        x = self.mid_temporal_attn(x, bias_vec)
        x = self.mid_block2(x, temb, cond)
        for block1, block2, spatial, temporal, up in self.ups:
            x = torch.cat([x, hs.pop()], dim=-1)
            x = block1(x, temb, cond)
            x = block2(x, temb, cond)
            x = spatial(x)
            x = temporal(x, bias_vec)
            if isinstance(up, nn.ConvTranspose3d):
                bb, tt, hh, ww, cc = x.shape
                y = F.conv_transpose2d(ops(x.reshape(bb * tt, hh, ww, cc)).permute(0, 3, 1, 2),
                                       ops(up.weight[:, :, 0]), up.bias, stride=2, padding=1)
                x = y.permute(0, 2, 3, 1).reshape(bb, tt, *y.shape[2:], y.shape[1])
        x = torch.cat([x, r], dim=-1)
        flow = frame_conv(self.final_conv[0](x), self.final_conv[1], ops)
        occ = frame_conv(self.occlusion_map[0](x), self.occlusion_map[1], ops)
        return torch.cat([flow, occ], dim=-1)


# ------------------------------------------------------------- the sampler

def diffusion_buffers(timesteps: int) -> Dict[str, torch.Tensor]:
    """Cosine schedule in float64, the buffers cast to float32."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    acp = np.cos(((x / timesteps) + 0.008) / 1.008 * np.pi * 0.5) ** 2
    acp = acp / acp[0]
    betas = np.clip(1 - acp[1:] / acp[:-1], 0, 0.9999)
    alphas_cumprod = np.cumprod(1.0 - betas)
    buf = {"alphas_cumprod_prev": np.concatenate([[1.0], alphas_cumprod[:-1]]),
           "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod),
           "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod - 1)}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in buf.items()}


def ddim_times(timesteps: int, steps: int):
    """(time, time_next) pairs: an f32 linspace truncated to int, reversed."""
    times = torch.linspace(0.0, float(timesteps), steps=steps + 2)[:-1]
    times = list(reversed([int(v) for v in times.tolist()]))
    return list(zip(times[:-1], times[1:]))


def quantile_rows(x, q: float):
    """The linearly interpolated q-quantile of each row of (B, N), by sort."""
    n = x.shape[-1]
    srt = torch.sort(x, dim=-1).values
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    frac = pos - lo
    hi = min(lo + 1, n - 1)
    return srt[:, lo] * (1.0 - frac) + srt[:, hi] * frac


def threshold(x0, percentile: float = 0.9):
    """Dynamic thresholding: clip to the per-sample quantile of |x0|
    (floored at 1), then divide by it."""
    b = x0.shape[0]
    s = quantile_rows(x0.reshape(b, -1).abs(), percentile).clamp_min(1.0)
    s = s.reshape((b,) + (1,) * (x0.ndim - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def ddim_sample(denoise, noise_seq, cond, cond_scale: float, timesteps: int, steps: int,
                eta: float):
    """eta-DDIM over ``steps`` of the ``timesteps`` schedule; noise_seq[0] is
    x_T and noise_seq[i + 1] the noise of step i."""
    bufs = diffusion_buffers(timesteps)
    acp = bufs["alphas_cumprod_prev"]
    img = noise_seq[0]
    for i, (time, time_next) in enumerate(ddim_times(timesteps, steps)):
        alpha, alpha_next = acp[time], acp[time_next]
        tvec = torch.full((img.shape[0],), time, dtype=torch.int64, device=img.device)
        eps = denoise(img, tvec, cond)
        if cond_scale != 1.0:
            null = denoise(img, tvec, torch.zeros_like(cond))
            eps = null + (eps - null) * cond_scale
        x0 = (bufs["sqrt_recip_alphas_cumprod"][time].item() * img
              - bufs["sqrt_recipm1_alphas_cumprod"][time].item() * eps)
        x0 = threshold(x0)
        sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        c = torch.sqrt(torch.clamp((1 - alpha_next) - sigma ** 2, min=0.0))
        img = (x0 * torch.sqrt(alpha_next).item() + c.item() * eps
               + float(time_next > 0) * sigma.item() * noise_seq[i + 1])
    return img


# --------------------------------------------------------- the LFG decoder

class BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm on the last axis, by the running statistics."""

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * inv + (self.bias - self.running_mean * inv)


class SameBlock2d(nn.Module):
    def __init__(self, fin: int, fout: int, ops: Operands, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(fin, fout, kernel_size, padding=kernel_size // 2)
        self.norm = BatchNorm(fout)
        self.ops = ops

    def forward(self, x):
        c = self.conv
        return F.relu(self.norm(conv2d(x, c.weight, c.bias, self.ops, padding=c.padding[0])))


class DownBlock2d(SameBlock2d):
    def __init__(self, fin: int, fout: int, ops: Operands):
        super().__init__(fin, fout, ops, kernel_size=3)

    def forward(self, x):
        y = super().forward(x).permute(0, 3, 1, 2)
        return F.avg_pool2d(y, 2).permute(0, 2, 3, 1)


class UpBlock2d(SameBlock2d):
    def __init__(self, fin: int, fout: int, ops: Operands):
        super().__init__(fin, fout, ops, kernel_size=3)

    def forward(self, x):
        n, h, w, c = x.shape
        up = F.interpolate(x.permute(0, 3, 1, 2), size=(h * 2, w * 2), mode="nearest")
        return super().forward(up.permute(0, 2, 3, 1))


class ResBlock2d(nn.Module):
    def __init__(self, features: int, ops: Operands):
        super().__init__()
        self.norm1 = BatchNorm(features)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.ops = ops

    def forward(self, x):
        h = conv2d(F.relu(self.norm1(x)), self.conv1.weight, self.conv1.bias, self.ops, padding=1)
        h = conv2d(F.relu(self.norm2(h)), self.conv2.weight, self.conv2.bias, self.ops, padding=1)
        return h + x


def warp_shared(src, flow):
    """Bilinear warp (align_corners=False, zeros outside) of one source
    (B, H, W, C) by T flows (B, T, h, w, 2) in [-1, 1], each first resized
    bilinearly to (H, W) when it differs; returns (B*T, H, W, C)."""
    b, t, hf, wf, _ = flow.shape
    _, h, w, c = src.shape
    if (hf, wf) != (h, w):
        flow = F.interpolate(flow.reshape(b * t, hf, wf, 2).permute(0, 3, 1, 2), size=(h, w),
                             mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    grid = flow.reshape(b, t, h, w, 2)
    out = torch.stack([F.grid_sample(src[i:i + 1].permute(0, 3, 1, 2).expand(t, -1, -1, -1),
                                     grid[i], mode="bilinear", padding_mode="zeros",
                                     align_corners=False) for i in range(b)])
    return out.permute(0, 1, 3, 4, 2).reshape(b * t, h, w, c)


def blend(skip, flow, occ, previous=None):
    """The warped skip times the occlusion map (resized bilinearly to it),
    plus ``previous`` times its complement."""
    out = warp_shared(skip, flow)
    b, t = flow.shape[:2]
    occ = occ.reshape(b * t, *occ.shape[2:])
    if occ.shape[1:3] != out.shape[1:3]:
        occ = F.interpolate(occ.permute(0, 3, 1, 2), size=out.shape[1:3], mode="bilinear",
                            align_corners=False).permute(0, 2, 3, 1)
    return out * occ if previous is None else out * occ + previous * (1 - occ)


class LFGGenerator(nn.Module):
    def __init__(self, ops: Operands, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 512, num_down_blocks: int = 2,
                 num_bottleneck_blocks: int = 6):
        super().__init__()
        self.ops = ops
        self.first = SameBlock2d(num_channels, block_expansion, ops)
        self.down_blocks = nn.ModuleList(
            DownBlock2d(min(max_features, block_expansion * 2 ** i),
                        min(max_features, block_expansion * 2 ** (i + 1)), ops)
            for i in range(num_down_blocks))
        self.up_blocks = nn.ModuleList(
            UpBlock2d(min(max_features, block_expansion * 2 ** (num_down_blocks - i)),
                      min(max_features, block_expansion * 2 ** (num_down_blocks - i - 1)), ops)
            for i in range(num_down_blocks))
        feat = min(max_features, block_expansion * 2 ** num_down_blocks)
        self.bottleneck = nn.Sequential(OrderedDict(
            (f"r{i}", ResBlock2d(feat, ops)) for i in range(num_bottleneck_blocks)))
        self.final = nn.Conv2d(block_expansion, num_channels, 7, padding=3)

    def encode(self, src):
        skips = [self.first(src)]
        for blk in self.down_blocks:
            skips.append(blk(skips[-1]))
        return skips

    def decode(self, src, skips, flow, occ):
        """(B, T, H, W, 3) frames from B sources, their skips, and (B, T)
        flows and occlusion maps."""
        b, t = flow.shape[:2]
        out = self.bottleneck(blend(skips[-1], flow, occ))
        for i, up in enumerate(self.up_blocks):
            out = up(blend(skips[-(i + 1)], flow, occ, out))
        out = blend(skips[0], flow, occ, out)
        out = torch.sigmoid(conv2d(out, self.final.weight, self.final.bias, self.ops, padding=3))
        out = blend(src, flow, occ, out)
        return out.reshape(b, t, *out.shape[1:])


# ------------------------------------------------------------- the whole

class FaceLocEncoder(nn.Module):
    def __init__(self, ops: Operands):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 8, 3, stride=2, padding=1)
        self.conv2 = nn.Conv2d(8, 16, 3, stride=2, padding=1)
        self.ops = ops

    def forward(self, x):
        for c in (self.conv1, self.conv2):
            x = F.relu(conv2d(x, c.weight, c.bias, self.ops, stride=2, padding=1))
        return x


def bbox_mask(bbox, size: int):
    """(B, size, size, 1) binary mask of [x0, x1, y0, y1, H, W] boxes: x
    scaled by H and y by W, corners truncated, both ends included."""
    bbox = bbox.float()
    x = bbox[:, 0:2] / bbox[:, 4:5] * size
    y = bbox[:, 2:4] / bbox[:, 5:6] * size
    x0, x1 = x[:, 0].to(torch.int32), (x[:, 1] + 1).to(torch.int32)
    y0, y1 = y[:, 0].to(torch.int32), (y[:, 1] + 1).to(torch.int32)
    idx = torch.arange(size, device=bbox.device)
    rows, cols = idx[None, :, None], idx[None, None, :]
    inside = ((rows >= y0[:, None, None]) & (rows <= y1[:, None, None])
              & (cols >= x0[:, None, None]) & (cols <= x1[:, None, None]))
    return inside.float()[..., None]


class FlowDiffusion(nn.Module):
    """The model under the checkpoint's top-level names: ``unet``,
    ``generator`` (the LFG generator) and ``face_loc``. ``unet_ops`` and
    ``lfg_ops`` round the operands of the two halves' products."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = config
        self.unet_ops, self.lfg_ops = Operands(), Operands()
        u = config["unet"]
        self.unet = Unet3D(self.unet_ops, win_width=config["win_width"],
                           cond_pose=config["pose_dim"], **u)
        self.generator = LFGGenerator(self.lfg_ops, **config["lfg"])
        self.face_loc = FaceLocEncoder(self.lfg_ops)

    def set_precision(self, unet: str, lfg: str):
        self.unet_ops.kind, self.lfg_ops.kind = unet, lfg

    def prepare(self, inputs):
        """The condition and the step-constant init-conv part, from the inputs."""
        img, hub, pose, eye, bbox = (inputs[k].float() for k in
                                     ("sample_img", "audio_hubert", "pose", "eye", "bbox"))
        p = self.config["pose_dim"]
        pose = pose[..., :p]
        cond = torch.cat([hub, pose - pose[:, :1], eye - eye[:, :1]], dim=-1)
        fea = self.generator.encode(img)[-1]
        mask = self.face_loc(bbox_mask(bbox, self.config["img_size"]))
        static = self.unet.static_part(torch.cat([fea, mask], dim=-1)[:, None])
        return cond, static

    @torch.no_grad()
    def sample_latents(self, inputs):
        """(B, T, h, w, 3) latent video: flow and occlusion logit."""
        no_tf32()
        c = self.config
        cond, static = self.prepare(inputs)
        return ddim_sample(lambda x, tvec, cnd: self.unet(x, tvec, cnd, static),
                           inputs["noise_seq"].float(), cond, c["cond_scale"], c["timesteps"],
                           c["sampling_timesteps"], c["ddim_sampling_eta"])

    @torch.no_grad()
    def decode(self, img, latent):
        """The (B, T, H, W, 3) video of a latent, in blocks of frames."""
        no_tf32()
        grid, conf = latent[..., :2], (latent[..., 2:3] + 1.0) * 0.5
        skips = self.generator.encode(img.float())
        return torch.cat([self.generator.decode(img.float(), skips, grid[:, i:i + DECODE_BLOCK],
                                                conf[:, i:i + DECODE_BLOCK])
                          for i in range(0, latent.shape[1], DECODE_BLOCK)], dim=1)

    @torch.no_grad()
    def sample(self, inputs) -> Dict[str, torch.Tensor]:
        """What the timed call returns and the run compares: the latent
        flow, the occlusion map and the video, each (B, T, ...)."""
        latent = self.sample_latents(inputs)
        return {"sample_vid_grid": latent[..., :2],
                "sample_vid_conf": (latent[..., 2:3] + 1.0) * 0.5,
                "sample_out_vid": self.decode(inputs["sample_img"], latent)}


# ------------------------------------------- what a run hands to both sides

def seeded_state_dict(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from ``seed``, made on ``device`` in two draws: a
    convolution's or linear layer's weight and bias uniform in
    +-1/sqrt(fan_in) (PyTorch's default), an embedding table and the null
    key/value standard normal, BatchNorm running means 0.1 x normal and
    variances uniform in [0.5, 1.5], every other scale or shift 1 or 0 plus
    0.1 x normal."""
    with torch.device(device):          # the names and shapes (a meta build costs more)
        model = FlowDiffusion(config)
    uniform, normal, rest = [], [], []
    for mname, mod in model.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        fan_in = None
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            w = mod.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
        for pname, p in tensors:
            key = f"{mname}.{pname}" if mname else pname
            if fan_in is not None:
                uniform.append((key, p.shape, 1.0 / math.sqrt(fan_in), 0.0))
            elif isinstance(mod, nn.Embedding) or pname == "null_kv":
                normal.append((key, p.shape, 1.0, 0.0))
            elif pname == "num_batches_tracked":
                rest.append((key, p.shape, p.dtype))
            elif pname == "running_var":
                uniform.append((key, p.shape, 0.5, 1.0))
            elif pname == "running_mean":
                normal.append((key, p.shape, 0.1, 0.0))
            else:   # norm scales and shifts, q/k scales
                normal.append((key, p.shape, 0.1, 0.0 if pname == "bias" else 1.0))
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    u = torch.rand(sum(math.prod(s) for _, s, _, _ in uniform), generator=g, device=device)
    z = torch.randn(sum(math.prod(s) for _, s, _, _ in normal), generator=g, device=device)
    out = {}
    for draws, table, to_value in ((u, uniform, lambda v, a, c: (2 * v - 1) * a + c),
                                   (z, normal, lambda v, a, c: v * a + c)):
        at = 0
        for key, shape, a, c in table:
            n = math.prod(shape)
            out[key] = to_value(draws[at:at + n], a, c).reshape(shape)
            at += n
    for key, shape, dtype in rest:
        out[key] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def make_inputs(config: dict, traffic: dict, seed: int, index: int, device):
    """The inputs of call ``index`` of a run seeded ``seed``: ``batch``
    portraits in [0, 1] (smooth: uniform draws on a grid of PORTRAIT_CELL
    pixels, interpolated bilinearly; a portrait of white noise would make
    every pixel of the warped video turn on a sub-pixel error of the flow),
    HuBERT features, pose and blink drives over
    ``frames`` frames, a face box inside the image, and the DDIM noise
    (steps + 1 gaussians at the latent's shape), drawn on ``device``."""
    b, t, s = traffic["batch"], traffic["frames"], config["img_size"]
    ls, steps = s // 4, config["sampling_timesteps"]
    g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % 2 ** 63)
    box = torch.rand(b, 4, generator=g, device=device)
    lo = torch.tensor([0.15, 0.70, 0.15, 0.70], device=device)
    corners = (lo + 0.15 * box) * s
    coarse = torch.rand(b, 3, max(s // PORTRAIT_CELL, 2), max(s // PORTRAIT_CELL, 2),
                        generator=g, device=device)
    img = F.interpolate(coarse, size=(s, s), mode="bilinear", align_corners=False)
    return {
        "sample_img": img.permute(0, 2, 3, 1).contiguous(),
        "audio_hubert": torch.randn(b, t, 1024, generator=g, device=device),
        "pose": 0.1 * torch.randn(b, t, config["pose_dim"], generator=g, device=device),
        "eye": 0.1 * torch.randn(b, t, 2, generator=g, device=device),
        "bbox": torch.cat([corners, torch.full((b, 2), float(s), device=device)], dim=1),
        "noise_seq": torch.randn(steps + 1, b, t, ls, ls, 3, generator=g, device=device),
    }


def call_flops(config: dict, traffic: dict) -> int:
    """Operations of one call at the traffic's shapes, counted on this
    reference on the meta device: the matrix products and convolutions as
    ``FlopCounterMode`` counts them, the temporal attention as its in-band
    pairs at 4 x head_dim (from the shapes each attention is called with,
    in place of the whole (T, T) products that this reference computes).
    The preparation and the decode once, the UNet once a step (twice under
    guidance)."""
    from torch.utils.flop_counter import FlopCounterMode
    b, t, s = traffic["batch"], traffic["frames"], config["img_size"]
    ls = s // 4
    with torch.device("meta"):
        model = FlowDiffusion(config)
        inputs = {"sample_img": torch.empty(b, s, s, 3), "audio_hubert": torch.empty(b, t, 1024),
                  "pose": torch.empty(b, t, config["pose_dim"]), "eye": torch.empty(b, t, 2),
                  "bbox": torch.empty(b, 6)}
        x = torch.empty(b, t, ls, ls, 3)
        tvec = torch.zeros(b, dtype=torch.int64)
    band_less_whole = []

    def count(module, args):
        b, seqs, t, _ = args[0].shape
        n, h, d = b * seqs, module.heads, module.dim_head
        band_less_whole.append(attention_flops(n, t, h, d, module.window) - 4 * n * h * t * t * d)

    hooks = [m.register_forward_pre_hook(count) for m in model.unet.modules()
             if isinstance(m, TemporalAttention)]
    calls = config["sampling_timesteps"] * (1 if config["cond_scale"] == 1.0 else 2)
    with FlopCounterMode(display=False) as fc:
        cond, static = model.prepare(inputs)
        once = fc.get_total_flops()
        model.unet(x, tvec, cond, static)
        unet = fc.get_total_flops() - once
        model.decode(inputs["sample_img"], x)
        decode = fc.get_total_flops() - once - unet
    for h in hooks:
        h.remove()
    return int(once + calls * (unet + sum(band_less_whole)) + decode)


def frame_errors(got, want):
    """(B, T) relative L2 error of each frame of (B, T, ...) outputs; a
    non-finite frame reads infinite."""
    d = (got.float() - want.float()).flatten(2).norm(dim=2)
    r = want.float().flatten(2).norm(dim=2).clamp_min(1e-12)
    return torch.nan_to_num(d / r, nan=float("inf"), posinf=float("inf"))


def compare(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
            redecoded: torch.Tensor) -> Dict[str, float]:
    """The numbers a run is judged by, each the worst frame's relative
    error over every clip of the call: the latent (flow and occlusion
    together) and the video against the reference's, and the video against
    the reference's decode of the program's own latent (the decoder alone)."""
    latent = [torch.cat([d["sample_vid_grid"].float(), d["sample_vid_conf"].float()], dim=-1)
              for d in (got, want)]
    return {"latent_err": frame_errors(*latent).max().item(),
            "decode_err": frame_errors(got["sample_out_vid"], redecoded).max().item(),
            "video_err": frame_errors(got["sample_out_vid"], want["sample_out_vid"]).max().item()}


def build(config: dict, state_dict: Dict[str, torch.Tensor], device) -> FlowDiffusion:
    """The reference on ``device`` with ``state_dict`` loaded, in float32."""
    with torch.device(device):
        model = FlowDiffusion(config)
    model.load_state_dict(state_dict, strict=True)
    return model


def judge(model: FlowDiffusion, inputs, got, want=None) -> Dict[str, float]:
    """``compare`` of the outputs ``got`` of a call on ``inputs``, with
    ``model`` the float32 reference (``want``: its outputs, when already
    computed)."""
    if want is None:
        want = model.sample(inputs)
    latent = torch.cat([got["sample_vid_grid"].float(),
                        got["sample_vid_conf"].float() * 2.0 - 1.0], dim=-1)
    return compare(got, want, model.decode(inputs["sample_img"], latent))
