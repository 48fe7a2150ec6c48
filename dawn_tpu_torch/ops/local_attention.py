"""Windowed (local) temporal attention: plain PyTorch forms, kernels K1 and K2.

Semantics (those of ``dawn_tpu/ops/local_attention.py``): the weight of query
i over key j is the softmax of q_i . k_j + b[j - i] for |j - i| <= window and
-1e9 otherwise, over keys in [0, T). q arrives pre-scaled and rotary-rotated.
Softmax and accumulation run in f32; the output has the input dtype.

- :func:`local_attention_banded`: the JAX CPU path's blockwise banded form,
  (N, H, T, D) layout.
- :func:`local_attention_packed_plain`: the same function in the packed
  (N, T, H*D) layout that the qkv projection produces.
- :func:`windowed_full_attention`: the windowed-full einsum of
  ``TemporalAttention`` in 'full' mode, with a caller-built (.., H, T, T) bias.
- :func:`local_attention_packed`: K1. On a CUDA tensor it launches the
  hand-written kernel in ``csrc/local_attention.cu``; on a CPU tensor it runs
  :func:`local_attention_packed_plain`. Its ``launches`` attribute counts
  kernel launches. Under autograd it goes through
  :class:`LocalAttentionPacked`, whose backward is K2.
- :func:`local_attention_packed_bwd`: K2, the backward, in
  ``csrc/local_attention_bwd.cu``; :func:`local_attention_packed_bwd_plain`
  is its plain version.
- :func:`local_attention`: the dispatch on the (N, H, T, D) layout for any T.
  A CUDA tensor goes to K3 (:func:`local_attention_tiled`, a second C entry
  in ``csrc/local_attention.cu``), through :class:`LocalAttentionTiled`
  when grad is on; its backward is K4 (:func:`local_attention_tiled_bwd`,
  ``csrc/local_attention_tiled_bwd.cu``, plain version
  :func:`local_attention_tiled_bwd_plain`). A CPU tensor goes to
  :func:`local_attention_banded`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e9
PACKED_MAX_T = 256       # K1 covers T <= 256 (the TPU kernel's range)
BANDED_BLOCK_Q = 128     # query block of the banded form (forward and plain backward)


def windowed_bias(t: int, window: int, bias_vec: Optional[torch.Tensor],
                   device) -> torch.Tensor:
    """(H or 1, T, T) f32 additive bias: T5 bias in the band, NEG_INF outside."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    mask = torch.from_numpy(np.where(np.abs(rel) <= window, 0.0, NEG_INF)
                            .astype(np.float32)).to(device)
    if bias_vec is None:
        return mask[None]
    idx = torch.from_numpy(np.clip(rel + window, 0, 2 * window)).to(device)
    return bias_vec.float()[:, idx] + mask[None]


def _banded_blocks(t: int, window: int):
    """Query block ``bq``, block count and key-stripe width of the banded form."""
    bq = min(BANDED_BLOCK_Q, max(8, t))
    nb = -(-t // bq)
    return bq, nb, bq + 2 * window


def _banded_bias(t: int, window: int, bq: int, nb: int, kw: int,
                 bias_vec: Optional[torch.Tensor], device):
    """The banded blocks' additive f32 term, (1, H or 1, nb, bq, kw): the T5
    bias inside the band, NEG_INF outside it and on keys outside [0, T)
    (bias and key validity are summed while small, so the scores take one
    full-size add). Also returns the (bq, kw) offsets key - query."""
    rel = (np.arange(kw)[None, :] - window) - np.arange(bq)[:, None]   # (bq, kw)
    band = torch.from_numpy(np.where(np.abs(rel) <= window, 0.0, NEG_INF)
                            .astype(np.float32)).to(device)
    if bias_vec is None:
        bias = band[None]
    else:
        idx = torch.from_numpy(np.clip(rel + window, 0, 2 * window)).to(device)
        bias = bias_vec.float()[:, idx] + band[None]                   # (h, bq, kw)
    jg = (np.arange(nb)[:, None] * bq - window) + np.arange(kw)[None, :]
    key_valid = torch.from_numpy(np.where((jg >= 0) & (jg < t), 0.0, NEG_INF)
                                 .astype(np.float32)).to(device)      # (nb, kw)
    return (bias[:, None] + key_valid[:, None])[None], rel


def local_attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_vec: Optional[torch.Tensor], window: int) -> torch.Tensor:
    """Banded local attention, (N, H, T, D) -> (N, H, T, D).

    Queries go in blocks of ``bq``; block b attends the key stripe of
    ``bq + 2*window`` frames starting at b*bq - window (zero-padded), so the
    scores take O(T * (bq + 2w)) memory."""
    n, h, t, d = q.shape
    bq, nb, kw = _banded_blocks(t, window)
    t_pad = nb * bq
    f32 = torch.float32
    qp = torch.nn.functional.pad(q.to(f32), (0, 0, 0, t_pad - t))
    kp = torch.nn.functional.pad(k.to(f32), (0, 0, window, t_pad - t + window))
    vp = torch.nn.functional.pad(v.to(f32), (0, 0, window, t_pad - t + window))
    qb = qp.reshape(n, h, nb, bq, d)
    stripes_k = kp.unfold(2, kw, bq).transpose(-1, -2)        # (n, h, nb, kw, d)
    stripes_v = vp.unfold(2, kw, bq).transpose(-1, -2)
    scores = torch.einsum("nhbid,nhbjd->nhbij", qb, stripes_k)
    # torch.softmax subtracts the row max itself
    attn = torch.softmax(scores + _banded_bias(t, window, bq, nb, kw, bias_vec, q.device)[0],
                         dim=-1)
    out = torch.einsum("nhbij,nhbjd->nhbid", attn, stripes_v)
    return out.reshape(n, h, t_pad, d)[:, :, :t].to(q.dtype)


def local_attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias_vec: Optional[torch.Tensor], window: int,
                                 heads: int) -> torch.Tensor:
    """K1's function in plain PyTorch, (N, T, H*D) -> (N, T, H*D), any T.

    Whole-sequence (T, T) scores per head with the band folded into the
    bias; the normalization is applied to the output, as in the kernel."""
    n, t, hd = q.shape
    d = hd // heads

    def split(x):
        return x.float().reshape(n, t, heads, d).transpose(1, 2)   # (n, h, t, d)

    s = split(q) @ split(k).transpose(-1, -2)
    s = s + windowed_bias(t, window, bias_vec, q.device)[None]
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    o = (p @ split(v)) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(n, t, hd).to(q.dtype)


def windowed_full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pos_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T + pos_bias) v over the last two axes of (..., T, D)
    inputs, scores in f32, probabilities cast to v's dtype
    (``dawn_tpu/models/dm/unet3d.py:587-593``)."""
    sim = (q @ k.transpose(-1, -2)).float()
    if pos_bias is not None:
        sim = sim + pos_bias
    sim = sim - sim.amax(dim=-1, keepdim=True)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return attn @ v


def local_attention_packed_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     g: torch.Tensor, bias_vec: Optional[torch.Tensor],
                                     window: int, heads: int):
    """K2's function in plain PyTorch: the gradients of
    :func:`local_attention_packed_plain` with respect to q, k, v and the f32
    bias vector, given the output gradient ``g``. Whole-sequence (T, T) f32
    scores per head with the band folded into the bias, as the TPU kernel
    computes them. Returns (dq, dk, dv) in the input dtype and dvec
    ((H, 2w+1) f32, or None without a bias)."""
    n, t, hd = q.shape
    d = hd // heads

    def split(x):
        return x.float().reshape(n, t, heads, d).transpose(1, 2)   # (n, h, t, d)

    def merge(x):
        return x.transpose(1, 2).reshape(n, t, hd).to(q.dtype)

    qs, ks, vs, gs = map(split, (q, k, v, g))
    s = qs @ ks.transpose(-1, -2) + windowed_bias(t, window, bias_vec, q.device)[None]
    p = torch.softmax(s, dim=-1)
    dp = gs @ vs.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq, dk, dv = ds @ ks, ds.transpose(-1, -2) @ qs, p.transpose(-1, -2) @ gs
    dvec = None
    if bias_vec is not None:
        # entry (i, j) of dS belongs to the bias offset j - i
        rel = np.arange(t)[None, :] - np.arange(t)[:, None]
        onehot = torch.from_numpy((rel[None] == np.arange(-window, window + 1)[:, None, None])
                                  .astype(np.float32)).to(q.device)     # (2w+1, t, t)
        dvec = torch.einsum("hij,rij->hr", ds.sum(dim=0), onehot)
    return merge(dq), merge(dk), merge(dv), dvec


_DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library(name: str, symbol: str, argtypes: tuple) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu`` with ``symbol``'s C signature set
    (once per library)."""
    from dawn_tpu_torch import build
    lib = build.load(name)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib


def _check_kernel_inputs(what: str, q: torch.Tensor, others, bias_vec, window: int,
                         heads: int, dim_head: int, max_t: Optional[int] = None) -> None:
    """Raise on what the CUDA kernels do not take: T > ``max_t``, dim_head
    != 32, another dtype, mismatched or non-contiguous tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    t = q.shape[-2]
    if max_t is not None and t > max_t:
        raise ValueError(
            f"{what} covers T <= {max_t}, got T={t}: longer sequences go to K3 "
            "on the (N, H, T, D) layout (local_attention / local_attention_tiled)")
    if q.dtype not in _DTYPE_FLAG:
        raise TypeError(f"{what} takes float32 or bfloat16, got {q.dtype}")
    if dim_head != 32:
        raise ValueError(f"{what} is built for dim_head 32, got {dim_head}")
    for name, x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} {x.device} does "
                             f"not match q {tuple(q.shape)} {q.dtype} {q.device}")
    if not (q.is_contiguous() and all(x.is_contiguous() for _, x in others)):
        raise ValueError(f"{what} needs contiguous inputs")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if bias_vec is not None:
        if (bias_vec.shape != (heads, 2 * window + 1) or bias_vec.dtype != torch.float32
                or bias_vec.device != q.device or not bias_vec.is_contiguous()):
            raise ValueError(f"bias_vec must be contiguous f32 ({heads}, "
                             f"{2 * window + 1}) on {q.device}, got "
                             f"{tuple(bias_vec.shape)} {bias_vec.dtype} {bias_vec.device}")


def _packed_dim_head(q: torch.Tensor, heads: int) -> int:
    hd = q.shape[-1]
    if hd % heads:
        raise ValueError(f"packed width {hd} is not a multiple of {heads} heads")
    return hd // heads


def _forward(q, k, v, bias_vec, window: int, heads: int) -> torch.Tensor:
    """K1 on a CUDA tensor (counted in ``local_attention_packed.launches``),
    the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return local_attention_packed_plain(q, k, v, bias_vec, window, heads)
    _check_kernel_inputs("K1", q, (("k", k), ("v", v)), bias_vec, window, heads,
                         _packed_dim_head(q, heads), PACKED_MAX_T)
    n, t, hd = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _library("local_attention", "dawn_local_attn_packed_fwd",
                   (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dawn_local_attn_packed_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None, out.data_ptr(),
            n, t, heads, hd // heads, window, _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    local_attention_packed.launches += 1
    return out


def local_attention_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               g: torch.Tensor, bias_vec: Optional[torch.Tensor],
                               window: int, heads: int):
    """K2: the backward of K1 on the packed (N, T, H*D) layout; returns
    (dq, dk, dv, dvec) as :func:`local_attention_packed_bwd_plain` does.

    A CUDA tensor launches the CUDA kernel in ``csrc/local_attention_bwd.cu``
    (T <= 256, D = 32, f32 or bf16, contiguous inputs) or raises; a CPU
    tensor takes the plain version. The kernel writes one (2w+1) bias
    partial per (sequence, head), summed here over sequences in a fixed
    order. Its ``launches`` attribute counts kernel launches."""
    if q.device.type == "cpu":
        return local_attention_packed_bwd_plain(q, k, v, g, bias_vec, window, heads)
    _check_kernel_inputs("K2", q, (("k", k), ("v", v), ("g", g)), bias_vec, window, heads,
                         _packed_dim_head(q, heads), PACKED_MAX_T)
    n, t, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partial = (torch.empty((n, heads, 2 * window + 1), dtype=torch.float32, device=q.device)
               if bias_vec is not None else None)
    if q.numel() == 0:
        return dq, dk, dv, (None if partial is None else partial.sum(dim=0))
    lib = _library("local_attention_bwd", "dawn_local_attn_packed_bwd",
                   (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dawn_local_attn_packed_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            n, t, heads, hd // heads, window, _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    local_attention_packed_bwd.launches += 1
    return dq, dk, dv, (None if partial is None else partial.sum(dim=0))


local_attention_packed_bwd.launches = 0


class LocalAttentionPacked(torch.autograd.Function):
    """Differentiable windowed attention: forward K1, backward K2 (their
    plain versions on CPU tensors). The counterpart of the JAX package's
    custom VJP ``local_attention_packed_tpu``."""

    @staticmethod
    def forward(ctx, q, k, v, bias_vec, window: int, heads: int):
        ctx.save_for_backward(q, k, v, bias_vec)
        ctx.window, ctx.heads = window, heads
        return _forward(q, k, v, bias_vec, window, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias_vec = ctx.saved_tensors
        dq, dk, dv, dvec = local_attention_packed_bwd(q, k, v, g.contiguous(), bias_vec,
                                                      ctx.window, ctx.heads)
        return dq, dk, dv, (dvec if ctx.needs_input_grad[3] else None), None, None


def local_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_vec: Optional[torch.Tensor], window: int,
                           heads: int) -> torch.Tensor:
    """K1: windowed attention on the packed (N, T, H*D) layout.

    A CUDA tensor launches the CUDA kernel (T <= 256, D = 32, f32 or bf16,
    contiguous inputs) or raises; a CPU tensor takes the plain version. When
    grad mode is on and an input requires grad, the call goes through
    :class:`LocalAttentionPacked`, whose backward is K2. The ``launches``
    attribute counts K1's kernel launches."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, bias_vec)):
        return LocalAttentionPacked.apply(q, k, v, bias_vec, window, heads)
    return _forward(q, k, v, bias_vec, window, heads)


local_attention_packed.launches = 0


def local_attention_tiled_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    g: torch.Tensor, bias_vec: Optional[torch.Tensor],
                                    window: int):
    """K4's function in plain PyTorch: the gradients of
    :func:`local_attention_banded` ((N, H, T, D) layout) with respect to q, k,
    v and the f32 bias vector, given the output gradient ``g``, written out in
    f32 on the banded blocks (scores take O(T * (bq + 2w)) memory). Key-stripe
    gradients are added back onto the sequence; dvec is the one-hot
    projection of dS summed over sequences and blocks. Returns (dq, dk, dv)
    in the input dtype and dvec ((H, 2w+1) f32, or None without a bias)."""
    n, h, t, d = q.shape
    bq, nb, kw = _banded_blocks(t, window)
    t_pad = nb * bq
    f32, dev = torch.float32, q.device
    pad_q = lambda x: torch.nn.functional.pad(x.to(f32), (0, 0, 0, t_pad - t))
    pad_k = lambda x: torch.nn.functional.pad(x.to(f32), (0, 0, window, t_pad - t + window))
    qb, gb = (pad_q(x).reshape(n, h, nb, bq, d) for x in (q, g))
    ks, vs = (pad_k(x).unfold(2, kw, bq).transpose(-1, -2) for x in (k, v))  # (n, h, nb, kw, d)

    bias, rel = _banded_bias(t, window, bq, nb, kw, bias_vec, dev)
    p = torch.softmax(qb @ ks.transpose(-1, -2) + bias, dim=-1)
    dp = gb @ vs.transpose(-1, -2)
    ds = dp.sub_((dp * p).sum(dim=-1, keepdim=True)).mul_(p)   # in place: (n, h, nb, bq, kw)

    def unstripe(x):                # (n, h, nb, kw, d) stripes -> (n, h, t, d) sums
        idx = torch.from_numpy((np.arange(nb)[:, None] * bq + np.arange(kw)[None, :])
                               .reshape(-1)).to(dev)
        out = torch.zeros(n, h, t_pad + 2 * window, d, dtype=f32, device=dev)
        out.index_add_(2, idx, x.reshape(n, h, nb * kw, d))
        return out[:, :, window:window + t]

    dq = (ds @ ks).reshape(n, h, t_pad, d)[:, :, :t]
    dk = unstripe(ds.transpose(-1, -2) @ qb)
    dv = unstripe(p.transpose(-1, -2) @ gb)
    dvec = None
    if bias_vec is not None:
        onehot = torch.from_numpy((rel[None] == np.arange(-window, window + 1)[:, None, None])
                                  .astype(np.float32)).to(dev)              # (2w+1, bq, kw)
        dvec = torch.einsum("hij,rij->hr", ds.sum(dim=(0, 2)), onehot)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dvec


def local_attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias_vec: Optional[torch.Tensor], window: int) -> torch.Tensor:
    """K3: windowed attention on the (N, H, T, D) layout, any T.

    A CUDA tensor launches the CUDA kernel (``dawn_local_attn_tiled_fwd`` in
    ``csrc/local_attention.cu``: K1's body on this layout; D = 32, f32 or
    bf16, contiguous inputs) or raises; a CPU tensor takes the plain version,
    :func:`local_attention_banded`. The ``launches`` attribute counts K3's
    kernel launches. No autograd graph: see :func:`local_attention`."""
    if q.device.type == "cpu":
        return local_attention_banded(q, k, v, bias_vec, window)
    n, h, t, d = q.shape
    _check_kernel_inputs("K3", q, (("k", k), ("v", v)), bias_vec, window, h, d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _library("local_attention", "dawn_local_attn_tiled_fwd",
                   (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dawn_local_attn_tiled_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None, out.data_ptr(),
            n, t, h, d, window, _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    local_attention_tiled.launches += 1
    return out


local_attention_tiled.launches = 0


def local_attention_tiled_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              g: torch.Tensor, bias_vec: Optional[torch.Tensor],
                              window: int):
    """K4: the backward of K3 on the (N, H, T, D) layout; returns (dq, dk,
    dv, dvec) as :func:`local_attention_tiled_bwd_plain` does.

    A CUDA tensor launches the CUDA kernel in
    ``csrc/local_attention_tiled_bwd.cu`` (D = 32, f32 or bf16, contiguous
    inputs) or raises; a CPU tensor takes the plain version. One call is two
    launches behind one C entry, counted once in ``launches``: a query-tile
    pass (dq, the row statistics, one (2w+1) bias partial per (sequence,
    head, tile)) and a key-tile pass (dk, dv from those statistics). The
    partials are summed here in a fixed order."""
    if q.device.type == "cpu":
        return local_attention_tiled_bwd_plain(q, k, v, g, bias_vec, window)
    n, h, t, d = q.shape
    _check_kernel_inputs("K4", q, (("k", k), ("v", v), ("g", g)), bias_vec, window, h, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _library("local_attention_tiled_bwd", "dawn_local_attn_tiled_bwd",
                   (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    tile = _library("local_attention_tiled_bwd", "dawn_local_attn_tiled_bwd_tile",
                    ()).dawn_local_attn_tiled_bwd_tile()     # kTile in the source
    tiles = -(-t // tile)
    partial = (torch.empty((n, h, tiles, 2 * window + 1), dtype=torch.float32,
                           device=q.device) if bias_vec is not None else None)
    if q.numel() == 0:
        return dq, dk, dv, (None if bias_vec is None else torch.zeros_like(bias_vec))
    stats = torch.empty((3, n * h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dawn_local_attn_tiled_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            partial.data_ptr() if partial is not None else None, stats.data_ptr(),
            n, t, h, d, window, _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    local_attention_tiled_bwd.launches += 1
    return dq, dk, dv, (None if partial is None else partial.sum(dim=(0, 2)))


local_attention_tiled_bwd.launches = 0


class LocalAttentionTiled(torch.autograd.Function):
    """Differentiable windowed attention on the (N, H, T, D) layout: forward
    K3, backward K4 (their plain versions on CPU tensors). The counterpart of
    the JAX package's custom VJP ``_local_attention_tpu``; like it, the
    context keeps only q, k, v and the bias vector, and K4 recomputes the
    softmax."""

    @staticmethod
    def forward(ctx, q, k, v, bias_vec, window: int):
        ctx.save_for_backward(q, k, v, bias_vec)
        ctx.window = window
        return local_attention_tiled(q, k, v, bias_vec, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias_vec = ctx.saved_tensors
        dq, dk, dv, dvec = local_attention_tiled_bwd(q, k, v, g.contiguous(), bias_vec,
                                                     ctx.window)
        return dq, dk, dv, (dvec if ctx.needs_input_grad[3] else None), None


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias_vec: Optional[torch.Tensor], window: int) -> torch.Tensor:
    """Windowed attention on the (N, H, T, D) layout, any T: the counterpart
    of ``dawn_tpu/ops/local_attention.py::local_attention``.

    A CUDA tensor always goes to K3 (:func:`local_attention_tiled`), whatever
    the row count, through :class:`LocalAttentionTiled` (backward K4) when
    grad mode is on and an input requires grad. The JAX dispatch's
    thresholds (4096 <= rows <= 16384, or a banded stripe over 4 GB) weigh
    TPU compile time against XLA's einsum and do not apply to the card; the
    port already sends every T <= 256 temporal attention to K1 on the packed
    layout (``models/dm/unet3d.py``), so this function serves T > 256. A CPU
    tensor goes to :func:`local_attention_banded`, as the JAX dispatch does
    off the TPU."""
    if q.device.type == "cpu":
        return local_attention_banded(q, k, v, bias_vec, window)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, bias_vec)):
        return LocalAttentionTiled.apply(q, k, v, bias_vec, window)
    return local_attention_tiled(q, k, v, bias_vec, window)
