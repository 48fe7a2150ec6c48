"""Windowed (local) temporal attention: plain PyTorch forms and kernels K1-K6, K1p.

Semantics (those of ``dawn_tpu/ops/local_attention.py``): the weight of query
i over key j is the softmax of q_i . k_j + b[j - i] for |j - i| <= window and
-1e9 otherwise, over keys in [0, T). q arrives pre-scaled and rotary-rotated.
Softmax and accumulation run in f32; the output has the input dtype. In bf16
each plain version rounds the probabilities (and in the backwards dS) to the
input dtype before a product exactly where its Pallas TPU kernel does
(:func:`_rounded`); the JAX package's XLA forms (its ``local_attention_banded``
and ``_stripe_attn_einsum``) round at other points and are not what the
kernels stand for. In f32 the rounding is the identity.

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
- :func:`local_attention_packed_prob`: K1p, K1 with the exponent's argument
  rounded to bf16 (the JAX function's ``prob_dtype``), a fourth C entry in
  ``csrc/local_attention.cu``; forward only. ``local_attention_packed(...,
  prob_dtype=torch.bfloat16)`` calls it.
- :func:`local_attention_packed_bwd`: K2, the backward, K4's two passes on
  the packed layout (a C entry in ``csrc/local_attention_tiled_bwd.cu``);
  :func:`local_attention_packed_bwd_plain` is its plain version.
- :func:`local_attention`: the dispatch on the (N, H, T, D) layout for any T.
  A CUDA tensor goes to K3 (:func:`local_attention_tiled`, a second C entry
  in ``csrc/local_attention.cu``), through :class:`LocalAttentionTiled`
  when grad is on; its backward is K4 (:func:`local_attention_tiled_bwd`,
  ``csrc/local_attention_tiled_bwd.cu``, plain version
  :func:`local_attention_tiled_bwd_plain`). A CPU tensor goes to
  :func:`local_attention_banded`.
- :func:`seq_sharded_local_attention`: the attention of one rank's frames
  when the frame axis is sharded over the 'seq' axis of a
  :class:`dawn_tpu_torch.parallel.mesh.Mesh`: the +-w halo of k and v is
  exchanged with the neighbour ranks, then K5
  (:func:`local_attention_packed_stripe`, a third C entry in
  ``csrc/local_attention.cu``) attends the rank's t_loc queries over its
  t_loc + 2w haloed keys, with the global edges masked by two flags. Its
  plain version, :func:`local_attention_packed_stripe_plain`, takes the
  JAX package's full (H, tq, tk) bias (:func:`stripe_bias`). With grad on,
  the stripe goes through :class:`LocalAttentionStripe`, whose backward is
  K6 (:func:`local_attention_packed_stripe_bwd`, K4's two passes on the
  packed layout: a second C entry in ``csrc/local_attention_tiled_bwd.cu``),
  and the halo exchange's backward sends the halo rows' gradients back to
  their owners.

Every kernel runs a tensor-core body in bf16 and a CUDA-core body in f32.
Each wrapper asks its source for the largest window the launch's shared
memory allows (``dawn_local_attn_max_window``) and raises a ValueError
naming it past that (K1 and K2 have none at T <= 256).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

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


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded to ``dtype`` and back: the TPU kernels' cast of P
    (or dS) to the input dtype before a product. The identity in f32."""
    return x.to(dtype).float()


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
    """Banded local attention, (N, H, T, D) -> (N, H, T, D): K3's function.

    Queries go in blocks of ``bq``; block b attends the key stripe of
    ``bq + 2*window`` frames starting at b*bq - window (zero-padded), so the
    scores take O(T * (bq + 2w)) memory. The normalised P is rounded to the
    input dtype before P.V, as the Pallas kernel ``_local_attn_tile_kernel``
    rounds it (``dawn_tpu/ops/local_attention.py:149-152``); the JAX package's
    own XLA banded form rounds elsewhere (its scores, in bf16)."""
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
    out = torch.einsum("nhbij,nhbjd->nhbid", _rounded(attn, q.dtype), stripes_v)
    return out.reshape(n, h, t_pad, d)[:, :, :t].to(q.dtype)


def _check_prob_dtype(prob_dtype) -> None:
    if prob_dtype is not None and prob_dtype != torch.bfloat16:
        raise ValueError(f"prob_dtype must be None or torch.bfloat16, got {prob_dtype!r}")


def local_attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias_vec: Optional[torch.Tensor], window: int,
                                 heads: int, prob_dtype=None) -> torch.Tensor:
    """K1's function in plain PyTorch, (N, T, H*D) -> (N, T, H*D), any T.

    Whole-sequence (T, T) scores per head with the band folded into the
    bias; the normalization is applied to the output, as in the kernel. The
    unnormalised P = exp(s - row max) is rounded to the input dtype before
    P.V and the divisor is the f32 sum of the unrounded P, as in the Pallas
    kernel ``_local_attn_packed_kernel`` (``dawn_tpu/ops/local_attention.py:
    339-346``).

    ``prob_dtype=torch.bfloat16`` is K1p's function, the same kernel's
    ``prob_dtype`` branch (``:334-338``) as XLA runs it: the exponent's
    argument s - m (m the whole row's f32 max) is rounded to bf16, its exp
    is taken and kept in f32 (not rounded again), the divisor is the f32
    sum of that p, and p is rounded to the input dtype before P.V as
    above."""
    _check_prob_dtype(prob_dtype)
    n, t, hd = q.shape
    d = hd // heads

    def split(x):
        return x.float().reshape(n, t, heads, d).transpose(1, 2)   # (n, h, t, d)

    s = split(q) @ split(k).transpose(-1, -2)
    s = s + windowed_bias(t, window, bias_vec, q.device)[None]
    s = s - s.amax(dim=-1, keepdim=True)
    if prob_dtype is not None:
        s = _rounded(s, prob_dtype)
    p = torch.exp(s)
    o = (_rounded(p, q.dtype) @ split(v)) / p.sum(dim=-1, keepdim=True)
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
    computes them; P and dS are rounded to the input dtype before the
    products for dv, dq and dk, and dvec sums the f32 dS, as in the Pallas
    kernel ``_local_attn_packed_bwd_kernel``
    (``dawn_tpu/ops/local_attention.py:773-787``). Returns (dq, dk, dv) in
    the input dtype and dvec ((H, 2w+1) f32, or None without a bias)."""
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
    pk, dsk = _rounded(p, q.dtype), _rounded(ds, q.dtype)
    dq, dk, dv = dsk @ ks, dsk.transpose(-1, -2) @ qs, pk.transpose(-1, -2) @ gs
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


def _check_aligned(what: str, tensors) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary: the
    bf16 tensor-core kernels (K1-K6) stage rows with 16-byte copies."""
    for name, x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{what} in bf16 needs {name} 16-byte aligned, got address "
                             f"{x.data_ptr():#x}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on a 16-byte boundary (a copy if it is
    not): what an autograd backward hands a tensor-core kernel."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.lru_cache(maxsize=None)
def _max_window(source: str, kernel: int, t: int, is_bf16: int, bias_grad: bool,
                device: int) -> int:
    """The largest window kernel K<kernel> of ``csrc/<source>.cu`` takes at
    T = t (K6: t_loc) on the card ``device`` (its launch's shared memory);
    2**31 - 1 for no limit."""
    lib = _library(source, "dawn_local_attn_max_window", (ctypes.c_int,) * 4)
    with torch.cuda.device(device):
        limit = lib.dawn_local_attn_max_window(kernel, t, is_bf16, int(bias_grad))
    if limit < 0:
        raise RuntimeError(f"K{kernel}: no window fits the shared memory of {device}")
    return limit


def _check_window(source: str, kernel: int, q: torch.Tensor, t: int, window: int,
                  bias_grad: bool = False) -> None:
    """Raise a ValueError naming the kernel, its largest window at this T and
    the dtype when ``window`` is past it."""
    limit = _max_window(source, kernel, t, _DTYPE_FLAG[q.dtype], bias_grad, q.device.index)
    if window > limit:
        raise ValueError(f"K{kernel} in {str(q.dtype)[6:]} takes windows up to w={limit} at "
                         f"T={t} (one block's shared memory), got w={window}")


def _packed_dim_head(q: torch.Tensor, heads: int) -> int:
    hd = q.shape[-1]
    if hd % heads:
        raise ValueError(f"packed width {hd} is not a multiple of {heads} heads")
    return hd // heads


def _forward(q, k, v, bias_vec, window: int, heads: int, prob_dtype=None) -> torch.Tensor:
    """K1 on a CUDA tensor (counted in ``local_attention_packed.launches``),
    or with ``prob_dtype`` K1p (counted in
    ``local_attention_packed_prob.launches``); the plain version on a CPU
    tensor."""
    if q.device.type == "cpu":
        return local_attention_packed_plain(q, k, v, bias_vec, window, heads, prob_dtype)
    what, symbol, wrapper = (("K1", "dawn_local_attn_packed_fwd", local_attention_packed)
                             if prob_dtype is None else
                             ("K1p", "dawn_local_attn_packed_prob_fwd",
                              local_attention_packed_prob))
    _check_kernel_inputs(what, q, (("k", k), ("v", v)), bias_vec, window, heads,
                         _packed_dim_head(q, heads), PACKED_MAX_T)
    if q.dtype == torch.bfloat16:
        _check_aligned(what, (("q", q), ("k", k), ("v", v)))
    n, t, hd = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _check_window("local_attention", 1, q, t, window)   # K1p: K1's shared memory
    lib = _library("local_attention", symbol,
                   (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None, out.data_ptr(),
            n, t, heads, hd // heads, window, _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    wrapper.launches += 1
    return out


def local_attention_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               g: torch.Tensor, bias_vec: Optional[torch.Tensor],
                               window: int, heads: int):
    """K2: the backward of K1 on the packed (N, T, H*D) layout; returns
    (dq, dk, dv, dvec) as :func:`local_attention_packed_bwd_plain` does.

    A CUDA tensor launches ``dawn_local_attn_packed_bwd`` in
    ``csrc/local_attention_tiled_bwd.cu``, K4's query-tile and key-tile
    passes with the key range [0, T) (T <= 256, D = 32, f32 or bf16,
    contiguous inputs; bf16 on the tensor cores, 16-byte aligned; any w) or
    raises; a CPU tensor takes the plain version. The kernel walks the band
    clamped to w_eff = min(w, T - 1), the keys that exist, and writes one
    (2 w_eff + 1) bias partial per (sequence, head, query tile), summed here
    in a fixed order and widened to (H, 2w+1) by :func:`_widen_bias_grad`.
    One call is two launches, counted once in ``launches``."""
    if q.device.type == "cpu":
        return local_attention_packed_bwd_plain(q, k, v, g, bias_vec, window, heads)
    _check_kernel_inputs("K2", q, (("k", k), ("v", v), ("g", g)), bias_vec, window, heads,
                         _packed_dim_head(q, heads), PACKED_MAX_T)
    if q.dtype == torch.bfloat16:
        _check_aligned("K2", (("q", q), ("k", k), ("v", v), ("g", g)))
    n, t, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv, (None if bias_vec is None else torch.zeros_like(bias_vec))
    _check_window("local_attention_tiled_bwd", 2, q, t, window, bias_vec is not None)
    lib = _library("local_attention_tiled_bwd", "dawn_local_attn_packed_bwd",
                   (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    # the band the C entry walks: min(w, T - 1)
    partial, stats = _tiled_bwd_scratch(n, heads, t, min(window, t - 1), bias_vec is not None,
                                        q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dawn_local_attn_packed_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            partial.data_ptr() if partial is not None else None, stats.data_ptr(),
            n, t, heads, hd // heads, window, _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    local_attention_packed_bwd.launches += 1
    return dq, dk, dv, (None if partial is None
                        else _widen_bias_grad(partial.sum(dim=(0, 2)), window))


def _widen_bias_grad(dvec: torch.Tensor, window: int) -> torch.Tensor:
    """The (H, 2b+1) gradient of a band clamped to b <= w, the bias entries
    [w - b, w + b], placed in the middle of an (H, 2w+1) row of zeros: the
    entries past the band (offsets beyond T - 1) weigh no key and get none."""
    pad = window - (dvec.shape[-1] - 1) // 2
    return dvec if pad == 0 else torch.nn.functional.pad(dvec, (pad, pad))


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
        dq, dk, dv, dvec = local_attention_packed_bwd(q, k, v, _aligned(g), bias_vec,
                                                      ctx.window, ctx.heads)
        return dq, dk, dv, (dvec if ctx.needs_input_grad[3] else None), None, None


def _requires_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


def local_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_vec: Optional[torch.Tensor], window: int,
                           heads: int, prob_dtype=None) -> torch.Tensor:
    """K1: windowed attention on the packed (N, T, H*D) layout.

    A CUDA tensor launches the CUDA kernel (T <= 256, D = 32, f32 or bf16,
    contiguous inputs; bf16 on the tensor cores, 16-byte aligned, any w) or
    raises; a CPU tensor takes the plain version. When
    grad mode is on and an input requires grad, the call goes through
    :class:`LocalAttentionPacked`, whose backward is K2. The ``launches``
    attribute counts K1's kernel launches. ``prob_dtype=torch.bfloat16``
    goes to K1p (:func:`local_attention_packed_prob`), which has no
    backward."""
    _check_prob_dtype(prob_dtype)
    if prob_dtype is not None:
        return local_attention_packed_prob(q, k, v, bias_vec, window, heads)
    if _requires_grad(q, k, v, bias_vec):
        return LocalAttentionPacked.apply(q, k, v, bias_vec, window, heads)
    return _forward(q, k, v, bias_vec, window, heads)


local_attention_packed.launches = 0


def local_attention_packed_prob(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias_vec: Optional[torch.Tensor], window: int,
                                heads: int) -> torch.Tensor:
    """K1p: K1 with bf16 probability tiles, the counterpart of the JAX
    package's ``local_attention_packed(prob_dtype=jnp.bfloat16)``; the
    function of :func:`local_attention_packed_plain` with ``prob_dtype``.

    A CUDA tensor launches ``dawn_local_attn_packed_prob_fwd`` in
    ``csrc/local_attention.cu`` (K1's shapes and dtypes; bf16 on the tensor
    cores) or raises; a CPU tensor takes the plain version. Forward only:
    with grad on and an input requiring grad it raises, as the JAX package
    defines no VJP for it. The ``launches`` attribute counts K1p's kernel
    launches."""
    if _requires_grad(q, k, v, bias_vec):
        raise RuntimeError("K1p (prob_dtype) has no backward: the JAX package defines no "
                           "VJP for it; call it under torch.no_grad() or on detached inputs")
    return _forward(q, k, v, bias_vec, window, heads, torch.bfloat16)


local_attention_packed_prob.launches = 0


def local_attention_tiled_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    g: torch.Tensor, bias_vec: Optional[torch.Tensor],
                                    window: int):
    """K4's function in plain PyTorch: the gradients of
    :func:`local_attention_banded` ((N, H, T, D) layout) with respect to q, k,
    v and the f32 bias vector, given the output gradient ``g``, written out in
    f32 on the banded blocks (scores take O(T * (bq + 2w)) memory). P and dS
    are rounded to the input dtype before the products, as in the Pallas
    kernel ``_local_attn_tile_bwd_kernel`` (``dawn_tpu/ops/local_attention.py:
    915-916``). Key-stripe gradients are added back onto the sequence; dvec
    is the one-hot projection of the f32 dS summed over sequences and blocks.
    Returns (dq, dk, dv) in the input dtype and dvec ((H, 2w+1) f32, or None
    without a bias)."""
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

    pk, dsk = _rounded(p, q.dtype), _rounded(ds, q.dtype)
    dq = (dsk @ ks).reshape(n, h, t_pad, d)[:, :, :t]
    dk = unstripe(dsk.transpose(-1, -2) @ qb)
    dv = unstripe(pk.transpose(-1, -2) @ gb)
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
    ``csrc/local_attention.cu``; D = 32, f32 or bf16, contiguous inputs, the
    window its shared memory allows; bf16 on the tensor cores, 16-byte
    aligned, rounding the normalised P in a second walk over the band) or
    raises; a CPU tensor takes the plain version,
    :func:`local_attention_banded`. The ``launches`` attribute counts K3's
    kernel launches. No autograd graph: see :func:`local_attention`."""
    if q.device.type == "cpu":
        return local_attention_banded(q, k, v, bias_vec, window)
    n, h, t, d = q.shape
    _check_kernel_inputs("K3", q, (("k", k), ("v", v)), bias_vec, window, h, d)
    if q.dtype == torch.bfloat16:
        _check_aligned("K3", (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _check_window("local_attention", 3, q, t, window)
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
    inputs; bf16 on the tensor cores, 16-byte aligned) or raises; a CPU
    tensor takes the plain version. One call is two launches behind one C
    entry, counted once in ``launches``: a query-tile pass (dq, the row
    statistics lse and delta, one (2w+1) bias partial per (sequence, head,
    tile)) and a key-tile pass (dk, dv from those statistics). The partials
    are summed here in a fixed order."""
    if q.device.type == "cpu":
        return local_attention_tiled_bwd_plain(q, k, v, g, bias_vec, window)
    n, h, t, d = q.shape
    _check_kernel_inputs("K4", q, (("k", k), ("v", v), ("g", g)), bias_vec, window, h, d)
    if q.dtype == torch.bfloat16:
        _check_aligned("K4", (("q", q), ("k", k), ("v", v), ("g", g)))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv, (None if bias_vec is None else torch.zeros_like(bias_vec))
    _check_window("local_attention_tiled_bwd", 4, q, t, window, bias_vec is not None)
    lib = _library("local_attention_tiled_bwd", "dawn_local_attn_tiled_bwd",
                   (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    partial, stats = _tiled_bwd_scratch(n, h, t, window, bias_vec is not None, q.device)
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


def _tiled_bwd_scratch(n: int, heads: int, t_q: int, window: int, bias_grad: bool, device):
    """K2's, K4's and K6's scratch: the (N, H, tiles, 2w+1) f32 bias partials
    (or None; K2: 2 w_eff + 1 columns), tiles of the source's kTile query
    rows, and the (2, N*H, TQ) f32 row statistics (lse, delta)."""
    tile = _library("local_attention_tiled_bwd", "dawn_local_attn_tiled_bwd_tile",
                    ()).dawn_local_attn_tiled_bwd_tile()
    partial = (torch.empty((n, heads, -(-t_q // tile), 2 * window + 1), dtype=torch.float32,
                           device=device) if bias_grad else None)
    return partial, torch.empty((2, n * heads, t_q), dtype=torch.float32, device=device)


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
        dq, dk, dv, dvec = local_attention_tiled_bwd(q, k, v, _aligned(g), bias_vec,
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
    if _requires_grad(q, k, v, bias_vec):
        return LocalAttentionTiled.apply(q, k, v, bias_vec, window)
    return local_attention_tiled(q, k, v, bias_vec, window)


# --------------------------------------------------------------------------
# Sequence parallelism: the stripe kernels K5 (forward) and K6 (backward)


def stripe_bias(heads: int, t_loc: int, window: int, bias_vec: Optional[torch.Tensor],
                tq: Optional[int] = None, tk: Optional[int] = None, left_edge: bool = False,
                right_edge: bool = False, device=None) -> torch.Tensor:
    """(heads, tq, tk) f32 bias of a haloed key stripe, as the JAX package
    builds it (``_stripe_bias`` plus the global-edge masks,
    ``dawn_tpu/ops/local_attention.py:612-627, 691-697``): key column j
    sits at offset (j - w) - i from query row i; the T5 bias in the window,
    NEG_INF outside it, beyond the stripe (j >= t_loc + 2w) and on padded
    query rows (i >= t_loc); NEG_INF is added on the left halo (j < w) at
    the first rank and on the right halo (w + t_loc <= j < t_loc + 2w) at
    the last. tq and tk default to t_loc and t_loc + 2w."""
    tq = t_loc if tq is None else tq
    tk = t_loc + 2 * window if tk is None else tk
    ii = np.arange(tq)[:, None]
    jj = np.arange(tk)[None, :]
    rel = (jj - window) - ii
    ok = (np.abs(rel) <= window) & (jj < t_loc + 2 * window) & (ii < t_loc)
    mask = np.where(ok, 0.0, NEG_INF)
    if left_edge:
        mask = mask + np.where(jj < window, NEG_INF, 0.0)
    if right_edge:
        mask = mask + np.where((jj >= window + t_loc) & (jj < t_loc + 2 * window), NEG_INF, 0.0)
    if bias_vec is not None:
        device = bias_vec.device
    mask = torch.from_numpy(mask.astype(np.float32)).to(device)
    if bias_vec is None:
        return mask[None].expand(heads, tq, tk)
    idx = torch.from_numpy(np.clip(rel + window, 0, 2 * window)).to(device)
    return bias_vec.float()[:, idx] + mask[None]


def local_attention_packed_stripe_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        bias: torch.Tensor, heads: int) -> torch.Tensor:
    """K5's function in plain PyTorch, the counterpart of the JAX package's
    ``_stripe_attn_einsum``: q (N, TQ, H*D) over the haloed keys k, v (N, TK,
    H*D) with the caller's (H, >= TQ, >= TK) bias (cut to (TQ, TK)).
    Scores and softmax in f32; as in K1's Pallas body, which the TPU's K5
    runs, the unnormalised P is rounded to the input dtype before P.V and
    the output divided by the f32 sum of the unrounded P (the JAX package's
    ``_stripe_attn_einsum`` rounds the normalised P instead). Returns q's
    dtype."""
    n, t_q, hd = q.shape
    t_k = k.shape[1]
    d = hd // heads

    def split(x, t):
        return x.float().reshape(n, t, heads, d).transpose(1, 2)   # (n, h, t, d)

    s = split(q, t_q) @ split(k, t_k).transpose(-1, -2) + bias[None, :, :t_q, :t_k]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = (_rounded(p, q.dtype) @ split(v, t_k)) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(n, t_q, hd).to(q.dtype)


def local_attention_packed_stripe_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                            v: torch.Tensor, g: torch.Tensor,
                                            bias_vec: Optional[torch.Tensor], window: int,
                                            heads: int, left_edge: bool, right_edge: bool):
    """K6's function in plain PyTorch: the gradients of the stripe attention
    (q (N, t_loc, H*D) over the haloed k, v (N, t_loc + 2w, H*D), the bias of
    :func:`stripe_bias` with the given edge flags) with respect to q, k, v
    and the f32 bias vector, given the output gradient ``g``. dvec[h, r] is
    the sum of the f32 dS over the entries at key offset r - w; the JAX
    package gets the same from the autodiff of its bias construction. P and
    dS are rounded to the input dtype before the products, as in K2's Pallas
    body, which the TPU's K6 runs (``dawn_tpu/ops/local_attention.py:
    773-774``). Returns (dq, dk, dv) in the input dtype and dvec ((H, 2w+1)
    f32, or None without a bias)."""
    n, t_loc, hd = q.shape
    t_k = k.shape[1]
    d = hd // heads

    def split(x, t):
        return x.float().reshape(n, t, heads, d).transpose(1, 2)   # (n, h, t, d)

    def merge(x, t):
        return x.transpose(1, 2).reshape(n, t, hd).to(q.dtype)

    qs, gs = split(q, t_loc), split(g, t_loc)
    ks, vs = split(k, t_k), split(v, t_k)
    bias = stripe_bias(heads, t_loc, window, bias_vec, left_edge=left_edge,
                       right_edge=right_edge, device=q.device)
    p = torch.softmax(qs @ ks.transpose(-1, -2) + bias, dim=-1)
    dp = gs @ vs.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    pk, dsk = _rounded(p, q.dtype), _rounded(ds, q.dtype)
    dq, dk, dv = dsk @ ks, dsk.transpose(-1, -2) @ qs, pk.transpose(-1, -2) @ gs
    dvec = None
    if bias_vec is not None:
        rel = (np.arange(t_k)[None, :] - window) - np.arange(t_loc)[:, None]
        onehot = torch.from_numpy((rel[None] == np.arange(-window, window + 1)[:, None, None])
                                  .astype(np.float32)).to(q.device)   # (2w+1, t_loc, t_k)
        dvec = torch.einsum("hij,rij->hr", ds.sum(dim=0), onehot)
    return merge(dq, t_loc), merge(dk, t_k), merge(dv, t_k), dvec


def _check_stripe_inputs(what: str, q, kx, vx, g, bias_vec, window: int,
                         heads: int) -> None:
    """Raise on what K5/K6 do not take (the checks of the whole-sequence
    kernels, on the query side and the key side) and on keys that are not
    the queries' t_loc + 2w haloed rows."""
    n, t_loc, hd = q.shape
    want = (n, t_loc + 2 * window, hd)
    if tuple(kx.shape) != want:
        raise ValueError(f"{what}: haloed keys must be {want} for q {tuple(q.shape)} "
                         f"and window {window}, got {tuple(kx.shape)}")
    if kx.dtype != q.dtype or kx.device != q.device:
        raise ValueError(f"{what}: keys {kx.dtype} {kx.device} do not match q "
                         f"{q.dtype} {q.device}")
    dim_head = _packed_dim_head(q, heads)
    q_side = (("g", g),) if g is not None else ()
    _check_kernel_inputs(what, q, q_side, bias_vec, window, heads, dim_head)
    _check_kernel_inputs(what, kx, (("v", vx),), None, window, heads, dim_head)


def _stripe_forward(q, kx, vx, bias_vec, window: int, heads: int, left_edge: bool,
                    right_edge: bool) -> torch.Tensor:
    """K5 on a CUDA tensor (counted in ``local_attention_packed_stripe.launches``),
    the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        bias = stripe_bias(heads, q.shape[1], window, bias_vec, left_edge=left_edge,
                           right_edge=right_edge)
        return local_attention_packed_stripe_plain(q, kx, vx, bias, heads)
    _check_stripe_inputs("K5", q, kx, vx, None, bias_vec, window, heads)
    if q.dtype == torch.bfloat16:
        _check_aligned("K5", (("q", q), ("kx", kx), ("vx", vx)))
    n, t_loc, hd = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _check_window("local_attention", 5, q, t_loc, window)
    lib = _library("local_attention", "dawn_local_attn_stripe_fwd",
                   (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dawn_local_attn_stripe_fwd(
            q.data_ptr(), kx.data_ptr(), vx.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None, out.data_ptr(),
            n, t_loc, heads, hd // heads, window, int(left_edge), int(right_edge),
            _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {rc}")
    local_attention_packed_stripe.launches += 1
    return out


def local_attention_packed_stripe_bwd(q: torch.Tensor, kx: torch.Tensor, vx: torch.Tensor,
                                      g: torch.Tensor, bias_vec: Optional[torch.Tensor],
                                      window: int, heads: int, left_edge: bool,
                                      right_edge: bool):
    """K6: the backward of K5; returns (dq, dk, dv, dvec) as
    :func:`local_attention_packed_stripe_bwd_plain` does, dk and dv over the
    haloed keys.

    A CUDA tensor launches ``dawn_local_attn_stripe_bwd`` in
    ``csrc/local_attention_tiled_bwd.cu``, K4's query-tile and key-tile
    passes on the packed layout (any t_loc, D = 32, f32 or bf16, contiguous
    inputs; bf16 on the tensor cores, 16-byte aligned; the window K4 takes)
    or raises; a CPU tensor takes the plain version. One call is two
    launches, counted once in ``launches``. The kernel writes one (2w+1)
    bias partial per (sequence, head, query tile), summed here in a fixed
    order."""
    if q.device.type == "cpu":
        return local_attention_packed_stripe_bwd_plain(q, kx, vx, g, bias_vec, window, heads,
                                                       left_edge, right_edge)
    _check_stripe_inputs("K6", q, kx, vx, g, bias_vec, window, heads)
    if q.dtype == torch.bfloat16:
        _check_aligned("K6", (("q", q), ("kx", kx), ("vx", vx), ("g", g)))
    n, t_loc, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(kx), torch.empty_like(vx)
    if q.numel() == 0:
        return dq, dk, dv, (None if bias_vec is None else torch.zeros_like(bias_vec))
    _check_window("local_attention_tiled_bwd", 6, q, t_loc, window, bias_vec is not None)
    lib = _library("local_attention_tiled_bwd", "dawn_local_attn_stripe_bwd",
                   (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,))
    partial, stats = _tiled_bwd_scratch(n, heads, t_loc, window, bias_vec is not None,
                                        q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dawn_local_attn_stripe_bwd(
            q.data_ptr(), kx.data_ptr(), vx.data_ptr(), g.data_ptr(),
            bias_vec.data_ptr() if bias_vec is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            partial.data_ptr() if partial is not None else None, stats.data_ptr(),
            n, t_loc, heads, hd // heads, window, int(left_edge), int(right_edge),
            _DTYPE_FLAG[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {rc}")
    local_attention_packed_stripe_bwd.launches += 1
    return dq, dk, dv, (None if partial is None else partial.sum(dim=(0, 2)))


local_attention_packed_stripe_bwd.launches = 0


class LocalAttentionStripe(torch.autograd.Function):
    """Differentiable stripe attention: forward K5, backward K6 (their plain
    versions on CPU tensors). The counterpart of the JAX package's custom
    VJP ``local_attention_packed_stripe_tpu``."""

    @staticmethod
    def forward(ctx, q, kx, vx, bias_vec, window: int, heads: int, left_edge: bool,
                right_edge: bool):
        ctx.save_for_backward(q, kx, vx, bias_vec)
        ctx.args = (window, heads, left_edge, right_edge)
        return _stripe_forward(q, kx, vx, bias_vec, window, heads, left_edge, right_edge)

    @staticmethod
    def backward(ctx, g):
        q, kx, vx, bias_vec = ctx.saved_tensors
        dq, dk, dv, dvec = local_attention_packed_stripe_bwd(q, kx, vx, _aligned(g),
                                                             bias_vec, *ctx.args)
        return (dq, dk, dv, (dvec if ctx.needs_input_grad[3] else None),
                None, None, None, None)


def local_attention_packed_stripe(q: torch.Tensor, kx: torch.Tensor, vx: torch.Tensor,
                                  bias_vec: Optional[torch.Tensor], window: int, heads: int,
                                  left_edge: bool, right_edge: bool) -> torch.Tensor:
    """K5: windowed attention of a rank's t_loc queries q (N, t_loc, H*D)
    over its haloed keys kx, vx (N, t_loc + 2w, H*D), query row i seeing key
    rows [i, i + 2w]; ``left_edge`` masks the left halo (the first rank),
    ``right_edge`` the right one (the last rank).

    A CUDA tensor launches ``dawn_local_attn_stripe_fwd`` in
    ``csrc/local_attention.cu`` (D = 32, f32 or bf16, contiguous inputs;
    bf16 on the tensor cores, 16-byte aligned) or raises; a CPU tensor takes
    the plain version with :func:`stripe_bias`. With grad on and an input
    requiring grad, the call goes through :class:`LocalAttentionStripe`,
    whose backward is K6. The ``launches`` attribute counts K5's kernel
    launches."""
    if _requires_grad(q, kx, vx, bias_vec):
        return LocalAttentionStripe.apply(q, kx, vx, bias_vec, window, heads, left_edge,
                                          right_edge)
    return _stripe_forward(q, kx, vx, bias_vec, window, heads, left_edge, right_edge)


local_attention_packed_stripe.launches = 0


def _swap_edges(send_left: torch.Tensor, send_right: torch.Tensor, ranks, idx: int,
                group) -> tuple:
    """Send ``send_left`` to the rank before this one on the axis and
    ``send_right`` to the rank after it, all in one batch of P2P operations;
    returns (from the rank before, from the rank after), zeros where there
    is none (the global edges)."""
    from_left, from_right = torch.zeros_like(send_right), torch.zeros_like(send_left)
    ops = []
    if idx > 0:
        ops += [dist.P2POp(dist.isend, send_left.contiguous(), ranks[idx - 1], group),
                dist.P2POp(dist.irecv, from_left, ranks[idx - 1], group)]
    if idx < len(ranks) - 1:
        ops += [dist.P2POp(dist.isend, send_right.contiguous(), ranks[idx + 1], group),
                dist.P2POp(dist.irecv, from_right, ranks[idx + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


class _HaloExchange(torch.autograd.Function):
    """k, v (N, t_loc, HD) -> the haloed kx, vx (N, t_loc + 2w, HD): the
    last w rows of the rank before and the first w rows of the rank after,
    zeros at the global edges. The backward sends the halo rows' gradients
    back to their owners, who add them to their edge rows: what JAX's
    ``ppermute`` transposes to."""

    @staticmethod
    def forward(ctx, k, v, window: int, ranks, idx: int, group):
        ctx.args = (window, ranks, idx, group)
        t, w = k.shape[1], window
        edge_l = torch.cat([k[:, :w], v[:, :w]], dim=-1)
        edge_r = torch.cat([k[:, t - w:], v[:, t - w:]], dim=-1)
        halo_l, halo_r = _swap_edges(edge_l, edge_r, ranks, idx, group)
        kl, vl = halo_l.chunk(2, dim=-1)
        kr, vr = halo_r.chunk(2, dim=-1)
        return (torch.cat([kl, k, kr], dim=1).contiguous(),
                torch.cat([vl, v, vr], dim=1).contiguous())

    @staticmethod
    def backward(ctx, gk, gv):
        w, ranks, idx, group = ctx.args
        t = gk.shape[1] - 2 * w
        to_left = torch.cat([gk[:, :w], gv[:, :w]], dim=-1)
        to_right = torch.cat([gk[:, w + t:], gv[:, w + t:]], dim=-1)
        for_left_edge, for_right_edge = _swap_edges(to_left, to_right, ranks, idx, group)
        dk, dv = gk[:, w:w + t].clone(), gv[:, w:w + t].clone()
        gl_k, gl_v = for_left_edge.chunk(2, dim=-1)
        gr_k, gr_v = for_right_edge.chunk(2, dim=-1)
        dk[:, :w] += gl_k
        dv[:, :w] += gl_v
        dk[:, t - w:] += gr_k
        dv[:, t - w:] += gr_v
        return dk, dv, None, None, None, None


def seq_sharded_local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias_vec: Optional[torch.Tensor], window: int, heads: int,
                                mesh, axis: str = "seq",
                                force_stripe: bool = False) -> torch.Tensor:
    """Windowed attention with the frame axis sharded over ``mesh``'s
    ``axis``: the counterpart of ``dawn_tpu/ops/local_attention.py::
    seq_sharded_local_attention`` for one rank.

    q, k, v: this rank's (N, t_loc, H*D) frames in the packed layout, q
    pre-scaled and rotary-rotated at the global frame positions. Each rank
    sends the w edge rows of its k and v to both neighbours (one batch of
    P2P operations on the axis's process group; zeros at the global edges),
    then runs K5 on its t_loc queries over the t_loc + 2w haloed keys, the
    first rank with the left halo masked and the last with the right.
    Differentiable: K6 is the stripe's backward, and the exchange's backward
    sends the halo rows' gradients back to their owners.

    The axis must have more than one rank, or ``force_stripe`` must be set:
    one shard is ``TemporalAttention``'s own dispatch (K1 or K3), where the
    JAX function short-circuits. ``force_stripe=True`` runs the exchange
    and the stripe on one shard: with no neighbour both halos are zeros and
    both edge masks apply, the program of an edge rank on a whole video
    (``dawn_tpu/ops/local_attention.py:654-661``)."""
    n_sh = mesh.shape[axis]
    assert n_sh > 1 or force_stripe, (
        f"one '{axis}' shard without force_stripe: attend with K1 or K3 directly")
    t_loc = q.shape[1]
    assert t_loc >= window, (
        f"seq shard of {t_loc} frames cannot cover the ±{window} window; "
        f"use fewer 'seq' shards")
    idx = mesh.index(axis)
    kx, vx = _HaloExchange.apply(k, v, window, mesh.ranks(axis), idx, mesh.group(axis))
    return local_attention_packed_stripe(q.contiguous(), kx, vx, bias_vec, window, heads,
                                         idx == 0, idx == n_sh - 1)
