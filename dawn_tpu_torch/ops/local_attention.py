"""Windowed (local) temporal attention: plain PyTorch forms and kernel K1.

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
  kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e9
PACKED_MAX_T = 256       # K1 covers T <= 256 (the TPU kernel's range)


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


def local_attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_vec: Optional[torch.Tensor], window: int,
                           block_q: int = 128) -> torch.Tensor:
    """Banded local attention, (N, H, T, D) -> (N, H, T, D).

    Queries go in blocks of ``bq``; block b attends the key stripe of
    ``bq + 2*window`` frames starting at b*bq - window (zero-padded), so the
    scores take O(T * (bq + 2w)) memory."""
    n, h, t, d = q.shape
    bq = min(block_q, max(8, t))
    nb = -(-t // bq)
    t_pad = nb * bq
    kw = bq + 2 * window
    f32 = torch.float32
    qp = torch.nn.functional.pad(q.to(f32), (0, 0, 0, t_pad - t))
    kp = torch.nn.functional.pad(k.to(f32), (0, 0, window, t_pad - t + window))
    vp = torch.nn.functional.pad(v.to(f32), (0, 0, window, t_pad - t + window))
    qb = qp.reshape(n, h, nb, bq, d)
    stripes_k = kp.unfold(2, kw, bq).transpose(-1, -2)        # (n, h, nb, kw, d)
    stripes_v = vp.unfold(2, kw, bq).transpose(-1, -2)
    scores = torch.einsum("nhbid,nhbjd->nhbij", qb, stripes_k)

    rel = (np.arange(kw)[None, :] - window) - np.arange(bq)[:, None]   # (bq, kw)
    band = torch.from_numpy(np.where(np.abs(rel) <= window, 0.0, NEG_INF)
                            .astype(np.float32)).to(q.device)
    if bias_vec is None:
        bias = band[None]
    else:
        idx = torch.from_numpy(np.clip(rel + window, 0, 2 * window)).to(q.device)
        bias = bias_vec.float()[:, idx] + band[None]                   # (h, bq, kw)
    jg = (np.arange(nb)[:, None] * bq - window) + np.arange(kw)[None, :]
    key_valid = torch.from_numpy(np.where((jg >= 0) & (jg < t), 0.0, NEG_INF)
                                 .astype(np.float32)).to(q.device)    # (nb, kw)
    scores = scores + bias[None, :, None] + key_valid[None, None, :, None, :]
    scores = scores - scores.amax(dim=-1, keepdim=True)
    attn = torch.softmax(scores, dim=-1)
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


_DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


def _k1_library() -> ctypes.CDLL:
    from dawn_tpu_torch import build
    lib = build.load("local_attention")
    fn = lib.dawn_local_attn_packed_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def local_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_vec: Optional[torch.Tensor], window: int,
                           heads: int) -> torch.Tensor:
    """K1: windowed attention on the packed (N, T, H*D) layout.

    A CUDA tensor launches the CUDA kernel (T <= 256, D = 32, f32 or bf16,
    contiguous inputs) or raises; a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return local_attention_packed_plain(q, k, v, bias_vec, window, heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n, t, hd = q.shape
    if t > PACKED_MAX_T:
        raise NotImplementedError(
            f"T={t} > {PACKED_MAX_T} needs the tiled kernel K3 "
            "(dawn_tpu/ops/local_attention.py::local_attention_pallas), "
            "not yet ported")
    if q.dtype not in _DTYPE_FLAG:
        raise TypeError(f"K1 takes float32 or bfloat16, got {q.dtype}")
    if hd % heads or hd // heads != 32:
        raise ValueError(f"K1 is built for dim_head 32, got {hd}/{heads}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} {x.device} does "
                             f"not match q {tuple(q.shape)} {q.dtype} {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K1 needs contiguous q, k, v")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if bias_vec is not None:
        if (bias_vec.shape != (heads, 2 * window + 1) or bias_vec.dtype != torch.float32
                or bias_vec.device != q.device or not bias_vec.is_contiguous()):
            raise ValueError(f"bias_vec must be contiguous f32 ({heads}, "
                             f"{2 * window + 1}) on {q.device}, got "
                             f"{tuple(bias_vec.shape)} {bias_vec.dtype} {bias_vec.device}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _k1_library()
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


local_attention_packed.launches = 0
