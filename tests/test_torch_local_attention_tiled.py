"""Windowed attention on the (N, H, T, D) layout for T > 256 (K3's and K4's
functions) against dawn_tpu on the CPU.

K3's plain version (``local_attention_banded``, reached through the port's
``local_attention`` dispatch on CPU tensors) is held against the JAX
package's tiled Pallas kernel ``local_attention_pallas`` in interpret mode;
K4's plain version ``local_attention_tiled_bwd_plain`` against its Pallas
backward ``_tiled_bwd_pallas`` in interpret mode and against the VJP of the
JAX banded form, for dq, dk, dv and the bias-vector gradient; the autograd
Function ``LocalAttentionTiled`` on CPU tensors (plain forward, plain
backward, no kernel launch) against torch.autograd of the banded form. All
in f32 at atol 1e-5 (dvec: 1e-4, a sum over every query of every
sequence, as in tests/test_torch_attention_grad.py). Two bf16 cases on
cancelling inputs (``test_torch_util.cancelling_inputs``) hold K3's and K4's
plain versions against the Pallas kernels in bf16 at one bf16 ulp of each
entry plus 2^-14 of the largest (``assert_bf16_close``): they round the
normalised P, and P and dS, where the kernels do. K4's dk and dv take 2^-8
of their largest entry instead of 2^-14: the Pallas backward writes each
query tile's share of dk and dv in bf16 and adds up to three such shares in
bf16 (``_tiled_bwd_pallas``'s combine), where the port sums in f32 and
rounds once. In bf16 the JAX banded VJP, which rounds its scores instead,
is not a reference. The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions there).
"""

import numpy as np
import pytest
import torch
import jax

from dawn_tpu.ops.local_attention import _tiled_bwd_pallas
from dawn_tpu.ops.local_attention import local_attention_banded as jax_banded
from dawn_tpu.ops.local_attention import local_attention_pallas
from dawn_tpu.ops.t5bias import t5_bias_windowed_vector
from dawn_tpu_torch.ops.local_attention import (LocalAttentionTiled, local_attention,
                                                local_attention_banded,
                                                local_attention_tiled,
                                                local_attention_tiled_bwd,
                                                local_attention_tiled_bwd_plain)
import jax.numpy as jnp
from test_torch_util import (assert_bf16_close, cancelling_inputs,
                             one_torch_thread)  # noqa: F401 (autouse fixture)

# (n, heads, T, window, with T5 bias), D = 32: T just over the packed range
# (257), T not a multiple of the TPU tile, odd T, a window wider than a
# 64-row tile (w=70: the TPU kernel takes bq=128), no bias, and one tile
# holding the whole sequence (T=50 <= bq=64)
CASES = [(1, 4, 257, 20, True), (2, 2, 300, 40, True), (1, 4, 333, 70, True),
         (1, 8, 300, 40, False), (2, 4, 50, 40, True)]
# bf16 twins of the T=300, one-tile and w=70 cases, on cancelling inputs
BF16_CASES = [(1, 2, 300, 40, True), (2, 4, 50, 40, True), (1, 4, 333, 70, True)]
PARAMS = [pytest.param(*case, "float32", id="-".join(map(str, case))) for case in CASES] + [
    pytest.param(*case, "bfloat16", id="-".join(map(str, case)) + "-bf16")
    for case in BF16_CASES]
D = 32


def _inputs(n, h, t, w, bias, seed=0, cancelling=False):
    rng = np.random.RandomState(seed + n * 131 + h * 17 + t + w)
    if cancelling:
        q, k, v, g = cancelling_inputs(rng, (n, h, t, D), (n, h, t, D), row_axis=2)
    else:
        q = (rng.randn(n, h, t, D) * D ** -0.5).astype(np.float32)
        k, v, g = (rng.randn(n, h, t, D).astype(np.float32) for _ in range(3))
    vec = (np.asarray(t5_bias_windowed_vector(rng.randn(32, h).astype(np.float32), w, 32, 32))
           if bias else None)
    return q, k, v, g, vec


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _bf16(*xs):
    """(JAX, torch) bf16 twins of q, k, v (, g), then the f32 vector."""
    *xs, vec = xs
    return ([jnp.asarray(x).astype(jnp.bfloat16) for x in xs] + [vec],
            [torch.from_numpy(x).bfloat16() for x in xs] + _torch(vec))


@pytest.mark.parametrize("n,h,t,w,bias,dtype", PARAMS)
def test_forward_matches_pallas(n, h, t, w, bias, dtype):
    bf16 = dtype == "bfloat16"
    q, k, v, _, vec = _inputs(n, h, t, w, bias, cancelling=bf16)
    jx, tx = _bf16(q, k, v, vec) if bf16 else ((q, k, v, vec), _torch(q, k, v, vec))
    want = jax.jit(lambda *a: local_attention_pallas(*a, w, interpret=True))(*jx)
    launches = local_attention_tiled.launches
    got = local_attention(*tx, w)
    if bf16:
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # on a CPU tensor the K3 wrapper is its plain version, with no launch
    np.testing.assert_array_equal(local_attention_tiled(*tx, w).float().numpy(),
                                  got.float().numpy())
    assert local_attention_tiled.launches == launches


@pytest.mark.parametrize("n,h,t,w,bias,dtype", PARAMS)
def test_backward_matches_pallas_and_banded_vjp(n, h, t, w, bias, dtype):
    if dtype == "bfloat16":
        q, k, v, g, vec = _inputs(n, h, t, w, bias, cancelling=True)
        jx, tx = _bf16(q, k, v, g, vec)
        want = jax.jit(lambda *a: _tiled_bwd_pallas(*a, w, interpret=True))(*jx)
        got = local_attention_tiled_bwd(*tx, w)
        for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, want):
            assert_bf16_close(a, b, label, atol_of_max=2.0 ** -8 if label in ("dk", "dv")
                              else 2.0 ** -14)
        return
    q, k, v, g, vec = _inputs(n, h, t, w, bias)
    pallas = jax.jit(lambda *a: _tiled_bwd_pallas(*a, w, interpret=True))(q, k, v, g, vec)
    banded = jax.jit(lambda q, k, v, g, b: jax.vjp(
        lambda q, k, v, b: jax_banded(q, k, v, b, w), q, k, v, b)[1](g))(q, k, v, g, vec)
    launches = local_attention_tiled_bwd.launches
    got = local_attention_tiled_bwd(*_torch(q, k, v, g, vec), w)
    assert local_attention_tiled_bwd.launches == launches
    for want in (pallas, banded):
        for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, want):
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, err_msg=label,
                                       atol=1e-4 if label == "dvec" else 1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_autograd_function_on_cpu(bias):
    """LocalAttentionTiled on CPU tensors (plain forward and backward, no
    launch) against torch.autograd through the banded form."""
    n, h, t, w = 2, 2, 261, 30
    q, k, v, g, vec = _inputs(n, h, t, w, bias, seed=5)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, vec) if x is not None]
    args = leaves if bias else leaves + [None]
    launches = local_attention_tiled.launches, local_attention_tiled_bwd.launches
    out = LocalAttentionTiled.apply(*args, w)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    want = torch.autograd.grad(local_attention_banded(*args, w), leaves, torch.from_numpy(g))
    for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, err_msg=label,
                                   atol=1e-4 if label == "dvec" else 1e-5)
    assert (local_attention_tiled.launches, local_attention_tiled_bwd.launches) == launches
    np.testing.assert_array_equal(
        local_attention_tiled_bwd_plain(*_torch(q, k, v, g, vec), w)[0].numpy(), got[0].numpy())
