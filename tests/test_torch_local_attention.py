"""Windowed temporal attention of the port against dawn_tpu on the CPU.

The port's plain packed form (what K1 computes, and what a CPU tensor runs)
and its banded form are held against the JAX package's Pallas packed kernel
in interpret mode, on the cases of
tests/test_local_attention.py::TestPackedKernel, and against its banded XLA
form on the main-path case (T=200, w=40), at atol 1e-5; the JAX package's
own tests hold its two forms together on every case. The port's
TemporalAttention block, in 'local' and 'full' modes, is held against the
JAX module with weights carried by the bridge, and in 'local' mode also at
T=260, past K1's range. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against the plain form there).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.dm.unet3d import PreNormResidualTemporal
from dawn_tpu.ops.local_attention import local_attention_banded as jax_banded
from dawn_tpu.ops.local_attention import local_attention_packed as jax_packed
from dawn_tpu.ops.t5bias import t5_bias_matrix, t5_bias_windowed_vector, window_mask
from dawn_tpu_torch.models.dm.unet3d import (PreNorm, Residual, TemporalAttention,
                                             ToTokens)
from dawn_tpu_torch.ops.local_attention import (local_attention_banded,
                                                local_attention_packed,
                                                local_attention_packed_plain)
from dawn_tpu_torch.weights.jax_bridge import attention_block_state_dict, load_state
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

# (n, heads, T, dh, window, with T5 bias): T=200/w=40 (the main path), odd
# T=77, the query-chunk boundaries of the packed TPU kernel near 128 +- w,
# and no bias
CASES = [(1, 8, 200, 32, 40, True), (1, 4, 77, 32, 20, True),
         (1, 4, 160, 32, 40, True), (1, 4, 136, 32, 20, True),
         (1, 4, 256, 32, 40, True), (1, 2, 50, 16, 10, False)]


def _inputs(n, h, t, d, bias):
    rng = np.random.RandomState(7 + n * 131 + h * 17 + t + d)
    q = rng.randn(n, h, t, d).astype(np.float32) * d ** -0.5
    k = rng.randn(n, h, t, d).astype(np.float32)
    v = rng.randn(n, h, t, d).astype(np.float32)
    emb = rng.randn(32, h).astype(np.float32)
    return q, k, v, (emb if bias else None)


def _pack(x):                       # (n, h, t, d) -> (n, t, h*d)
    n, h, t, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(n, t, h * d)


@pytest.mark.parametrize("n,h,t,d,w,bias", CASES)
def test_packed_and_banded_match_jax(n, h, t, d, w, bias):
    q, k, v, emb = _inputs(n, h, t, d, bias)
    vec = None if emb is None else np.asarray(t5_bias_windowed_vector(emb, w, 32, 32))
    ref_packed = np.asarray(jax.jit(lambda *a: jax_packed(*a, w, heads=h, interpret=True))(
        _pack(q), _pack(k), _pack(v), vec))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tvec = None if vec is None else torch.from_numpy(vec)
    packed = local_attention_packed_plain(*map(torch.from_numpy, map(_pack, (q, k, v))),
                                          tvec, w, h)
    np.testing.assert_allclose(packed.numpy(), ref_packed, atol=1e-5, rtol=0)
    # on a CPU tensor the K1 wrapper is its plain version, with no launch
    launches = local_attention_packed.launches
    np.testing.assert_array_equal(
        local_attention_packed(*map(torch.from_numpy, map(_pack, (q, k, v))), tvec, w, h),
        packed)
    assert local_attention_packed.launches == launches
    banded = local_attention_banded(tq, tk, tv, tvec, w)
    np.testing.assert_allclose(_pack(banded.numpy()), ref_packed, atol=1e-5, rtol=0)
    if (t, w) == (200, 40):
        ref_banded = jax.jit(lambda *a: jax_banded(*a, w))(q, k, v, vec)
        np.testing.assert_allclose(banded.numpy(), np.asarray(ref_banded), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def temporal_block():
    """A JAX PreNormResidualTemporal (C=64, 8 heads x 32) and its params."""
    c, heads, dh, w, t = 64, 8, 32, 6, 24
    mod = PreNormResidualTemporal(heads, dh, "local", w)
    x = np.random.RandomState(1).randn(1, t, 3, 4, c).astype(np.float32)
    emb = np.random.RandomState(2).randn(32, heads).astype(np.float32)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x, None,
                            t5_bias_windowed_vector(emb, w, 32, 32))
    return mod, random_tree(shapes, 3), x, emb, (c, heads, dh, w, t)


@pytest.mark.parametrize("mode,long_t", [pytest.param("local", None, id="local"),
                                         pytest.param("full", None, id="full"),
                                         pytest.param("local", 260, id="local-T260")])
def test_temporal_attention_matches_jax(temporal_block, mode, long_t):
    """The block at T=24 (K1's packed route in 'local' mode) and at T=260,
    past the packed range, where both packages split heads and take their
    (N, H, T, D) local_attention (the banded form on the CPU; K3 on the card)."""
    mod, params, x, emb, (c, heads, dh, w, t) = temporal_block
    if long_t is not None:
        t = long_t
        x = np.random.RandomState(4).randn(1, t, 2, 2, c).astype(np.float32)
    vec = t5_bias_windowed_vector(emb, w, 32, 32)
    pos_bias = (t5_bias_matrix(emb, t, 32, 32) + jnp.asarray(window_mask(t, w)))[None, None]
    jmod = mod.clone(mode=mode)
    ref = (jax.jit(jmod.apply)(params, x, None, vec) if mode == "local"
           else jax.jit(jmod.apply)(params, x, pos_bias, None))

    port = Residual(PreNorm(c, ToTokens(
        TemporalAttention(c, heads, dh, mode, w, torch.float32), "time")))
    load_state(port, attention_block_state_dict(params["params"]))
    args = ((torch.from_numpy(np.array(pos_bias)), None) if mode == "full"
            else (None, torch.from_numpy(np.array(vec))))
    with torch.no_grad():
        got = port(torch.from_numpy(x), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
