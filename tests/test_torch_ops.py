"""dawn_tpu_torch.ops against their dawn_tpu twins on the CPU.

Same numpy inputs on both sides; float32; atol 1e-6 unless a case says why
it is looser.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.ops import convs as jconvs
from dawn_tpu.ops import norms as jnorms
from dawn_tpu.ops import quantile as jquantile
from dawn_tpu.ops import resample as jresample
from dawn_tpu.ops import rotary as jrotary
from dawn_tpu.ops import schedule as jschedule
from dawn_tpu.ops import t5bias as jt5
from dawn_tpu.models.dm.unet3d import VideoGroupNorm
from dawn_tpu.models.lfg import warp as jwarp
from dawn_tpu_torch.models.lfg import warp
from dawn_tpu_torch.ops import convs, norms, quantile, resample, rotary, schedule, t5bias
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jit(fn, *args, **static):
    """The JAX reference, jitted: one compile instead of one per eager op."""
    return jax.jit(lambda *a: fn(*a, **static))(*args)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def case_t5bias(rng):
    emb = rng.randn(32, 4).astype(np.float32)
    rel = np.arange(-300, 301)
    np.testing.assert_array_equal(t5bias.relative_position_bucket(rel, 32, 32),
                                  jt5.relative_position_bucket(rel, 32, 32))
    _close(t5bias.t5_bias_matrix(_t(emb), 50, 32, 32), jt5.t5_bias_matrix(emb, 50, 32, 32))
    _close(t5bias.window_mask(50, 7), jt5.window_mask(50, 7))
    _close(t5bias.t5_bias_windowed_vector(_t(emb), 40, 32, 32),
           jt5.t5_bias_windowed_vector(emb, 40, 32, 32))


def case_rotary(rng):
    for rot_dim, d in ((32, 32), (8, 16)):      # full and partial rotation
        x = rng.randn(3, 4, 20, d).astype(np.float32)
        jc, js = jrotary.rotary_cos_sin(20, rot_dim)
        c, s = rotary.rotary_cos_sin(20, rot_dim)
        _close(c, jc)
        _close(rotary.apply_rotary(_t(x), c, s), jrotary.apply_rotary(x, jc, js))


def case_norms(rng):
    x = rng.randn(2, 5, 6, 6, 16).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    # f32 mean/variance of 16 channels, summed in another order
    _close(norms.channel_layer_norm(_t(x), _t(gamma)),
           jnorms.channel_layer_norm(x, gamma), atol=2e-6)
    scale, bias = (1 + 0.1 * rng.randn(16)).astype(np.float32), rng.randn(16).astype(np.float32)
    ref = _jit(VideoGroupNorm(4).apply, {"params": {"scale": scale, "bias": bias}}, x)
    _close(norms.video_group_norm(_t(x), 4, _t(scale), _t(bias)), ref, atol=2e-6)


def case_schedule(rng):
    ref, got = jschedule.diffusion_buffers(1000), schedule.diffusion_buffers(1000)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for steps in (2, 20, 25):
        assert schedule.ddim_times(1000, steps) == jschedule.ddim_times(1000, steps)


def case_quantile(rng):
    x = np.abs(rng.randn(3, 1001)).astype(np.float32)
    x[1, 17] = np.nan                              # a NaN row must stay NaN
    for q in (0.9, 0.5, 1.0, 0.0):                 # interpolated and exact ranks
        ref = np.asarray(_jit(jquantile.quantile_nonneg, jnp.asarray(x), q=q))
        got = quantile.quantile_nonneg(_t(x), q).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert np.isnan(got[1])
        _close(got[~np.isnan(ref)], ref[~np.isnan(ref)])


def case_conv_transpose(rng):
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    w_flipped = rng.randn(4, 4, 8, 3).astype(np.float32)     # pre-flipped HWIO
    b = rng.randn(3).astype(np.float32)
    ref = jconvs.conv_transpose2d_torch(x, w_flipped, b, stride=2, padding=1)
    # f32 convolutions of 128 terms, summed in another order
    _close(convs.conv_transpose2d_torch(_t(x), w_flipped, _t(b)), ref, atol=1e-5)


def case_grid_sample(rng):
    img = rng.randn(2, 9, 11, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    _close(resample.grid_sample(_t(img), _t(grid)), _jit(jresample.grid_sample, img, grid))


def case_grid_sample_shared(rng):
    img = rng.randn(2, 9, 11, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 4, 5, 7, 2)).astype(np.float32)
    got = resample.grid_sample_shared(_t(img), _t(grid))
    # torch and the JAX package form the bilinear weights in another order:
    # a few f32 ulps of the |img| <= 4 values
    _close(got, _jit(jresample.grid_sample_shared, img, grid), atol=2e-6)
    # the same as broadcasting the source over T
    bcast = np.repeat(img, 4, axis=0)
    _close(got.reshape(8, 5, 7, 3),
           _jit(jresample.grid_sample, bcast, grid.reshape(8, 5, 7, 2)), atol=2e-6)


def case_interpolate(rng):
    img = rng.randn(2, 8, 8, 3).astype(np.float32)
    _close(resample.interpolate_bilinear(_t(img), 32, 32),
           _jit(jresample.interpolate_bilinear, img, out_h=32, out_w=32))
    _close(resample.interpolate_nearest(_t(img), 16, 16),
           _jit(jresample.interpolate_nearest, img, out_h=16, out_w=16))
    _close(resample.avg_pool_2x2(_t(img)), _jit(jresample.avg_pool_2x2, img))


def case_warp(rng):
    _close(warp.make_coordinate_grid(6, 9), jwarp.make_coordinate_grid(6, 9))
    img = rng.randn(2, 16, 16, 3).astype(np.float32)
    flow = rng.uniform(-1.1, 1.1, (2, 3, 4, 4, 2)).astype(np.float32)
    occ = rng.rand(2, 3, 4, 4, 1).astype(np.float32)
    prev = rng.randn(6, 16, 16, 3).astype(np.float32)
    # the flows are resized 4 -> 16 first (JAX: an einsum with interpolation
    # weights; torch: interpolate), so sample positions differ by ~1e-7 and
    # the random image's gradients (up to ~50 per grid unit) scale that up
    _close(warp.deform_input(_t(img), _t(flow[:, 0])),
           _jit(jwarp.deform_input, img, flow[:, 0]), atol=1e-5)
    _close(warp.apply_optical_shared(_t(img), _t(flow), _t(occ), _t(prev)),
           _jit(jwarp.apply_optical_shared, img, flow, occ, prev), atol=1e-5)


CASES = {f.__name__[5:]: f for f in (
    case_t5bias, case_rotary, case_norms, case_schedule, case_quantile,
    case_conv_transpose, case_grid_sample, case_grid_sample_shared, case_interpolate,
    case_warp)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    CASES[name](np.random.RandomState(sorted(CASES).index(name)))
