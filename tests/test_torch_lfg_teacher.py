"""The LFG teacher of the port against dawn_tpu on the CPU.

Tiny FlowAE (the topology of tests/test_trainers.py: generator 8/32 with one
bottleneck block, region/bg/flow predictors 4/16 with two hourglass blocks),
32x32 images, JAX variables from jax.eval_shape plus a seeded numpy fill,
carried to the port by dawn_tpu_torch.weights.jax_bridge. The region,
background and pixelwise-flow predictors and FlowAE.teacher_outputs are held
against the JAX modules at atol 1e-4 (f32; the region softmax runs at
temperature 0.1, which scales rounding by 10). The closed-form 2x2 SVD is
held against jnp.linalg.svd (LAPACK sgesdd on the CPU) on 20,000 random
covariances and on edge cases: U to atol 1e-5, so the column signs agree
everywhere.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.lfg.flow_ae import FlowAE as JaxFlowAE
from dawn_tpu.models.lfg.warp import anti_alias_downsample as jax_downsample
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.models.lfg.region_predictor import svd2x2
from dawn_tpu_torch.models.lfg.warp import anti_alias_downsample
from dawn_tpu_torch.weights.jax_bridge import load_flow_ae_variables
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

TINY = dict(generator_kw=dict(block_expansion=8, max_features=32, num_bottleneck_blocks=1),
            region_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            bg_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            flow_kw=dict(block_expansion=4, max_features=16, num_blocks=2))
B, T, S = 2, 3, 32
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jae = JaxFlowAE(**TINY)
    shapes = jax.eval_shape(functools.partial(jae.init_variables, img_size=S),
                            jax.random.PRNGKey(0))
    variables = random_tree(shapes, 11)
    port = FlowAE(**TINY).eval()
    load_flow_ae_variables(port, variables)
    rng = np.random.RandomState(4)
    ref = rng.rand(B, S, S, 3).astype(np.float32)
    video = rng.rand(B, T, S, S, 3).astype(np.float32)
    return jae, variables, port, ref, video


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0,
                               err_msg=what)


def test_region_and_bg_predictors(pair):
    jae, variables, port, ref, video = pair
    drv = video[:, 0]
    want = jax.jit(jae.region_predictor.apply)(variables["region_predictor"], drv)
    want_bg = jax.jit(jae.bg_predictor.apply)(variables["bg_predictor"], ref, drv)
    with torch.no_grad():
        got = port.region_predictor(torch.from_numpy(drv))
        got_bg = port.bg_predictor(torch.from_numpy(ref), torch.from_numpy(drv))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)
    _close(got_bg, want_bg, "bg")


def test_pixelwise_flow_predictor(pair):
    """Fed the JAX region and bg parameters, so that only the flow predictor
    is under test; both source paths (downsampled here or by the caller)."""
    jae, variables, port, ref, video = pair
    drv = video[:, 1]
    rp = jax.jit(jae.region_predictor.apply)
    src_p, drv_p = rp(variables["region_predictor"], ref), rp(variables["region_predictor"], drv)
    bg = jax.jit(jae.bg_predictor.apply)(variables["bg_predictor"], ref, drv)
    fp = variables["pixelwise_flow_predictor"]
    small = jax_downsample(jnp.asarray(ref), 0.25)
    want = jax.jit(jae.flow_predictor.apply)(fp, ref, drv_p, src_p, bg)
    want_small = jax.jit(functools.partial(jae.flow_predictor.apply, source_downsampled=True))(
        fp, small, drv_p, src_p, bg)
    tt = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}  # noqa: E731
    with torch.no_grad():
        got = port.pixelwise_flow_predictor(torch.from_numpy(ref), tt(drv_p), tt(src_p),
                                            torch.from_numpy(np.array(bg)))
        got_small = port.pixelwise_flow_predictor(
            anti_alias_downsample(torch.from_numpy(ref), 0.25), tt(drv_p), tt(src_p),
            torch.from_numpy(np.array(bg)), source_downsampled=True)
    for k in ("optical_flow", "occlusion_map"):
        _close(got[k], want[k], k)
        _close(got_small[k], want_small[k], k + " (source downsampled)")


def test_teacher_outputs(pair):
    jae, variables, port, ref, video = pair
    want = jax.jit(jae.teacher_outputs)(variables, ref, video)
    with torch.no_grad():
        got = port.teacher_outputs(torch.from_numpy(ref), torch.from_numpy(video))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], k)


def test_svd2x2_signs_match_lapack():
    rng = np.random.RandomState(1)
    a = rng.randn(20000, 2, 2).astype(np.float32) * np.exp(rng.randn(20000, 1, 1)).astype(
        np.float32)
    c = a @ a.transpose(0, 2, 1)
    c[:6] = [np.diag([1.0, 2.0]), np.diag([2.0, 1.0]), np.eye(2), [[1, 0.5], [0.5, 1]],
             [[1, -0.5], [-0.5, 1]], [[0.3, 0.3], [0.3, 0.3]]]
    c[6:8] = [[[1, 1e-9], [1e-9, 2]], [[2, -1e-9], [-1e-9, 1]]]     # below the split threshold
    c = c.astype(np.float32)
    u, s, _ = map(np.asarray, jnp.linalg.svd(jnp.asarray(c)))
    tu, ts = (x.numpy() for x in svd2x2(torch.from_numpy(c)))
    np.testing.assert_allclose(tu, u, atol=1e-5, rtol=0)
    # singular values to 1e-5 of the larger one (the smaller one of a
    # nearly singular matrix comes out of a cancellation in both)
    assert (np.abs(ts - s) <= 1e-5 * s[:, :1]).all()


def test_reference_names_round_trip(pair, tmp_path):
    """The port's state_dicts read back through the JAX package's
    reference-checkpoint converters give the JAX variables bit for bit, and a
    reference-layout LFG checkpoint (flow predictor under the generator, plus
    the anti-alias kernels the port does not keep) loads into a fresh FlowAE."""
    from dawn_tpu.weights.torch_convert import (convert_bg_predictor, convert_lfg_generator,
                                                convert_region_predictor)
    from test_torch_util import leaves_with_paths
    _, variables, port, _, _ = pair
    gen = {**port.generator.state_dict(),
           **{f"pixelwise_flow_predictor.{k}": v
              for k, v in port.pixelwise_flow_predictor.state_dict().items()}}
    back = {"region_predictor": convert_region_predictor(port.region_predictor.state_dict(), 2),
            "bg_predictor": convert_bg_predictor(port.bg_predictor.state_dict(), 2),
            **convert_lfg_generator(gen, num_bottleneck=1, flow_predictor_blocks=2)}
    for part in variables:
        want, got = leaves_with_paths(variables[part]), leaves_with_paths(back[part])
        assert sorted(got) == sorted(want), part
        for path, leaf in want.items():
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=f"{part}/{path}")
    extra = {"pixelwise_flow_predictor.down.weight": torch.ones(3, 1, 5, 5)}
    path = str(tmp_path / "lfg.pth")
    torch.save({"generator": {**gen, **extra}, "region_predictor": {
        **port.region_predictor.state_dict(), "down.weight": torch.ones(3, 1, 5, 5)},
        "bg_predictor": port.bg_predictor.state_dict()}, path)
    fresh = FlowAE(**TINY)
    fresh.load_reference_checkpoint(path)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
