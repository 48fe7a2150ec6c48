"""The port's I3D FVD backbone against the JAX package's ``i3d_forward``.

The port's ``InceptionI3d`` at 1/8 of the released widths (50 classes, as
``tests/test_i3d.py`` runs the JAX side), random weights and BatchNorm
statistics, is saved with ``torch.save`` and read back by ``load_i3d``
(strict); the JAX package's ``convert_i3d`` reads the port's
``state_dict()``. On a 224^2, T = 10 video both give the same 1024/8
features and 50 logits within 2e-4; ``preprocess_videos`` resizes 128^2
and 256^2 videos to 224^2 as ``jax.image.resize``'s antialiased bilinear
does (within 1e-5); ``fvd_i3d`` of a set against itself is below 1e-4;
``load_i3d`` unwraps a ``state_dict`` entry, takes a file without
``num_batches_tracked`` and refuses one that lacks a weight.
"""

import numpy as np
import pytest
import torch
import jax

from conftest import randomize_bn_stats
from dawn_tpu.evaluate import i3d as jax_i3d
from dawn_tpu.weights.i3d_convert import convert_i3d
from dawn_tpu_torch.evaluate.i3d import InceptionI3d, fvd_i3d, preprocess_videos
from dawn_tpu_torch.weights.i3d_convert import load_i3d
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

DIV = 8


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    torch.manual_seed(0)
    net = randomize_bn_stats(InceptionI3d(400 // DIV, width_divisor=DIV), seed=4)
    path = str(tmp_path_factory.mktemp("i3d") / "i3d_eighth.pt")
    torch.save(net.state_dict(), path)
    return load_i3d(path, device="cpu"), convert_i3d(net.state_dict())


@pytest.mark.parametrize("features", [True, False])
def test_i3d_matches_jax(nets, features):
    model, params = nets
    vid = np.random.RandomState(int(features)).rand(1, 10, 224, 224, 3).astype(np.float32) * 2 - 1
    with torch.no_grad():
        got = model(torch.from_numpy(vid), features=features).numpy()
    want = np.asarray(jax.jit(lambda v: jax_i3d.i3d_forward(params, v, features=features))(vid))
    assert got.shape == want.shape == (1, 1024 // DIV if features else 400 // DIV)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("size", [128, 256])
def test_preprocess_matches_jax(size):
    vids = np.random.RandomState(size).rand(2, 3, size, size, 3).astype(np.float32)
    got = preprocess_videos(vids, device="cpu").numpy()
    want = np.asarray(jax_i3d.preprocess_videos(vids))
    assert got.shape == want.shape == (2, 3, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fvd_self_distance(nets):
    model, _ = nets
    real = np.random.RandomState(2).rand(4, 10, 64, 64, 3).astype(np.float32)
    assert abs(fvd_i3d(model, real, real.copy(), batch=2)) < 1e-4


def test_load_i3d_layouts(nets, tmp_path):
    model, _ = nets
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    wrapped = load_i3d({"state_dict": sd}, device="cpu")
    assert wrapped.logits.conv3d.weight.shape == (400 // DIV, 1024 // DIV, 1, 1, 1)
    for k, v in wrapped.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, model.state_dict()[k]), k
    del sd["Mixed_4d.b2b.conv3d.weight"]
    torch.save(sd, tmp_path / "broken.pt")
    with pytest.raises(RuntimeError, match="Mixed_4d.b2b.conv3d.weight"):
        load_i3d(str(tmp_path / "broken.pt"), device="cpu")
