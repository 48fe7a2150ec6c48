"""The port's ST-GCN recognizer and its evaluation against the JAX package's.

- ``build_graph`` (copied numpy) equals JAX's for every built-in layout and
  every strategy, for an explicit edge list, and with max_hop 2 / dilation 2.
- ``STGCN``: the port's module (random weights, BatchNorm statistics and
  edge importances) goes to JAX through the JAX package's own
  ``convert_stgcn(port.state_dict())``; features and logits agree within
  1e-5 of the largest magnitude through both stride-2 blocks, on
  'dawn_head' (V=8, C=1) at T = 16 and on 'openpose' (V=18, C=3) at T = 17.
- ``STGCNEvaluation`` gives JAX's metrics on the same weights (rtol 1e-4;
  the FIDs of a set against itself, which the eps retry leaves near 0,
  within 1e-4).
- ``load_stgcn`` reads a ``torch.save``d reference-layout dict strictly,
  with and without edge importances, and refuses a wrong C, a wrong class
  count and a missing entry; ``make_dawn_head_stgcn`` gives the same
  weights for the same seed.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import randomize_bn_stats
from dawn_tpu.evaluate.stgcn_eval import STGCNEvaluation as JaxEvaluation
from dawn_tpu.models.pbnet import stgcn as jax_stgcn
from dawn_tpu.weights.torch_convert import convert_stgcn
from dawn_tpu_torch.evaluate.stgcn_eval import (STGCNEvaluation, compute_features, load_stgcn,
                                                make_dawn_head_stgcn)
from dawn_tpu_torch.models.pbnet.stgcn import STGCN, build_graph
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

LAYOUTS = {"dawn_head": (8, 1), "openpose": (18, 3)}


@pytest.mark.parametrize("strategy", ["uniform", "distance", "spatial"])
@pytest.mark.parametrize("layout", ["openpose", "ntu-rgb+d", "ntu_edge", "dawn_head"])
def test_build_graph_matches_jax(layout, strategy):
    ours = build_graph(layout, strategy)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_stgcn.build_graph(layout, strategy))


def test_build_graph_edges_hops_dilation():
    spec = jax_stgcn._LAYOUTS["ntu_edge"]
    kw = dict(edges=spec["neighbors"], num_node=spec["num_node"], center=spec["center"])
    for extra in ({}, dict(max_hop=2), dict(max_hop=2, dilation=2)):
        for strategy in ("distance", "spatial"):
            np.testing.assert_array_equal(build_graph(strategy=strategy, **kw, **extra),
                                          jax_stgcn.build_graph(strategy=strategy, **kw,
                                                                **extra))


def _port_model(layout, num_class=5, seed=0, edge_importance=True):
    v, c = LAYOUTS[layout]
    torch.manual_seed(seed)
    model = STGCN(c, num_class, build_graph(layout, "spatial"),
                  edge_importance_weighting=edge_importance)
    randomize_bn_stats(model, seed + 1)
    with torch.no_grad():
        for p in getattr(model, "edge_importance", []):
            p.uniform_(0.5, 1.5)
    return model.eval()


def _jax_apply(model, x):
    cv = convert_stgcn(model.state_dict())
    jm = jax_stgcn.STGCN(in_channels=model.in_channels, num_class=model.num_class,
                         graph=cv["graph"],
                         edge_importance_weighting=model.edge_importance_weighting)
    out = jax.jit(jm.apply)({"params": cv["params"], "batch_stats": cv["batch_stats"]},
                            jnp.asarray(x))
    return np.asarray(out["features"]), np.asarray(out["yhat"])


@pytest.fixture(scope="module")
def models():
    return {layout: _port_model(layout) for layout in LAYOUTS}


@pytest.mark.parametrize("layout,t", [("dawn_head", 16), ("openpose", 17)])
def test_stgcn_matches_jax(models, layout, t):
    model = models[layout]
    v, c = LAYOUTS[layout]
    x = np.random.RandomState(t).randn(3, t, v, c).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    feats, logits = _jax_apply(model, x)
    assert out["features"].shape == (3, 256) and out["yhat"].shape == (3, 5)
    for got, want in ((out["features"].numpy(), feats), (out["yhat"].numpy(), logits)):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-5, (layout, t, err)


def test_evaluation_matches_jax(models):
    model = models["dawn_head"]
    cv = convert_stgcn(model.state_dict())
    jm = jax_stgcn.STGCN(in_channels=1, num_class=5, graph=cv["graph"])
    rng = np.random.RandomState(5)

    def loader(scale):
        return (rng.randn(12, 16, 8, 1) * scale).astype(np.float32), np.arange(12) % 5

    loaders = {"gt": {"train": loader(1.0), "test": loader(1.0)},
               "gen": {"train": loader(3.0), "test": loader(3.0)}}
    ours = STGCNEvaluation(model, 5, seed=0, batch_size=8).evaluate(loaders)
    theirs = JaxEvaluation(jm, {"params": cv["params"], "batch_stats": cv["batch_stats"]}, 5,
                           seed=0, batch_size=8).evaluate(loaders)
    assert sorted(ours) == sorted(theirs) and len(ours) == 16
    for k, want in theirs.items():
        if k.startswith("fid_gt"):
            assert abs(ours[k]) < 1e-4 and abs(want) < 1e-4, (k, ours[k], want)
        else:
            np.testing.assert_allclose(ours[k], want, rtol=1e-4, err_msg=k)
    assert ours["fid_gen_test"] > 1e-3


@pytest.mark.parametrize("edge_importance", [True, False])
def test_load_stgcn_reference_layout(tmp_path, edge_importance):
    model = _port_model("openpose", num_class=7, seed=3, edge_importance=edge_importance)
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    path = str(tmp_path / "recognizer.tar")
    torch.save(sd, path)
    loaded = load_stgcn(path, device="cpu")
    assert (loaded.in_channels, loaded.num_class) == (3, 7)
    assert loaded.edge_importance_weighting == edge_importance
    x = np.random.RandomState(0).randn(2, 16, 18, 3).astype(np.float32)
    f1, y1 = compute_features(model, x)
    f2, y2 = compute_features(loaded, x)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(y1, y2)
    assert load_stgcn(path, in_channels=3, num_class=7, device="cpu").num_class == 7
    with pytest.raises(ValueError, match="does not match C=3"):
        load_stgcn(path, in_channels=6, device="cpu")
    with pytest.raises(ValueError, match="checkpoint has 7 classes"):
        load_stgcn(path, num_class=4, device="cpu")
    del sd["st_gcn_networks.3.tcn.2.weight"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="st_gcn_networks.3.tcn.2.weight"):
        load_stgcn(path, device="cpu")


def test_dawn_head_recognizer_is_seeded():
    a = make_dawn_head_stgcn(4, torch.Generator().manual_seed(1234), device="cpu")
    b = make_dawn_head_stgcn(4, torch.Generator().manual_seed(1234), device="cpu")
    c = make_dawn_head_stgcn(4, torch.Generator().manual_seed(1), device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.fcn.weight, c.fcn.weight)
    motions = np.random.RandomState(1).randn(5, 20, 8, 1).astype(np.float32)
    feats, logits = compute_features(a, motions, batch_size=4)
    assert feats.shape == (5, 256) and logits.shape == (5, 4)
    assert np.isfinite(feats).all() and np.isfinite(logits).all() and feats.std() > 0
