"""The pieces of the port's LFG trainer against dawn_tpu on the CPU (the
step itself: tests/test_torch_train_lfg_step.py).

- the random warp, its closed-form Jacobian against jax.jacfwd, and the
  gradient through that Jacobian (a second derivative of the warp): atol
  1e-6, the gradient rtol 1e-4;
- the milestone schedule against optax.piecewise_constant_schedule at
  boundary - 1, boundary and boundary + 1;
- ``augment_frame_pair`` bit for bit for the same RandomState;
- the VGG19 bridge (``vgg19_state_dict``) and a torchvision-layout file;
- train-mode BatchNorm against the JAX package's SyncBatchNorm (output,
  running statistics with the unbiased variance; atol 1e-5 and 1e-6);
- the LFG's eval users: a FlowAE built without ``train_bn`` gives the same
  bits in ``.train()`` and ``.eval()`` mode, and a teacher pass leaves its
  running statistics where they were.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.lfg.blocks import SyncBatchNorm
from dawn_tpu.models.lfg.vgg import Vgg19Features as JaxVgg
from dawn_tpu.train.augment import augment_frame_pair as jax_augment
from dawn_tpu.train.train_lfg import tps_warp_coordinates as jax_warp
from dawn_tpu_torch.models.lfg.blocks import BatchNorm
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.models.lfg.vgg import Vgg19Features
from dawn_tpu_torch.train.augment import augment_frame_pair
from dawn_tpu_torch.train.train_lfg import (LFGTrainConfig, LFGTrainer, milestone_factor,
                                            random_tps_params, tps_jacobian,
                                            tps_warp_coordinates)
from dawn_tpu_torch.weights.jax_bridge import vgg19_state_dict
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

TINY = dict(generator_kw=dict(block_expansion=8, max_features=32, num_bottleneck_blocks=1),
            region_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            bg_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            flow_kw=dict(block_expansion=4, max_features=16, num_blocks=2))
S, LR = 32, 2e-4


def jax_tps_draws(rng, b, points=5):
    """The standard normals of random_tps_params for key ``rng``."""
    r1, r2, _ = jax.random.split(rng, 3)
    return {"affine": np.asarray(jax.random.normal(r1, (b, 2, 3))),
            "tps": np.asarray(jax.random.normal(r2, (b, 1, points ** 2)))}


def test_tps_warp_and_jacobian_match_jax():
    """The warp, its closed-form Jacobian against jax.jacfwd at the region
    centres (as LFGTrainer.loss_fn takes it), and the gradient of a weighted
    sum of the Jacobian with respect to the centres (the second derivative
    of the warp that the affine equivariance's gradient carries)."""
    b, r = 2, 10
    draws = jax_tps_draws(jax.random.PRNGKey(3), b)
    theta, cp, cw = random_tps_params(b, 0.05, 0.005, 5, draws=draws)
    rng = np.random.RandomState(8)
    pts = rng.uniform(-0.9, 0.9, (b, r, 2)).astype(np.float32)
    wts = rng.randn(b, r, 2, 2).astype(np.float32)
    jt, jcp, jcw = (jnp.asarray(x.numpy()) for x in (theta, cp, cw))

    def jac_jax(points):
        def f(c, th, cwts):
            return jax_warp(c[None, None], th[None], jcp, cwts[None])[0, 0]
        return jax.vmap(lambda p, th, cwts: jax.vmap(
            lambda q: jax.jacfwd(lambda u: f(u, th, cwts))(q))(p))(points, jt, jcw)

    want_warp = jax_warp(jnp.asarray(pts), jt, jcp, jcw)
    want_jac = jax.jit(jac_jax)(jnp.asarray(pts))
    want_grad = jax.jit(jax.grad(lambda p: jnp.sum(jac_jax(p) * wts)))(jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_()
    got_warp = tps_warp_coordinates(x, theta, cp, cw)
    got_jac = tps_jacobian(x, theta, cp, cw)
    (got_jac * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(got_warp.detach().numpy(), want_warp, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_jac.detach().numpy(), want_jac, atol=1e-6, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("boundary", [6, 9])
def test_milestone_schedule_matches_optax(boundary):
    """Milestones (2, 3) at 3 steps an epoch: the rate at boundary - 1,
    boundary and boundary + 1 against optax.piecewise_constant_schedule,
    as the trainer's schedule gives it for the update at that count."""
    cfg = LFGTrainConfig(lr=LR, epoch_milestones=(2, 3), steps_per_epoch=3)
    sched = optax.piecewise_constant_schedule(LR, {6: 0.1, 9: 0.1})
    trainer = LFGTrainer(cfg, flow_ae=FlowAE(**TINY), device="cpu")
    for count in (boundary - 1, boundary, boundary + 1):
        want = float(sched(count))
        assert milestone_factor(count, [6, 9], 0.1) * LR == pytest.approx(want, rel=1e-6)
        assert trainer.scheduler.lr_lambdas[0](count) * LR == pytest.approx(want, rel=1e-6)


def test_augment_frame_pair_bit_equal():
    r = np.random.RandomState(2)
    frames = [r.rand(S, S, 3).astype(np.float32) for _ in range(2)]
    for seed in range(8):          # both flips taken and not
        want = jax_augment(np.random.RandomState(seed), *frames)
        got = augment_frame_pair(np.random.RandomState(seed), *frames)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_vgg_bridge_and_torchvision_file(tmp_path):
    """vgg19_state_dict carries the JAX VGG into the port (five taps at
    atol 1e-5 of their largest magnitude), and a torchvision-layout file
    (with a layer past the last tap and a classifier) loads with
    weights_only and no converter."""
    key = jax.random.PRNGKey(0)
    jvgg = JaxVgg()
    variables = random_tree(jax.eval_shape(jvgg.init, key, jnp.zeros((1, S, S, 3))), 12)
    x = np.random.RandomState(4).rand(2, S, S, 3).astype(np.float32)
    want = jax.jit(jvgg.apply)(variables, x)
    vgg = Vgg19Features()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in vgg19_state_dict(variables).items()}
    vgg.load_state_dict(sd)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)
    path = str(tmp_path / "vgg19.pth")
    torch.save({**sd, "features.30.weight": torch.zeros(512, 512, 3, 3),
                "classifier.0.weight": torch.zeros(4, 8)}, path)
    fresh = Vgg19Features()
    assert fresh.load_torchvision(path) == ["classifier.0.weight", "features.30.weight"]
    for k, v in vgg.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_train_batch_norm_matches_jax():
    """Two calls in a row on inputs with a mean far from zero (the E[x^2] -
    mean^2 variance of both sides): outputs at atol 1e-5, the running
    statistics after both calls at atol 1e-6."""
    r = np.random.RandomState(6)
    xs = [(3.0 + r.randn(2, 4, 4, 5)).astype(np.float32) for _ in range(2)]
    module = SyncBatchNorm(use_running_average=False)
    variables = random_tree(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, 4, 4, 5))), 2)
    bn = BatchNorm(5, train_bn=True)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    apply = jax.jit(functools.partial(module.apply, mutable=["batch_stats"]))
    for x in xs:
        want, mut = apply(variables, x)
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        got = bn(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), variables["batch_stats"]["mean"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), variables["batch_stats"]["var"],
                               atol=1e-6, rtol=0)
    assert int(bn.num_batches_tracked) == 2


def test_eval_flow_ae_ignores_module_mode():
    """The DM teacher and the pipeline build their FlowAE without train_bn:
    .train() on it (or on a parent) leaves BatchNorm on the running
    statistics, the outputs keep their bits and the statistics stay."""
    torch.manual_seed(0)
    fa = FlowAE(**TINY)
    r = np.random.RandomState(1)
    ref = torch.from_numpy(r.rand(2, S, S, 3).astype(np.float32))
    video = torch.from_numpy(r.rand(2, 3, S, S, 3).astype(np.float32))
    stats = {k: v.clone() for k, v in fa.state_dict().items()}
    with torch.no_grad():
        out_eval = fa.eval().teacher_outputs(ref, video)
        out_train = fa.train().teacher_outputs(ref, video)
    for k in out_eval:
        assert torch.equal(out_eval[k], out_train[k]), k
    for k, v in fa.state_dict().items():
        assert torch.equal(v, stats[k]), k
