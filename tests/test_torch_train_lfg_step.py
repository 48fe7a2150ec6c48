"""One LFG training step of the port against dawn_tpu's LFGTrainer on the CPU.

The tiny FlowAE of tests/test_trainers.py (generator 8/32 with one
bottleneck block, region/bg/flow predictors 4/16 with two hourglass blocks)
with train-mode BatchNorm, 32x32 frames, B=2, scales (1, 0.5), VGG19. The
weights are the port's default init from torch.manual_seed(11), with every
BatchNorm's scale, shift and running statistics drawn from RandomState(12);
the JAX package's own converters (``dawn_tpu.weights.torch_convert``) carry
them to JAX (no init compile), and the JAX step is compiled once with XLA's
backend optimizations off. Its random warp (the affine and TPS normals of
random_tps_params) is replayed from its key and handed to the port.

Compared, with tolerances:
- the loss terms: rtol 1e-4;
- the running statistics after the step, the region predictor's moved by
  its three runs in turn: rtol 1e-4, atol 1e-6 (f32 sums in another order);
- Adam's first moment (0.5 x the gradient), per net, to GRAD_TOL of that
  net's largest magnitude; the updated parameters by Adam's first step,
  lr * g / (|g| + 1e-8), about lr * sign(g): to 1e-7 (+1e-6 relative) where
  |mu| is above GRAD_TOL of the net's largest, else to 2 * lr + 1e-7.

GRAD_TOL = 1e-2 is what an f32 gradient of this loss is worth: the
perceptual term reaches the predictors through the flow, the warps and
train-mode BatchNorm over few samples (8 at the region predictor's deepest
level), which amplifies f32 rounding. Against a float64 evaluation of the
same loss by the port, on these inputs, JAX's compiled f32 gradient is off
by up to 3.5e-3 of a net's largest entry (the generator; 0.9e-3 to 1.6e-3
for the predictors) and the port's f32 gradient by as much (the
measurement: :func:`grad_errors` below, run by hand). The tolerance covers
the two errors added, with room.

The region predictor's 2x2 SVD is closed form in the port (``svd2x2``) and
LAPACK in JAX; their gradients part where the two singular values of a
covariance meet. The inputs here (frames uniform in [0, 1] from
RandomState(5)) keep every covariance's smaller singular value below 0.95
of the larger, which the test asserts.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.lfg.flow_ae import FlowAE as JaxFlowAE
from dawn_tpu.models.lfg.vgg import convert_vgg19_features
from dawn_tpu.train.train_lfg import LFGTrainConfig as JaxConfig
from dawn_tpu.train.train_lfg import LFGTrainer as JaxTrainer
from dawn_tpu.weights.torch_convert import (convert_bg_predictor, convert_lfg_generator,
                                            convert_region_predictor)
from dawn_tpu_torch.models.lfg.blocks import BatchNorm
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.train.train_lfg import LFGTrainConfig, LFGTrainer
from dawn_tpu_torch.weights.jax_bridge import (bg_predictor_state_dict, generator_state_dict,
                                               pixelwise_flow_state_dict,
                                               region_predictor_state_dict)
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

TINY = dict(generator_kw=dict(block_expansion=8, max_features=32, num_bottleneck_blocks=1),
            region_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            bg_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            flow_kw=dict(block_expansion=4, max_features=16, num_blocks=2))
TINY_BN = {k: dict(v, train_bn=True) for k, v in TINY.items()}
S, B, LR = 32, 2, 2e-4
SCALES = (1, 0.5)
GRAD_TOL = 1e-2
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
STATE_DICTS = {"generator": generator_state_dict, "region_predictor": region_predictor_state_dict,
               "bg_predictor": bg_predictor_state_dict,
               "pixelwise_flow_predictor": pixelwise_flow_state_dict}


def jax_tps_draws(rng, b, points=5):
    """The standard normals of random_tps_params for key ``rng``."""
    r1, r2, _ = jax.random.split(rng, 3)
    return {"affine": np.asarray(jax.random.normal(r1, (b, 2, 3))),
            "tps": np.asarray(jax.random.normal(r2, (b, 1, points ** 2)))}


def port_trainer() -> LFGTrainer:
    """The seeded port trainer of the module docstring."""
    torch.manual_seed(11)
    trainer = LFGTrainer(LFGTrainConfig(scales=SCALES, lr=LR),
                         flow_ae=FlowAE(**TINY_BN), device="cpu")
    r = np.random.RandomState(12)
    with torch.no_grad():
        for m in trainer.flow_ae.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                for buf, value in ((m.weight, 1 + 0.1 * r.randn(c)), (m.bias, 0.1 * r.randn(c)),
                                   (m.running_mean, 0.1 * r.randn(c)),
                                   (m.running_var, 0.5 + r.rand(c))):
                    buf.copy_(torch.from_numpy(value.astype(np.float32)))
    return trainer


def jax_variables(trainer: LFGTrainer):
    """The port trainer's nets and VGG as JAX variables, through the JAX
    package's converters."""
    fa = trainer.flow_ae
    sd = {k: {n: v.numpy() for n, v in getattr(fa, k).state_dict().items()}
          for k in STATE_DICTS}
    gen = {**sd["generator"], **{f"pixelwise_flow_predictor.{n}": v
                                 for n, v in sd["pixelwise_flow_predictor"].items()}}
    variables = {"region_predictor": convert_region_predictor(sd["region_predictor"], 2),
                 "bg_predictor": convert_bg_predictor(sd["bg_predictor"], 2),
                 **convert_lfg_generator(gen, num_bottleneck=1, flow_predictor_blocks=2)}
    vgg = convert_vgg19_features({k: v.numpy() for k, v in trainer.vgg.state_dict().items()})
    return variables, vgg


@pytest.fixture(scope="module")
def run():
    """One compiled JAX train step, the port trainer before its step, and
    what the port needs to replay it."""
    trainer = port_trainer()
    variables, vgg = jax_variables(trainer)
    jt = JaxTrainer(JaxConfig(img_size=S, scales=SCALES, lr=LR), flow_ae=JaxFlowAE(**TINY_BN))
    params = {k: v["params"] for k, v in variables.items()}
    stats = {k: v["batch_stats"] for k, v in variables.items()}
    r = np.random.RandomState(5)
    batch = {"source": r.rand(B, S, S, 3).astype(np.float32),
             "driving": r.rand(B, S, S, 3).astype(np.float32)}
    rng = jax.random.PRNGKey(7)

    def first_step(params, stats, vgg, rng, batch):       # init_state's fresh state
        return jt.train_step({"params": params, "batch_stats": stats,
                              "opt_state": jt.tx.init(params),
                              "step": jnp.zeros((), jnp.int32), "vgg": vgg}, rng, batch)

    args = (params, stats, vgg, rng, batch)
    new_state, metrics = jax.jit(first_step).lower(*args).compile(FAST_COMPILE)(*args)
    region = copy.deepcopy(trainer.flow_ae.region_predictor)
    with torch.no_grad():
        ratios = [torch.linalg.svdvals(region(torch.from_numpy(img))["covar"])
                  for img in batch.values()]
    return dict(trainer=trainer, new_state=new_state, metrics=metrics, batch=batch,
                draws=jax_tps_draws(rng, B), ratios=[s[..., 1] / s[..., 0] for s in ratios])


def by_name(params, stats):
    """{net: {port parameter or buffer name: array}} of a JAX params tree."""
    return {k: fn({"params": params[k], "batch_stats": stats[k]})
            for k, fn in STATE_DICTS.items()}


def test_train_step_matches_jax(run):
    assert all((r < 0.95).all() for r in run["ratios"])
    trainer = run["trainer"]
    before = {n: p.detach().clone() for n, p in trainer.flow_ae.named_parameters()}
    got = trainer.train_step(run["batch"], run["draws"])
    want = {k: float(v) for k, v in run["metrics"].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)

    new = run["new_state"]
    adam = new["opt_state"][0]
    mu = by_name(adam.mu, new["batch_stats"])
    want_sd = by_name(new["params"], new["batch_stats"])
    for net, sd in want_sd.items():
        module = getattr(trainer.flow_ae, net)
        for name, buf in module.named_buffers():
            if name.endswith("num_batches_tracked"):
                assert int(buf) == (3 if net == "region_predictor" else 1), (net, name)
                continue
            np.testing.assert_allclose(buf.numpy(), sd[name], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{net}.{name}")
        mu_max = max(np.abs(mu[net][name]).max() for name, _ in module.named_parameters())
        for name, p in module.named_parameters():
            full = f"{net}.{name}"
            st = trainer.optimizer.state[p]
            assert st["count"] == int(adam.count) == 1
            m = mu[net][name]
            np.testing.assert_allclose(st["mu"].numpy(), m, atol=GRAD_TOL * mu_max, rtol=0,
                                       err_msg=f"mu {full}")
            diff = np.abs(p.detach().numpy() - sd[name])
            old = before[full].numpy()
            clear = np.abs(m) > GRAD_TOL * mu_max
            assert diff.max() <= 2 * LR + 1e-7, f"param {full}: {diff.max()}"
            assert (diff[clear] <= 1e-7 + 1e-6 * np.abs(old[clear])).all(), f"param {full}"
    assert trainer.step == 1


def grad_errors():
    """The accuracy behind GRAD_TOL, by net: (JAX's f32 error, the port's f32
    error), each the largest |g - g64| over the net's largest |g64|, g64 the
    port's float64 gradient of the step's loss on the same weights, batch
    and warp. Not a test (two more compiles); run by hand from tests/:
    ``python -c 'import test_torch_train_lfg_step as t; print(t.grad_errors())'``."""
    r = np.random.RandomState(5)
    batch = {"source": r.rand(B, S, S, 3).astype(np.float32),
             "driving": r.rand(B, S, S, 3).astype(np.float32)}
    rng = jax.random.PRNGKey(7)
    draws = jax_tps_draws(rng, B)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        trainer = port_trainer()
        trainer.flow_ae.to(dtype)
        trainer.vgg.to(dtype)
        for m in trainer.flow_ae.modules():        # the blocks' compute dtype
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = dtype
        total, _ = trainer.loss_fn({k: torch.from_numpy(v).to(dtype) for k, v in batch.items()},
                                   {k: torch.from_numpy(v).to(dtype) for k, v in draws.items()})
        total.backward()
        grads[dtype] = {n: p.grad.double().numpy() for n, p in trainer.flow_ae.named_parameters()}
    variables, vgg = jax_variables(port_trainer())
    jt = JaxTrainer(JaxConfig(img_size=S, scales=SCALES, lr=LR), flow_ae=JaxFlowAE(**TINY_BN))
    params = {k: v["params"] for k, v in variables.items()}
    stats = {k: v["batch_stats"] for k, v in variables.items()}
    g, _ = jax.jit(jax.grad(jt.loss_fn, has_aux=True))(params, stats, vgg, rng, batch)
    want = by_name(g, stats)
    out = {}
    for net in STATE_DICTS:
        names = [n for n in grads[torch.float64] if n.startswith(net + ".")]
        top = max(np.abs(grads[torch.float64][n]).max() for n in names)
        jax_err = max(np.abs(want[net][n[len(net) + 1:]] - grads[torch.float64][n]).max()
                      for n in names)
        port_err = max(np.abs(grads[torch.float32][n] - grads[torch.float64][n]).max()
                       for n in names)
        out[net] = (float(jax_err / top), float(port_err / top))
    return out
