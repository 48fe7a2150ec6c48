"""One DM training step of the port against dawn_tpu's DMTrainer on the CPU:
stage 1 here, stage 2 in tests/test_torch_train_dm_stage2.py.

Topology of tests/test_trainers.py::dm_setup: 32x32 images, Unet3D dim 16,
dim_mults (1, 2), win_width 2, the tiny FlowAE, fea_channels 32, B=2, T=4
(stage 2: 5 frames, 4 diffused), color jitter on, EMA decay 0.99, f32. The
JAX parameters come from jax.eval_shape plus a seeded numpy fill (no init
compile); each stage compiles the JAX train step once, with XLA's backend
optimizations off to halve the compile time. The random draws the JAX
step makes (t, noise, cond drop, jitter factors) are replayed from its key
and handed to the port as numpy. The JAX UNet runs its default 'full'
temporal attention, the port 'local' (K1/K2's plain versions on the CPU):
the same function.

Compared, with tolerances:
- loss terms: rtol 1e-4;
- Adam's first moment after the step, mu = 0.1 * the clipped gradient, and
  nu: to 1e-3 of their largest magnitude (f32 sums in other orders through
  the UNet's backward);
- the updated parameters: Adam's first step is lr * g / (|g| + 1e-8), about
  lr * sign(g), so an element agrees to 1e-7 where |mu| is above 1e-3 of
  the largest; where it is below, a rounding difference may flip its sign,
  and the element agrees to 2 * lr + 1e-7;
- the EMA: the same rule scaled by (1 - decay).

Also: the NaN rollback (a NaN frame leaves parameters and optimizer state
untouched while the step count and EMA move, as in JAX), the cached-teacher
loss against the uncached one, and the gradient through dynamic
thresholding, whose threshold carries no gradient in JAX.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from dawn_tpu.models.dm.diffusion import GaussianDiffusion as JaxDiffusion
from dawn_tpu.models.dm.unet3d import Unet3D as JaxUnet3D
from dawn_tpu.models.lfg.flow_ae import FlowAE as JaxFlowAE
from dawn_tpu.train.train_dm import DMTrainConfig as JaxConfig
from dawn_tpu.train.train_dm import DMTrainer as JaxTrainer
from dawn_tpu_torch.models.dm.diffusion import GaussianDiffusion
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.train.train_dm import DMTrainConfig, DMTrainer
from dawn_tpu_torch.weights.jax_bridge import load_dm_trainer_variables, unet_state_dict
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

TINY_LFG = dict(generator_kw=dict(block_expansion=8, max_features=32, num_bottleneck_blocks=1),
                region_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
                bg_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
                flow_kw=dict(block_expansion=4, max_features=16, num_blocks=2))
UNET = dict(dim=16, dim_mults=(1, 2), win_width=2)
S, B, LR, DECAY = 32, 2, 2e-4, 0.99


def _batch(t, seed):
    r = np.random.RandomState(seed)
    return {"video": (r.rand(B, t, S, S, 3) * 255).astype(np.float32),
            "hubert": r.randn(B, t, 1024).astype(np.float32),
            "pose": r.randn(B, t, 6).astype(np.float32),
            "blink": r.rand(B, t, 2).astype(np.float32),
            "bbox": np.tile([S * .25, S * .75, S * .25, S * .75, S, S], (B, 1)).astype(np.float32),
            "mouth_lmk": (r.rand(B, t, 19, 2) * S).astype(np.float32)}


def jax_draws(rng, b, t, ls):
    """The draws of DMTrainer.loss_fn / p_losses / color_jitter_video for key
    ``rng``, replayed with the same splits."""
    rng_jit, rng_diff = jax.random.split(rng)
    rng_t, rng_p = jax.random.split(rng_diff)
    rng_noise, rng_drop = jax.random.split(rng_p)
    kb, kc, ks, kh = jax.random.split(rng_jit, 4)
    uni = lambda k, shape, lo, hi: np.asarray(  # noqa: E731
        jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(b)
    return {"t": np.asarray(jax.random.randint(rng_t, (b,), 0, 1000)),
            "noise": np.asarray(jax.random.normal(rng_noise, (b, t, ls, ls, 3), jnp.float32)),
            "drop": np.asarray(jax.random.uniform(rng_drop, (b, t)) < 0.1),
            "jitter": {k: torch.from_numpy(np.array(v)) for k, v in {
                "brightness": uni(kb, (b, 1, 1, 1, 1), 1 - 64 / 255, 1 + 64 / 255),
                "contrast": uni(kc, (b, 1, 1, 1, 1), 0.75, 1.25),
                "saturation": uni(ks, (b, 1, 1, 1), 0.75, 1.25),
                "hue": uni(kh, (b, 1, 1, 1), -0.04, 0.04)}.items()}}


def _port_trainer(stage, jitter, state, unravel):
    cfg = DMTrainConfig(img_size=S, fea_channels=32, stage=stage, color_jitter=jitter,
                        ema_decay=DECAY, lr=LR)
    trainer = DMTrainer(cfg, flow_ae=FlowAE(**TINY_LFG), unet_kw=UNET, device="cpu")
    load_dm_trainer_variables(trainer, unravel(np.asarray(state["params"])),
                              state["frozen"]["lfg"], state["frozen"]["face_loc"],
                              unravel(np.asarray(state["ema_params"])))
    return trainer


FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def run_jax_step(stage):
    """One JAX train step and its state, at stage 1 or 2."""
    t = 4 if stage == 1 else 5
    cfg = JaxConfig(img_size=S, fea_channels=32, stage=stage, ema_decay=DECAY, lr=LR)
    jt = JaxTrainer(cfg, flow_ae=JaxFlowAE(**TINY_LFG))
    jt.unet = JaxUnet3D(channels=jt.in_channels, cond_pose=6, **UNET)
    ls = cfg.latent_size
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jt.unet.init, key, jnp.zeros((1, t, ls, ls, jt.in_channels)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, t, 1032)))
    params = random_tree(shapes, 21 + stage)["params"]
    flat, unravel = ravel_pytree(params)
    jt._unravel = unravel
    frozen = {"lfg": random_tree(jax.eval_shape(
                  functools.partial(jt.flow_ae.init_variables, img_size=S), key), 31),
              "face_loc": random_tree(jax.eval_shape(
                  jt.face_loc.init, key, jnp.zeros((1, S, S, 1))), 41)}
    state = {"params": flat, "opt_state": jt.tx.init(flat), "step": jnp.zeros((), jnp.int32),
             "frozen": frozen, "ema_params": jnp.array(flat)}
    batch = _batch(t, 50 + stage)
    rng = jax.random.PRNGKey(7)
    step = jax.jit(jt.train_step).lower(state, rng, batch).compile(FAST_COMPILE)
    new_state, metrics = step(state, rng, batch)
    tdiff = t - 1 if stage == 2 else t
    return dict(stage=stage, step=step, state=state, new_state=new_state,
                metrics=metrics, batch=batch, draws=jax_draws(rng, B, tdiff, ls),
                unravel=unravel)


@pytest.fixture(scope="module")
def stage_run():
    return run_jax_step(1)


def _by_name(trainer, flat, unravel):
    sd = unet_state_dict(unravel(np.asarray(flat)))
    return {name: sd[name] for name, _ in trainer.unet.named_parameters()}


def check_train_step(r):
    trainer = _port_trainer(r["stage"], True, r["state"], r["unravel"])
    before = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
    got = trainer.train_step(r["batch"], r["draws"])
    want = {k: float(v) for k, v in r["metrics"].items()}
    for k in ("loss", "floss", "mouth_loss", "total"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["grads_finite"] == want["grads_finite"] == 1.0

    adam = r["new_state"]["opt_state"][1][0]
    mu = _by_name(trainer, adam.mu, r["unravel"])
    nu = _by_name(trainer, adam.nu, r["unravel"])
    new = _by_name(trainer, r["new_state"]["params"], r["unravel"])
    ema = _by_name(trainer, r["new_state"]["ema_params"], r["unravel"])
    mu_max = max(np.abs(v).max() for v in mu.values())
    nu_max = max(np.abs(v).max() for v in nu.values())
    for (name, p), e in zip(trainer.unet.named_parameters(), trainer.ema):
        st = trainer.optimizer.state[p]
        assert st["count"] == int(adam.count) == 1
        np.testing.assert_allclose(st["mu"].numpy(), mu[name], atol=1e-3 * mu_max, rtol=0,
                                   err_msg=f"mu {name}")
        np.testing.assert_allclose(st["nu"].numpy(), nu[name], atol=1e-3 * nu_max, rtol=0,
                                   err_msg=f"nu {name}")
        clear = np.abs(mu[name]) > 1e-3 * mu_max
        old = before[name].numpy()
        for label, value, want_value, scale in (("param", p, new[name], 1.0),
                                                ("ema", e, ema[name], 1 - DECAY)):
            diff = np.abs(value.detach().numpy() - want_value)
            assert diff.max() <= scale * 2 * LR + 1e-7, f"{label} {name}: {diff.max()}"
            assert (diff[clear] <= 1e-7 + 1e-6 * np.abs(old[clear])).all(), f"{label} {name}"
    assert trainer.step == 1


def check_cached_teacher(r):
    """With color jitter off, the loss on precomputed teacher tensors is the
    loss on the video (same draws); stage-aware through teacher_precompute."""
    trainer = _port_trainer(r["stage"], False, r["state"], r["unravel"])
    draws = {k: v for k, v in r["draws"].items() if k != "jitter"}
    batch = trainer._batch(r["batch"])
    with torch.no_grad():
        total, metrics = trainer.loss_fn(batch, draws)
        cached = {k: v for k, v in batch.items() if k != "video"}
        cached.update(trainer.teacher_precompute(batch["video"]))
        total_c, metrics_c = trainer.loss_fn(cached, draws)
    for k in metrics:
        torch.testing.assert_close(metrics_c[k], metrics[k], rtol=1e-6, atol=1e-7)


def test_train_step_matches_jax(stage_run):
    check_train_step(stage_run)


def test_cached_teacher_loss_equals_uncached(stage_run):
    check_cached_teacher(stage_run)


def test_nan_rollback_matches_jax(stage_run):
    """A NaN frame: JAX and the port both skip the update; the parameters,
    Adam's moments and count and the schedule stay, step and EMA move."""
    r = stage_run
    trainer = _port_trainer(1, True, r["state"], r["unravel"])
    trainer.train_step(r["batch"], r["draws"])
    poisoned = dict(r["batch"], video=r["batch"]["video"].copy())
    poisoned["video"][0, 0, 0, 0, 0] = np.nan
    state2, metrics = r["step"](r["new_state"], jax.random.PRNGKey(7), poisoned)
    assert float(metrics["grads_finite"]) == 0.0
    params = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
    moments = {n: {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in trainer.optimizer.state[p].items()}
               for n, p in trainer.unet.named_parameters()}
    lr_before, epoch_before = trainer.optimizer.param_groups[0]["lr"], trainer.scheduler.last_epoch
    ema_before = [e.clone() for e in trainer.ema]
    got = trainer.train_step(poisoned, r["draws"])
    assert got["grads_finite"] == 0.0
    assert trainer.step == 2 and int(state2["step"]) == 2
    assert trainer.scheduler.last_epoch == epoch_before
    assert trainer.optimizer.param_groups[0]["lr"] == lr_before
    for n, p in trainer.unet.named_parameters():
        assert torch.equal(p, params[n])
        for k, v in moments[n].items():
            now = trainer.optimizer.state[p][k]
            assert (torch.equal(now, v) if torch.is_tensor(v) else now == v), (n, k)
    ema_want = _by_name(trainer, state2["ema_params"], r["unravel"])
    for (n, p), e, e0 in zip(trainer.unet.named_parameters(), trainer.ema, ema_before):
        torch.testing.assert_close(e, e0 * DECAY + p.detach() * (1 - DECAY))
        assert np.abs(e.numpy() - ema_want[n]).max() <= (1 - DECAY) * 2 * LR * 2 + 1e-7, n


def test_threshold_gradient_matches_jax():
    """Dynamic thresholding clips x0 to [-s, s] / s with s the 0.9-quantile
    of |x0| (floored at 1). JAX finds s by a search over bit patterns, so no
    gradient flows through s; the port detaches it. Values up to 5 make
    s > 1. Tolerance 1e-6 (f32)."""
    rng = np.random.RandomState(3)
    x0 = (rng.randn(2, 3, 4, 4, 3) * 2.5).astype(np.float32)
    w = rng.randn(*x0.shape).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(JaxDiffusion()._threshold(x) * w))(jnp.asarray(x0))
    x = torch.from_numpy(x0).requires_grad_()
    (GaussianDiffusion()._threshold(x) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-6, rtol=0)
