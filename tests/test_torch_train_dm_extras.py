"""The DM trainer's options of the port on the CPU: the FFT floss, remat, the
training snapshot and the FlowAE/generator paths it decodes through.

Topology of tests/test_torch_train_dm.py (32x32, Unet3D dim 16, dim_mults
(1, 2), win_width 2, the tiny FlowAE, fea_channels 32); JAX parameters from
jax.eval_shape plus a seeded numpy fill, loaded into the port through
dawn_tpu_torch.weights.jax_bridge. Compared, with tolerances:

- ``use_fft_floss``: the loss terms of one stage-1 cached-teacher clip
  (T=4) against JAX's ``loss_fn``, its draws replayed: rtol 1e-4;
- remat 'dots' and 'full' against 'none' on one batch and set of draws: the
  loss and every UNet gradient bit for bit; the UNet's windowed attention
  (K1's plain version here, K1 on the card) runs once more per call inside
  the backward and its backward (K2) as often as without remat;
- ``DMTrainer.snapshot`` against JAX's ``DMTrainer.snapshot`` with the same
  noise and cond-drop draws, EMA weights: the float panels to atol 1e-4,
  the uint8 figures to one level. JAX's snapshot runs as written; its
  teacher pass, UNet (in ``loss_fn`` too, at the same shapes) and decode
  are compiled (jax.jit, XLA's backend optimizations off), which run op by
  op would take a minute;
- ``FlowAE.motion_transfer``, ``reconstruct_video`` and
  ``LFGGenerator.decode_with_flow`` with T sources (the snapshot's decode,
  ``decode`` per frame) against JAX: atol 1e-4.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from dawn_tpu.models.dm.unet3d import Unet3D as JaxUnet3D
from dawn_tpu.models.lfg.flow_ae import FlowAE as JaxFlowAE
from dawn_tpu.models.lfg.generator import LFGGenerator as JaxGenerator
from dawn_tpu.train.train_dm import DMTrainConfig as JaxConfig
from dawn_tpu.train.train_dm import DMTrainer as JaxTrainer
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.ops import local_attention as la
from dawn_tpu_torch.train.train_dm import DMTrainConfig, DMTrainer
from dawn_tpu_torch.weights.jax_bridge import load_dm_trainer_variables
from test_torch_train_dm import FAST_COMPILE, TINY_LFG, UNET, S, B, _batch, jax_draws
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

T = 4
DECAY = 0.99


class _JitUnet:
    """JAX's UNet with ``apply`` compiled (its parameters an argument), so
    the loss and the snapshot share one compile at one shape."""

    def __init__(self, unet):
        self.apply = jax.jit(unet.apply, compiler_options=FAST_COMPILE)


class _JitGenerator:
    """JAX's LFG generator with ``decode_with_flow`` compiled; its other
    calls run inside the compiled teacher pass."""

    decode_with_flow = JaxGenerator.decode_with_flow

    def __init__(self, generator):
        self._generator = generator
        self._decode = jax.jit(functools.partial(generator.apply,
                                                 method=JaxGenerator.decode_with_flow),
                               compiler_options=FAST_COMPILE)

    def apply(self, variables, *args, method=None):
        if method is JaxGenerator.decode_with_flow:
            return self._decode(variables, *args)
        return self._generator.apply(variables, *args, **({} if method is None
                                                           else {"method": method}))


@pytest.fixture(scope="module")
def jax_side():
    cfg = JaxConfig(img_size=S, fea_channels=32, use_fft_floss=True, ema_decay=DECAY)
    jt = JaxTrainer(cfg, flow_ae=JaxFlowAE(**TINY_LFG))
    jt.unet = JaxUnet3D(channels=jt.in_channels, cond_pose=6, **UNET)
    ls = cfg.latent_size
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jt.unet.init, key, jnp.zeros((1, T, ls, ls, jt.in_channels)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, T, 1032)))
    params = random_tree(shapes, 61)["params"]
    flat, unravel = ravel_pytree(params)
    jt._unravel = unravel
    ema = flat + 0.01 * jnp.asarray(np.random.RandomState(62).randn(flat.size), jnp.float32)
    frozen = {"lfg": random_tree(jax.eval_shape(
                  functools.partial(jt.flow_ae.init_variables, img_size=S), key), 63),
              "face_loc": random_tree(jax.eval_shape(
                  jt.face_loc.init, key, jnp.zeros((1, S, S, 1))), 64)}
    jt.unet = _JitUnet(jt.unet)
    jt.flow_ae.generator = _JitGenerator(jt.flow_ae.generator)
    jt.flow_ae.reconstruct_video = jax.jit(jt.flow_ae.reconstruct_video,
                                           compiler_options=FAST_COMPILE)
    return dict(jt=jt, cfg=cfg, state={"params": flat, "ema_params": ema, "frozen": frozen},
                unravel=unravel)


def _port(j, **kw):
    cfg = DMTrainConfig(img_size=S, fea_channels=32, ema_decay=DECAY, **kw)
    trainer = DMTrainer(cfg, flow_ae=FlowAE(**TINY_LFG), unet_kw=UNET, device="cpu")
    st = j["state"]
    load_dm_trainer_variables(trainer, j["unravel"](np.asarray(st["params"])),
                              st["frozen"]["lfg"], st["frozen"]["face_loc"],
                              j["unravel"](np.asarray(st["ema_params"])))
    return trainer


def test_fft_floss_matches_jax(jax_side):
    """On a cached-teacher batch (the teacher tensors given, as the teacher
    cache gives them): the floss reads the teacher's flow, and JAX compiles
    the UNet alone."""
    j = jax_side
    st, jt = j["state"], j["jt"]
    ls = j["cfg"].latent_size
    r = np.random.RandomState(65)
    batch = {k: v[:1] for k, v in _batch(T, 65).items() if k != "video"}
    batch.update(real_vid_grid=r.uniform(-1, 1, (1, T, ls, ls, 2)).astype(np.float32),
                 real_vid_conf=r.rand(1, T, ls, ls, 1).astype(np.float32),
                 ref_img_fea=r.randn(1, ls, ls, 32).astype(np.float32))
    rng = jax.random.PRNGKey(66)
    _, want = jt.loss_fn(st["params"], st["frozen"], rng, batch)
    trainer = _port(j, use_fft_floss=True)
    draws = {k: v for k, v in jax_draws(rng, 1, T, ls).items() if k != "jitter"}
    with torch.no_grad():
        _, got = trainer.loss_fn(trainer._batch(batch), draws)
    for k in ("loss", "floss", "mouth_loss", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def _counting(monkeypatch):
    counts = {"fwd": 0, "bwd": 0}

    def wrap(name, key):
        fn = getattr(la, name)

        def counted(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(la, name, counted)

    wrap("_forward", "fwd")
    wrap("local_attention_packed_bwd", "bwd")
    return counts


def test_remat_gradients_equal_none_bit_for_bit(jax_side, monkeypatch):
    counts = _counting(monkeypatch)
    batch = _batch(T, 67)
    r = np.random.RandomState(68)
    ls = jax_side["cfg"].latent_size
    draws = {"t": np.array([17, 640]), "noise": r.randn(B, T, ls, ls, 3).astype(np.float32),
             "drop": np.array([[False, True, False, False], [False] * 4])}
    results = {}
    for remat in ("none", "dots", "full"):
        trainer = _port(jax_side, remat=remat, color_jitter=False)
        counts.update(fwd=0, bwd=0)
        total, _ = trainer.loss_fn(trainer._batch(batch), draws)
        total.backward()
        results[remat] = (total.detach(), [p.grad for p in trainer.unet.parameters()],
                          dict(counts))
    total, grads, n = results["none"]
    assert n["fwd"] == n["bwd"] > 0
    for remat in ("dots", "full"):
        r_total, r_grads, r_n = results[remat]
        assert torch.equal(r_total, total), remat
        assert len(r_grads) == len(grads) and all(g is not None for g in r_grads)
        for i, (a, b) in enumerate(zip(r_grads, grads)):
            assert torch.equal(a, b), (remat, i)
        assert r_n == {"fwd": 2 * n["fwd"], "bwd": n["bwd"]}, (remat, r_n, n)
    with pytest.raises(ValueError, match="remat"):
        DMTrainer(DMTrainConfig(remat="some"), device="cpu")


def test_snapshot_matches_jax(jax_side):
    j = jax_side
    jt, st = j["jt"], j["state"]
    batch = _batch(6, 69)
    rng = jax.random.PRNGKey(70)
    want = jt.snapshot(st, rng, {k: jnp.asarray(v) for k, v in batch.items()})
    rng_noise, rng_drop = jax.random.split(rng)
    ls = j["cfg"].latent_size
    draws = {"noise": np.asarray(jax.random.normal(rng_noise, (1, T, ls, ls, 3), jnp.float32)),
             "drop": np.asarray(jax.random.uniform(rng_drop, (1, T)) < 0.1)}
    got = _port(j).snapshot(batch, draws=draws)
    assert sorted(got) == sorted(want) and len(got) == 7
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape == (T, S, S, 3), k
        if w.dtype == np.uint8:
            assert g.dtype == np.uint8, k
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, k
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)


def test_flow_ae_paths_match_jax(jax_side):
    """At the snapshot's shapes, so JAX's compiled teacher pass and decode
    are reused; motion_transfer through reconstruct_video's frames (its
    composition in both packages)."""
    j = jax_side
    lfg = j["state"]["frozen"]["lfg"]
    jt, trainer = j["jt"], _port(j)
    r = np.random.RandomState(71)
    video = r.rand(1, T, S, S, 3).astype(np.float32)
    want = jt.flow_ae.reconstruct_video(lfg, jnp.asarray(video[:, 0]), jnp.asarray(video))
    with torch.no_grad():
        got = trainer.flow_ae.reconstruct_video(torch.from_numpy(video[:, 0]),
                                                torch.from_numpy(video))
        moved = trainer.flow_ae.motion_transfer(torch.from_numpy(video[0, :1]).expand(T, -1, -1, -1),
                                                torch.from_numpy(video[0]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=k)
    ls = S // 4
    for k, w in (("optical_flow", want["real_vid_grid"]), ("occlusion_map", want["real_vid_conf"]),
                 ("prediction", want["real_out_vid"]), ("deformed", want["real_warped_vid"])):
        np.testing.assert_allclose(moved[k].numpy(), np.asarray(w)[0], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert moved["bottle_neck_feat"].shape == (T, ls, ls, 32)

    grid = r.uniform(-1, 1, (T, ls, ls, 2)).astype(np.float32)
    conf = r.rand(T, ls, ls, 1).astype(np.float32)
    sources = np.repeat(video[0, :1], T, axis=0)           # T sources: ``decode`` per frame
    want = jt.flow_ae.generator.apply(lfg["generator"], jnp.asarray(sources), jnp.asarray(grid),
                                      jnp.asarray(conf), method=JaxGenerator.decode_with_flow)
    with torch.no_grad():
        got = trainer.flow_ae.generator.decode_with_flow(
            torch.from_numpy(sources), torch.from_numpy(grid), torch.from_numpy(conf))
    for k in ("prediction", "deformed"):
        assert got[k].shape == (T, S, S, 3), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0,
                                   err_msg=k)
