"""One PBnet training step of the port against dawn_tpu's PBnetTrainer on the
CPU, and the pieces under it: the loss registry, the KL annealing, the
padded collation and the pose dataset.

Tiny hyperparameters: reemb6, 1 layer, latent 16, ff 32, 2 heads, dropout 0
(the JAX dropout stream cannot be replayed), B=2 at T=16 with lengths
[16, 12] (the PatchGAN needs 12 frames). The JAX variables come from
jax.eval_shape plus a seeded numpy fill (no init compile), and the JAX
step is compiled once with XLA's backend optimizations off. Its z noise,
drawn from split(split(key)[0], 3)[0], is replayed into the port.

Compared, with tolerances:
- the step's losses and metrics: rtol 1e-4 (atol 1e-6 for terms near
  zero); each loss of the registry and compute_loss alone: rtol 1e-5, atol
  1e-6 and 1e-7;
- Adam's first moments (0.1 x the clipped gradients of G and D) to 1e-3 of
  each model's largest magnitude;
- the updated parameters: AdamW's first step is p - lr (g / (|g| + 1e-8)
  + 1e-4 p), about p (1 - lr 1e-4) - lr sign(g), so an element agrees to
  1e-7 (+1e-6 relative) where |mu| is above 1e-3 of the largest, else to
  2 * lr + 1e-7.
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from dawn_tpu.models.pbnet import losses as JL
from dawn_tpu.models.pbnet.cvae import CVAE as JaxCVAE
from dawn_tpu.models.pbnet.cvae import PBnetParams as JaxParams
from dawn_tpu.train.data import PBnetPoseDataset as JaxPoseDataset
from dawn_tpu.train.data import collate_padded as jax_collate
from dawn_tpu.train.data import lengths_to_mask as jax_lengths_to_mask
from dawn_tpu.train.train_pbnet import PBnetTrainConfig as JaxConfig
from dawn_tpu.train.train_pbnet import PBnetTrainer as JaxTrainer
from dawn_tpu_torch.models.pbnet import losses as L
from dawn_tpu_torch.models.pbnet.cvae import CVAE, PBnetParams
from dawn_tpu_torch.train.data import PBnetPoseDataset, collate_padded, lengths_to_mask
from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer
from dawn_tpu_torch.weights.jax_bridge import (load_pbnet_trainer_variables,
                                               patchgan_state_dict, pbnet_state_dict)
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

HP = dict(pos_dim=6, eye_dim=0, latent_dim=16, ff_size=32, num_layers=1, num_heads=2,
          dropout=0.0)
B, T, LR = 2, 16, 1e-4
LENGTHS = np.array([16, 12])
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_eps(rng, b, t, latent):
    """The z noise of PBnetTrainer.g_loss -> CVAE.forward for key ``rng``."""
    r1, _ = jax.random.split(rng)
    r_z, _, _ = jax.random.split(r1, 3)
    return np.asarray(jax.random.normal(r_z, (b, t, latent)))


def _batch(seed):
    r = np.random.RandomState(seed)
    x = (0.5 + 0.1 * r.randn(B, T, 6)).astype(np.float32)
    hubert = r.randn(B, T, 1024).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0           # collate_padded's zero padding
    hubert[1, LENGTHS[1]:] = 0.0
    return {"x": x, "hubert": hubert, "lengths": LENGTHS}


@pytest.fixture(scope="module")
def run():
    jt = JaxTrainer(JaxConfig(kind="pose", lr=LR, total_steps=1000), hp=JaxParams(**HP))
    key = jax.random.PRNGKey(0)
    g_vars = random_tree(jax.eval_shape(functools.partial(jt.model.init_variables,
                                                          num_frames=T), key), 3)
    d_vars = random_tree(jax.eval_shape(jt.disc.init, key, jnp.zeros((1, T, 6))), 4)
    g_flat, jt._g_unravel = ravel_pytree(g_vars)
    d_flat, jt._d_unravel = ravel_pytree(d_vars)
    state = {"g": g_flat, "d": d_flat, "opt_g": jt.tx_g.init(g_flat),
             "opt_d": jt.tx_d.init(d_flat), "step": jnp.zeros((), jnp.int32)}
    batch = _batch(9)
    rng = jax.random.PRNGKey(5)
    epoch = jnp.float32(0)
    step = jax.jit(jt.train_step).lower(state, rng, batch, epoch).compile(FAST_COMPILE)
    new_state, metrics = step(state, rng, batch, epoch)
    return dict(jt=jt, g_vars=g_vars, d_vars=d_vars, new_state=new_state, metrics=metrics,
                batch=batch, eps=jax_eps(rng, B, T, HP["latent_dim"]))


def port_trainer(r):
    trainer = PBnetTrainer(PBnetTrainConfig(kind="pose", lr=LR, total_steps=1000),
                           hp=PBnetParams(**HP), device="cpu")
    load_pbnet_trainer_variables(trainer, r["g_vars"], r["d_vars"])
    return trainer


def test_train_step_matches_jax(run):
    trainer = port_trainer(run)
    models = {"g": (trainer.model, pbnet_state_dict, 0),
              "d": (trainer.disc, patchgan_state_dict, 1)}
    before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
              for k, (m, _, _) in models.items()}
    got = trainer.train_step(run["batch"], 0, {"eps": run["eps"]})
    want = {k: float(v) for k, v in run["metrics"].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    new = run["new_state"]
    jt = run["jt"]
    for k, (module, to_sd, i) in models.items():
        unravel = jt._g_unravel if k == "g" else jt._d_unravel
        adam = new[f"opt_{k}"][1][0]
        mu, params = to_sd(unravel(adam.mu)), to_sd(unravel(new[k]))
        mu_max = max(np.abs(mu[n]).max() for n, _ in module.named_parameters())
        for name, p in module.named_parameters():
            st = trainer.optimizers[i].state[p]
            assert st["count"] == int(adam.count) == 1
            np.testing.assert_allclose(st["mu"].numpy(), mu[name], atol=1e-3 * mu_max, rtol=0,
                                       err_msg=f"mu {k} {name}")
            diff = np.abs(p.detach().numpy() - params[name])
            old = before[k][name].numpy()
            clear = np.abs(mu[name]) > 1e-3 * mu_max
            assert diff.max() <= 2 * LR + 1e-7, f"{k} {name}: {diff.max()}"
            assert (diff[clear] <= 1e-7 + 1e-6 * np.abs(old[clear])).all(), f"{k} {name}"
    assert trainer.step == 1


EPOCHS = (0, 1, 20000)
LOSSES = ("rc", "rcw", "reg", "kl", "ssim", "var", "mmd", "hp")


@pytest.fixture(scope="module")
def jax_losses():
    """The inputs of the loss tests and JAX's results, from one function
    compiled with XLA's backend optimizations off: the registry's losses on
    masked inputs, and compute_loss at each of EPOCHS on its own forward
    outputs."""
    r = np.random.RandomState(11)
    mask = jax_lengths_to_mask(LENGTHS, T)
    mf = mask.astype(np.float32)
    x = {"out": (r.randn(B, T, 6) * mask[..., None]).astype(np.float32),
         "x_delta": (r.randn(B, T, 6) * mask[..., None]).astype(np.float32),
         "mu": r.randn(B, T, 16).astype(np.float32),
         "logvar": r.randn(B, T, 16).astype(np.float32),
         "z": r.randn(B, T, 16).astype(np.float32),
         "w": r.randn(6, 5).astype(np.float32)}
    fwd = {ep: {k: r.randn(B, T, d).astype(np.float32) for k, d in
                (("output", 6), ("mu", 16), ("logvar", 16), ("z", 16))} for ep in EPOCHS}
    rng = jax.random.PRNGKey(2)
    jc = JaxCVAE(JaxParams(**HP))

    def compute(x, fwd):
        out = {n: JL.get_loss_function(n)(x["out"], x["x_delta"], mf)
               for n in ("rc", "rcw", "reg", "ssim", "var")}
        out["kl"] = JL.kl_loss(x["mu"], x["logvar"], mf)
        out["mmd"] = JL.mmd_loss(x["z"], rng)
        out["hp"] = JL.hessian_penalty(rng, lambda u: jnp.tanh(u @ x["w"]) ** 3, x["x_delta"])
        for ep in EPOCHS:
            mixed, terms = jc.compute_loss(fwd[ep], x["x_delta"], jnp.asarray(mask),
                                           jnp.float32(ep))
            out[f"epoch {ep}"] = terms
        return out

    want = jax.jit(compute).lower(x, fwd).compile(FAST_COMPILE)(x, fwd)
    draws = {"mmd": np.asarray(jax.random.normal(rng, (B * T, 16))),
             "hp": 0.1 * (2.0 * np.asarray(jax.random.bernoulli(
                 rng, 0.5, (2, B, T, 6))).astype(np.float32) - 1.0)}
    return dict(x=x, fwd=fwd, mask=mask, mf=mf, want=want, draws=draws)


@pytest.mark.parametrize("epoch", EPOCHS)
def test_compute_loss_annealing_matches_jax(jax_losses, epoch):
    """compute_loss on the same forward outputs at epochs 0 (full KL), 1 (no
    KL) and 20000 (full again), masked."""
    j = jax_losses
    want = j["want"][f"epoch {epoch}"]
    model = CVAE(PBnetParams(**HP), device="cpu")
    fwd = {k: torch.from_numpy(v) for k, v in j["fwd"][epoch].items()}
    _, got = model.compute_loss(fwd, torch.from_numpy(j["x"]["x_delta"]),
                                torch.from_numpy(j["mask"]), epoch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert (float(got["kl"]) == 0.0) == (epoch == 1)


@pytest.mark.parametrize("name", LOSSES)
def test_each_loss_matches_jax(jax_losses, name):
    j = jax_losses
    t = {k: torch.from_numpy(v) for k, v in j["x"].items()}
    mf = torch.from_numpy(j["mf"])
    if name == "kl":
        got = L.kl_loss(t["mu"], t["logvar"], mf)
    elif name == "mmd":
        got = L.mmd_loss(t["z"], torch.from_numpy(j["draws"]["mmd"]))
    elif name == "hp":
        got = L.hessian_penalty(lambda u: torch.tanh(u @ t["w"]) ** 3, t["x_delta"],
                                dzs=torch.from_numpy(j["draws"]["hp"]))
    else:
        got = L.get_loss_function(name)(t["out"], t["x_delta"], mf)
    # atol 1e-6: mmd is a difference of three means of order one
    np.testing.assert_allclose(float(got), float(j["want"][name]), rtol=1e-5, atol=1e-6)
    assert L.get_loss_names() == JL.get_loss_names()


def test_dropout_in_training_forward_not_in_generate():
    """With dropout 0.1 the training forward of the same z noise differs
    between two calls (two dropout draws) and from the eval forward;
    ``generate`` of the same z is the same twice whatever the module's
    mode, and equals the eval-mode decode; one train_step leaves the model
    in training mode."""
    torch.manual_seed(0)
    model = CVAE(PBnetParams(**dict(HP, dropout=0.1)), device="cpu")
    r = np.random.RandomState(1)
    x, y = torch.from_numpy(r.rand(B, T, 6).astype(np.float32)), torch.randn(B, T, 1024)
    eps = torch.randn(B, T, 16)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        ref = model(x, y, eps=eps)["output"]            # eval mode: deterministic
        gen_eval = model.generate(x[:, 0], y, z=eps)
        model.train()
        a, b = (model(x, y, eps=eps, generator=gen)["output"] for _ in range(2))
        gen_train = model.generate(x[:, 0], y, z=eps)
    assert not torch.equal(a, b) and not torch.equal(a, ref)
    assert torch.equal(gen_train, gen_eval)
    torch.testing.assert_close(gen_eval, model.decode(x[:, :1].expand(B, T, 6), eps, y))
    trainer = PBnetTrainer(PBnetTrainConfig(kind="pose"), hp=PBnetParams(**dict(HP, dropout=0.1)),
                           device="cpu")
    batch = _batch(2)
    m1 = trainer.train_step(batch, 0, {"eps": eps.numpy()})
    assert trainer.model.training and np.isfinite(m1["g_total"])


def test_collate_and_mask_match_jax():
    r = np.random.RandomState(0)
    samples = [{"x": r.randn(n, 6).astype(np.float32), "hubert": r.randn(n, 8).astype(np.float32),
                "name": f"v{n}"} for n in (16, 12, 5)]
    want, got = jax_collate(samples), collate_padded(samples)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(lengths_to_mask([3, 1], 4), jax_lengths_to_mask([3, 1], 4))


def test_pose_dataset_batches_match_jax(tmp_path):
    """The same seed gives the same batches as the JAX class on a tiny
    chunked tree (one video shorter than num_frames, one in the test split,
    one without eye chunks)."""
    r = np.random.RandomState(4)
    lengths = {"vid_a": 37, "vid_b": 9, "vid_c": 30, "RD_Radio14_000": 30}
    for name, n in lengths.items():
        for kind, width in (("hubert", 1024), ("pose", 7), ("eye", 8)):
            if kind == "eye" and name == "vid_c":
                continue
            d = tmp_path / kind / name
            d.mkdir(parents=True)
            for i in range(0, n, 25):
                np.save(d / f"chunk_{i // 25:04d}.npy",
                        (r.rand(min(25, n - i), width) * 90).astype(np.float32))
    with open(tmp_path / "length_dict.pkl", "wb") as f:
        pickle.dump(lengths, f)
    args = [str(tmp_path / k) for k in ("hubert", "pose", "eye")] + [
        str(tmp_path / "length_dict.pkl")]
    want = JaxPoseDataset(*args, num_frames=20, seed=3)
    got = PBnetPoseDataset(*args, num_frames=20, seed=3)
    assert got.names == want.names == ["vid_a", "vid_b"]
    for gb, wb in zip(got.batches(3, 4), want.batches(3, 4)):
        assert sorted(gb) == sorted(wb) == ["eye", "hubert", "pose"]
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    assert os.path.isdir(tmp_path / "pose" / "RD_Radio14_000")
