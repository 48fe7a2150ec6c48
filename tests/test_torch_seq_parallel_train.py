"""The port's sharded DM train step in gloo processes against the JAX package.

``DMTrainer.make_sharded_step`` runs one stage-1 step in 2 processes
('data' 1 x 'seq' 2: the 8 diffused frames split 4 + 4, each rank's
temporal attentions on the halo-exchanged stripe) and in 4 ('data' 2 x
'seq' 2: one row and 4 frames a rank), and both are held against JAX's
``make_sharded_step`` on the ('data' 1, 'seq' 2) CPU mesh, which runs the
same function. The configuration is the tiny one of
``tests/test_multichip_inference.py:24-38`` (32x32, T 8, win_width 2, UNet
dim 8, dim_mults (1, 2), 2 heads x 8) with the tiny FlowAE and fea_channels
32 of ``tests/test_torch_train_dm.py``, B 2, color jitter on, EMA decay
0.99; the same numpy weights on both sides, and the JAX step's random draws
replayed from its key and handed to the port. Tolerances are that file's
(its docstring gives their reasons): loss terms rtol 1e-4; Adam's first and
second moments to 1e-3 of their largest magnitude; the parameters and the
EMA by Adam's first-step rule. Every rank must end with the same
parameters, moments and EMA, bit for bit.

Stage 2 (a 9-frame clip, frame 0 split off on every rank as the reference,
8 frames diffused over 2 'seq' ranks) is held against the step JAX's
``make_sharded_step`` builds at stage 2 on the same mesh, at the same
tolerances. That step's ``in_shardings`` would split the clip's 9 frames
over 'seq', which JAX refuses (9 does not divide by 2; and a clip that
divides leaves an odd count diffused, which ``seq_sharded_local_attention``
asserts against), so there the clip goes in whole, as the port's ranks take
it: the step is the same function, its UNet the seq-sharded clone
``make_sharded_step`` installs, the diffused frames split over 'seq' inside.

With ``remat: 'full'`` and the FFT floss, the 2-rank stage-1 step
recomputes each rank's UNet forward inside the backward, its halo exchanges
and all-reduces included (every rank recomputes alike, so the collectives
pair up), and gathers the predicted and the teacher's flow over 'seq' for
the FFT along the whole clip; it is held against the port's unsharded step
with the same options and draws, at the tolerances above.

The training CLI runs two steps in two processes started with the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``): JAX's mesh rule gives 'seq' 2, only rank 0 writes
``metrics.jsonl`` and checkpoints. It runs four steps more on each gloo rank
with an f16 ``--teacher-cache`` and ``--sample-every 1``: rank 0's
snapshots leave the ranks' generators bit-equal, the hit rate rises, and
the run's losses equal, at rtol 1e-4, one process's on the entries the
ranks stored (every rank reads a step's teacher tensors back from the
cache, so the ranks of one clip train on the same f16 values). And the
CLI's frame check refuses, before
the first step, what JAX's ``seq_sharded_local_attention`` asserts at it:
stage 1's 20 frames at window 20 over 2 'seq' ranks.
"""

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import NamedSharding, PartitionSpec as P

from dawn_tpu.models.dm.unet3d import Unet3D as JaxUnet3D
from dawn_tpu.models.lfg.flow_ae import FlowAE as JaxFlowAE
from dawn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dawn_tpu.train.train_dm import DMTrainConfig as JaxConfig
from dawn_tpu.train.train_dm import DMTrainer as JaxTrainer
from chip_smoke import write_hdtf_tree
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.scripts.train_dm import check_seq_frames
from dawn_tpu_torch.train.train_dm import DMTrainConfig, DMTrainer
from dawn_tpu_torch.weights.jax_bridge import load_dm_trainer_variables, unet_state_dict
from test_torch_train_dm import FAST_COMPILE, TINY_LFG, jax_draws
from test_torch_util import random_tree, start_ranks, one_torch_thread  # noqa: F401

S, B, T, LR, DECAY = 32, 2, 8, 2e-4, 0.99
UNET = dict(dim=8, dim_mults=(1, 2), win_width=2, attn_heads=2, attn_dim_head=8)
CONFIG = dict(img_size=S, fea_channels=32, ema_decay=DECAY, lr=LR)
REMAT_FFT = dict(remat="full", use_fft_floss=True)
SPEC = {"video": P("data", "seq"), "hubert": P("data", "seq"), "pose": P("data", "seq"),
        "blink": P("data", "seq"), "bbox": P("data"), "mouth_lmk": P("data", "seq")}


def _batch(t, seed):
    r = np.random.RandomState(seed)
    return {"video": (r.rand(B, t, S, S, 3) * 255).astype(np.float32),
            "hubert": r.randn(B, t, 1024).astype(np.float32),
            "pose": r.randn(B, t, 6).astype(np.float32),
            "blink": r.rand(B, t, 2).astype(np.float32),
            "bbox": np.tile([S * .25, S * .75, S * .25, S * .75, S, S], (B, 1)).astype(np.float32),
            "mouth_lmk": (r.rand(B, t, 19, 2) * S).astype(np.float32)}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _cli_args(root):
    """The training CLI's config and data flags on a tiny tree under ``root``."""
    import yaml
    flags = write_hdtf_tree(os.path.join(root, "data"), {"vid_000": 30, "vid_001": 26}, S,
                            seed=3)
    cfg = dict(img_size=S, num_frames=T, batch_size=B, lr=LR, total_steps=100, grad_clip=2.0,
               floss_weight=0.15, mouth_weight=0.15, null_cond_prob=0.1, win_width=2,
               fea_channels=32, unet=dict(UNET), lfg={k[:-3]: v for k, v in TINY_LFG.items()})
    with open(os.path.join(root, "tiny.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    return [f"--config={os.path.join(root, 'tiny.yaml')}", *flags, "--device=cpu",
            "--log-every=1"]


def _start_cli(root, base):
    """Two CPU processes of the training CLI with torchrun's environment."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "dawn_tpu_torch.scripts.train_dm", *base, "--steps=2",
           f"--workdir={os.path.join(root, 'run')}"]
    return [subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=repo,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]


def _jax_step(stage, state, unravel, batch, rng, mesh, spec, names):
    """One step of JAX's ``make_sharded_step`` at ``stage`` on ``mesh`` (the
    batch split by ``spec``), as lists in the order of the port's parameter
    ``names``."""
    jt = JaxTrainer(JaxConfig(img_size=S, fea_channels=32, stage=stage, ema_decay=DECAY, lr=LR),
                    flow_ae=JaxFlowAE(**TINY_LFG))
    jt.unet = JaxUnet3D(channels=jt.in_channels, cond_pose=6, **UNET)
    jt._unravel = unravel
    jt.make_sharded_step(mesh)                  # the seq-enabled UNet clone
    rep = NamedSharding(mesh, P())
    step = jax.jit(jt.train_step, in_shardings=(rep, rep, {k: NamedSharding(mesh, spec[k])
                                                           for k in batch}))
    with mesh:
        new_state, metrics = step.lower(state, rng, batch).compile(FAST_COMPILE)(
            state, rng, batch)

    def by_name(tree_flat):
        sd = unet_state_dict(unravel(np.asarray(tree_flat)))
        return [sd[n] for n in names]

    adam = new_state["opt_state"][1][0]
    return dict(metrics={k: float(v) for k, v in metrics.items()}, mu=by_name(adam.mu),
                nu=by_name(adam.nu), params=by_name(new_state["params"]),
                ema=by_name(new_state["ema_params"]), before=by_name(state["params"]))


def _port_step(case, config, names):
    """One unsharded step of the port's trainer on ``case``'s weights, batch
    and draws, in the form of :func:`_jax_step`."""
    trainer = DMTrainer(DMTrainConfig(**config), flow_ae=FlowAE(**TINY_LFG), unet_kw=UNET,
                        device="cpu")
    for module in ("unet", "flow_ae", "face_loc"):
        getattr(trainer, module).load_state_dict(case[module])
    trainer.ema = [e.clone() for e in case["ema"]]
    before = [p.detach().clone().numpy() for p in trainer.unet.parameters()]
    metrics = trainer.train_step(case["batch"], case["draws"])
    params = list(trainer.unet.parameters())
    moments = {k: [trainer.optimizer.state[p][k].numpy() for p in params] for k in ("mu", "nu")}
    return dict(metrics=metrics, **moments, params=[p.detach().numpy() for p in params],
                ema=[e.numpy() for e in trainer.ema], before=before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cli_root = str(tmp_path_factory.mktemp("cli"))
    base = _cli_args(cli_root)
    cli = _start_cli(cli_root, base)
    # the CLI on each gloo rank with an f16 teacher cache (stride 10: 5 clips
    # of 2 videos recur) and a snapshot after every step from step 1
    cached_root = str(tmp_path_factory.mktemp("cli_cached"))
    cached = dict(cache=os.path.join(cached_root, "cache"),
                  work=os.path.join(cached_root, "run"))
    cached["argv"] = base + ["--steps=4", f"--teacher-cache={cached['cache']}",
                             "--teacher-cache-stride=10", "--teacher-cache-f16",
                             "--sample-every=1"]
    jt = JaxTrainer(JaxConfig(img_size=S, fea_channels=32, stage=1, ema_decay=DECAY, lr=LR),
                    flow_ae=JaxFlowAE(**TINY_LFG))
    jt.unet = JaxUnet3D(channels=jt.in_channels, cond_pose=6, **UNET)
    ls, key = jt.config.latent_size, jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jt.unet.init, key, jnp.zeros((1, T, ls, ls, jt.in_channels)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, T, 1032)))
    flat, unravel = ravel_pytree(random_tree(shapes, 61)["params"])
    frozen = {"lfg": random_tree(jax.eval_shape(
                  functools.partial(jt.flow_ae.init_variables, img_size=S), key), 62),
              "face_loc": random_tree(jax.eval_shape(
                  jt.face_loc.init, key, jnp.zeros((1, S, S, 1))), 63)}
    state = {"params": flat, "opt_state": jt.tx.init(flat), "step": jnp.zeros((), jnp.int32),
             "frozen": frozen, "ema_params": jnp.array(flat)}
    # stage 1: 8 frames; stage 2: a 9-frame clip, 8 diffused; each stage's
    # draws replayed from its key at the diffused length
    batch, rng = _batch(T, 64), jax.random.PRNGKey(7)
    batch2, rng2 = _batch(T + 1, 65), jax.random.PRNGKey(8)

    port = DMTrainer(DMTrainConfig(stage=1, **CONFIG), flow_ae=FlowAE(**TINY_LFG),
                     unet_kw=UNET, device="cpu")
    load_dm_trainer_variables(port, unravel(np.asarray(flat)), frozen["lfg"],
                              frozen["face_loc"], unravel(np.asarray(flat)))
    weights = dict(unet=port.unet.state_dict(), flow_ae=port.flow_ae.state_dict(),
                   face_loc=port.face_loc.state_dict(), ema=[e.clone() for e in port.ema],
                   lfg=TINY_LFG, unet_kw=UNET)
    case = dict(weights, kind="train", batch=_tensors(batch),
                draws=_tensors(jax_draws(rng, B, T, ls)))
    waits = {
        2: start_ranks([dict(case, name="stage1_seq2", seq=2, config=dict(CONFIG, stage=1)),
                        dict(case, name="stage2_seq2", seq=2, config=dict(CONFIG, stage=2),
                             batch=_tensors(batch2),
                             draws=_tensors(jax_draws(rng2, B, T, ls))),
                        dict(case, name="stage1_seq2_remat_fft", seq=2,
                             config=dict(CONFIG, stage=1, **REMAT_FFT)),
                        dict(name="cli_cached", kind="dm_cli", seq=2,
                             argv=cached["argv"] + [f"--workdir={cached['work']}"])],
                       2, str(tmp_path_factory.mktemp("train2"))),
        4: start_ranks([dict(case, name="stage1_data2_seq2", seq=2,
                             config=dict(CONFIG, stage=1))],
                       4, str(tmp_path_factory.mktemp("train4")))}

    mesh, names = jax_make_mesh(2, seq_parallel=2), [n for n, _ in port.unet.named_parameters()]
    stage1 = _jax_step(1, state, unravel, batch, rng, mesh, SPEC, names)
    stage2 = _jax_step(2, state, unravel, batch2, rng2, mesh, {k: P("data") for k in SPEC},
                       names)
    remat_fft = _port_step(case, dict(CONFIG, stage=1, **REMAT_FFT), names)
    results = {world: wait() for world, wait in waits.items()}
    logs = [p.communicate(timeout=300)[0] for p in cli]
    return results, {"stage1_seq2": stage1, "stage1_data2_seq2": stage1,
                     "stage2_seq2": stage2, "stage1_seq2_remat_fft": remat_fft}, (
                         cli_root, cli, logs), cached


@pytest.mark.parametrize("world,name", [(2, "stage1_seq2"), (4, "stage1_data2_seq2"),
                                        (2, "stage2_seq2"), (2, "stage1_seq2_remat_fft")])
def test_sharded_train_step(runs, world, name):
    results, wants = runs[:2]
    want = wants[name]
    ranks = [r[name] for r in results[world]]
    for r, res in enumerate(ranks[1:], 1):
        for key in ("mu", "nu", "params", "ema"):
            for a, b in zip(res[key], ranks[0][key]):
                assert torch.equal(a, b), f"rank {r} {key} differs from rank 0"
    got = ranks[0]
    assert got["step"] == 1 and got["metrics"]["grads_finite"] == 1.0
    for k in ("loss", "floss", "mouth_loss", "total"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-4, err_msg=k)
    mu_max = max(np.abs(m).max() for m in want["mu"])
    nu_max = max(np.abs(m).max() for m in want["nu"])
    for i, (mu, nu, p, e) in enumerate(zip(got["mu"], got["nu"], got["params"], got["ema"])):
        np.testing.assert_allclose(mu.numpy(), want["mu"][i], atol=1e-3 * mu_max, rtol=0,
                                   err_msg=f"mu {i}")
        np.testing.assert_allclose(nu.numpy(), want["nu"][i], atol=1e-3 * nu_max, rtol=0,
                                   err_msg=f"nu {i}")
        clear = np.abs(want["mu"][i]) > 1e-3 * mu_max
        old = want["before"][i]
        for label, value, w, scale in (("param", p, want["params"][i], 1.0),
                                       ("ema", e, want["ema"][i], 1 - DECAY)):
            diff = np.abs(value.numpy() - w)
            assert diff.max() <= scale * 2 * LR + 1e-7, f"{label} {i}: {diff.max()}"
            assert (diff[clear] <= 1e-7 + 1e-6 * np.abs(old[clear])).all(), f"{label} {i}"


def test_cli_two_ranks(runs):
    import json
    root, procs, logs = runs[2]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    assert "mesh {'data': 1, 'seq': 2}" in logs[0] and "mesh" not in logs[1]
    work = os.path.join(root, "run")
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [0, 1]
    assert all(np.isfinite(x["total"]) and x["grads_finite"] == 1.0 for x in lines)
    assert os.listdir(os.path.join(work, "ckpt")) == ["step_0000002.pt"]


def test_cli_two_ranks_teacher_cache_and_snapshots(runs, tmp_path):
    """The snapshots, taken on rank 0 alone, leave the ranks' generators
    alike, so every step's draws agree; with the f16 teacher cache every rank
    reads each step's entries back from disk, so the run equals one process
    on the entries it stored."""
    import json
    from PIL import Image
    from dawn_tpu_torch.scripts import train_dm

    results, cached = runs[0], runs[3]
    ranks = [r["cli_cached"] for r in results[2]]
    assert ranks[0]["step"] == ranks[1]["step"] == 4
    assert torch.equal(ranks[0]["generator"], ranks[1]["generator"])
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))
    lines = [json.loads(x) for x in open(os.path.join(cached["work"], "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [0, 1, 2, 3]
    assert lines[0]["teacher_cache_hit_rate"] < lines[-1]["teacher_cache_hit_rate"]
    for step in (1, 2, 3):
        with Image.open(os.path.join(cached["work"], "imgshots",
                                     f"step_{step:07d}.png")) as png:
            assert png.size == (4 * S, 7 * S)
    single = str(tmp_path / "single")
    train_dm.main(cached["argv"] + [f"--workdir={single}"])
    want = [json.loads(x) for x in open(os.path.join(single, "metrics.jsonl"))]
    assert [x["teacher_cache_hit_rate"] for x in want] == [1.0] * 4
    for got, w in zip(lines, want):
        for k in ("loss", "floss", "mouth_loss", "total"):
            np.testing.assert_allclose(got[k], w[k], rtol=1e-4, err_msg=(got["step"], k))


def test_cli_frame_check():
    with pytest.raises(ValueError, match="win_width=20"):
        check_seq_frames([20], 2, 20)              # configs/dm_train_stage1.yaml
    with pytest.raises(ValueError, match="35 diffused frames"):
        check_seq_frames([30, 35, 40][1:], 2, 15)
    check_seq_frames([40], 2, 20)
    check_seq_frames([20], 1, 20)
