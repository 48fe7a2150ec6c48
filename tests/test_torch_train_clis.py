"""The port's LFG and PBnet training CLIs on the CPU, and --tensorboard.

``python -m dawn_tpu_torch.scripts.train_lfg`` (a tiny copy of
configs/lfg_hdtf128.yaml: the tiny FlowAE widths, scales (1, 0.5), batch 2)
and ``python -m dawn_tpu_torch.scripts.train_pbnet --kind pose|blink`` (the
shipped widths, batch 2 x 16 frames) run 2 steps each with ``--device cpu``
on chip_smoke.py's synthetic chunked-npy tree (32x32 frames). Then:

- the LFG checkpoint loads strictly through ``FlowAE.load_reference_checkpoint``
  and ``load_lfg_generator``, and holds the trainer's nets bit for bit;
- ``load_pbnet_with_opt`` rebuilds each PBnet from its opt.yaml and
  ``checkpoint_<step>.pth.tar``, equal to the trained G, and the two give
  finite drives through ``drives_separate``;
- ``--restore`` resumes each run at its saved step;
- the TensorBoard event files parse with TensorBoard's own loader (the LFG
  and PBnet runs, and one step of the DM CLI with ``--tensorboard``);
- the LFG CLI raises on a config flag the port does not implement;
- the DM CLI's ``--prefetch`` run logs the same metrics, bit for bit, as the
  run without it; ``--teacher-cache`` (stride 20, so that the 4-frame clips
  of 3 short videos recur) with ``remat: full`` from the yaml and
  ``--sample-every 2`` logs a teacher-cache hit rate above 0, writes a
  7-panel x 4-frame PNG and f32 cache entries; ``--teacher-cache-f16``
  writes f16 entries.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import write_hdtf_tree
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.pipeline.pose_blink import drives_separate, load_pbnet_with_opt
from dawn_tpu_torch.scripts import train_dm, train_lfg, train_pbnet
from dawn_tpu_torch.weights.checkpoints import load_lfg_generator
from test_torch_data import _config as dm_config
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 32
TINY = dict(generator_kw=dict(block_expansion=8, max_features=32, num_bottleneck_blocks=1),
            region_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            bg_kw=dict(block_expansion=4, max_features=16, num_blocks=2),
            flow_kw=dict(block_expansion=4, max_features=16, num_blocks=2))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hdtf"))
    flags = write_hdtf_tree(root, {"vid_000": 40, "vid_001": 30, "vid_002": 26}, S, seed=3)
    return dict(f[2:].split("=", 1) for f in flags), flags


def scalars(logdir):
    """(tag, step) of every scalar in the event files under ``logdir``."""
    loader = pytest.importorskip("tensorboard.backend.event_processing.event_file_loader")
    (name,) = os.listdir(logdir)
    events = list(loader.EventFileLoader(os.path.join(logdir, name)).Load())
    assert events[0].file_version == "brain.Event:2"
    return [(v.tag, e.step) for e in events[1:] for v in e.summary.value]


def lfg_config(tmp_path):
    with open(os.path.join(ROOT, "configs", "lfg_hdtf128.yaml")) as f:
        cfg = yaml.safe_load(f)
    mp = cfg["model_params"]
    mp["generator_params"].update(block_expansion=8, max_features=32, num_bottleneck_blocks=1)
    mp["generator_params"]["pixelwise_flow_predictor_params"].update(
        block_expansion=4, max_features=16, num_blocks=2)
    for key in ("region_predictor_params", "bg_predictor_params"):
        mp[key].update(block_expansion=4, max_features=16, num_blocks=2)
    cfg["train_params"].update(scales=[1, 0.5], batch_size=2)
    path = str(tmp_path / "lfg_tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.mark.parametrize("where,key,value,error", [
    (None, "estimate_affine", False, NotImplementedError),
    ("generator_params", "skips", False, NotImplementedError),
    ("region_predictor_params", "pca_based", False, NotImplementedError),
    ("pixelwise_flow_predictor_params", "estimate_occlusion_map", False, NotImplementedError),
    ("bg_predictor_params", "not_an_argument", 1, ValueError),
])
def test_lfg_config_flags_the_port_lacks_raise(where, key, value, error):
    """The shipped configs' model_params map onto FlowAE; a flag set to a
    value the port does not implement, or an entry no port net takes,
    raises instead of training another model."""
    with open(os.path.join(ROOT, "configs", "lfg_hdtf128.yaml")) as f:
        mp = yaml.safe_load(f)["model_params"]
    kw = train_lfg.flow_ae_kwargs(mp)
    assert kw["num_regions"] == 10 and kw["region_kw"]["scale_factor"] == 0.25
    assert all(kw[k]["train_bn"] for k in ("generator_kw", "region_kw", "bg_kw", "flow_kw"))
    target = (mp if where is None else mp["generator_params"][where]
              if where == "pixelwise_flow_predictor_params" else mp[where])
    target[key] = value
    with pytest.raises(error, match=key):
        train_lfg.flow_ae_kwargs(mp)


def test_lfg_cli_checkpoint_loads_and_resumes(tree, tmp_path):
    dirs, _ = tree
    work = str(tmp_path / "lfg")
    base = [f"--config={lfg_config(tmp_path)}", f"--frames-dir={dirs['frames-dir']}",
            "--device=cpu", "--log-every=1", f"--workdir={work}"]
    trainer = train_lfg.main(base + ["--steps=2", "--tensorboard"])
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [0, 1] and trainer.step == 2
    assert all(np.isfinite(x[k]) for x in lines for k in ("total", "perceptual",
                                                          "equivariance_shift",
                                                          "equivariance_affine"))
    path = train_lfg.latest_checkpoint(os.path.join(work, "ckpt"))
    assert path.endswith("LFG_0000002.pth")
    fresh = FlowAE(**TINY)
    fresh.load_reference_checkpoint(path)
    for k, v in trainer.flow_ae.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert load_lfg_generator(FlowAE(**TINY), path) == sorted(
        f"pixelwise_flow_predictor.{k}"
        for k in trainer.flow_ae.pixelwise_flow_predictor.state_dict())
    assert ("train/perceptual", 1) in scalars(os.path.join(work, "tb"))
    resumed = train_lfg.main(base + ["--steps=3", "--restore"])
    assert resumed.step == 3
    assert json.loads(open(os.path.join(work, "metrics.jsonl")).readlines()[-1])["step"] == 2


def test_pbnet_cli_checkpoints_generate_and_resume(tree, tmp_path):
    dirs, _ = tree
    work = str(tmp_path / "pbnet")
    data = [f"--{k}={dirs[k]}" for k in ("hubert-dir", "pose-dir", "eye-dir", "length-dict")]
    base = data + ["--device=cpu", "--batch-size=2", "--num-frames=16", "--log-every=1",
                   f"--workdir={work}"]
    trained = {kind: train_pbnet.main(base + [f"--kind={kind}", "--steps=2", "--tensorboard"])
               for kind in ("pose", "blink")}
    models = {}
    for kind, dims in (("pose", (6, 0)), ("blink", (2, 0))):
        lines = [json.loads(x) for x in open(os.path.join(work, kind, "metrics.jsonl"))]
        assert [x["step"] for x in lines] == [0, 1]
        assert all(np.isfinite(x[k]) for x in lines for k in ("g_total", "d_loss", "rc", "kl"))
        opt = yaml.safe_load(open(os.path.join(work, kind, "opt.yaml")))
        assert opt["archiname"] == "transformerreemb6" and opt["lambdas"]["reg"] == 0.1
        ckpt = os.path.join(work, kind, "checkpoint_2.pth.tar")
        models[kind] = load_pbnet_with_opt(ckpt, *dims, "cpu")
        for k, v in trained[kind].model.state_dict().items():
            assert torch.equal(models[kind].state_dict()[k], v), (kind, k)
        assert ("train/g_total", 1) in scalars(os.path.join(work, kind, "tb"))
    r = np.random.RandomState(0)
    pose, blink = drives_separate(models["pose"], models["blink"],
                                  r.randn(24, 1024).astype(np.float32),
                                  np.array([[5.0, -3.0, 2.0, 0.5, 60.0, 70.0]], np.float32),
                                  np.array([[0.3, 0.28]], np.float32))
    assert pose.shape == (24, 6) and blink.shape == (24, 2)
    assert np.isfinite(pose).all() and np.isfinite(blink).all()
    resumed = train_pbnet.main(base + ["--kind=pose", "--steps=3", "--restore"])
    assert resumed.step == 3
    assert os.path.isfile(os.path.join(work, "pose", "checkpoint_3.pth.tar"))


def test_dm_cli_tensorboard(tree, tmp_path):
    _, flags = tree
    work = str(tmp_path / "dm")
    trainer = train_dm.main([f"--config={dm_config(tmp_path)}", *flags, "--device=cpu",
                             "--steps=1", "--log-every=1", f"--workdir={work}", "--tensorboard"])
    assert trainer.step == 1
    tags = scalars(os.path.join(work, "tb"))
    assert ("train/total", 0) in tags and ("train/loss", 0) in tags


def _dm_run(tmp_path, flags, name, extra, config=None):
    work = str(tmp_path / name)
    trainer = train_dm.main([f"--config={config or dm_config(tmp_path)}", *flags,
                             "--device=cpu", "--log-every=1", f"--workdir={work}", *extra])
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    return trainer, work, lines


def test_dm_cli_prefetch_matches_plain(tree, tmp_path):
    _, flags = tree
    _, _, plain = _dm_run(tmp_path, flags, "plain", ["--steps=2"])
    _, _, pre = _dm_run(tmp_path, flags, "pre", ["--steps=2", "--prefetch"])
    keys = ("total", "loss", "floss", "mouth_loss", "grad_norm", "frames")
    assert [{k: x[k] for k in keys} for x in pre] == [{k: x[k] for k in keys} for x in plain]


def test_dm_cli_teacher_cache_remat_and_snapshot(tree, tmp_path):
    from PIL import Image

    _, flags = tree
    config = dm_config(tmp_path)
    cfg = yaml.safe_load(open(config))
    cfg["remat"] = "full"
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    cache = str(tmp_path / "cache")
    trainer, work, lines = _dm_run(tmp_path, flags, "cached", [
        "--steps=4", f"--teacher-cache={cache}", "--teacher-cache-stride=20",
        "--sample-every=2"], config)
    assert trainer.config.remat == "full" and trainer.step == 4
    assert [x["step"] for x in lines] == [0, 1, 2, 3]
    assert all(np.isfinite(x["total"]) for x in lines)
    assert lines[0]["teacher_cache_hit_rate"] == 0.0 and lines[-1]["teacher_cache_hit_rate"] > 0
    assert all(x["frames"] == 4 for x in lines)
    with Image.open(os.path.join(work, "imgshots", "step_0000002.png")) as png:
        assert png.size == (4 * S, 7 * S)
    entries = sorted(os.listdir(cache))
    assert entries and all(e.endswith(".npz") and int(e[-10:-4]) % 20 == 0 for e in entries)
    with np.load(os.path.join(cache, entries[0])) as z:
        assert sorted(z.files) == ["real_vid_conf", "real_vid_grid", "ref_img_fea"]
        assert all(z[k].dtype == np.float32 for k in z.files)


def test_dm_cli_teacher_cache_f16(tree, tmp_path):
    _, flags = tree
    cache = str(tmp_path / "cache16")
    trainer, _, lines = _dm_run(tmp_path, flags, "f16", [
        "--steps=2", f"--teacher-cache={cache}", "--teacher-cache-f16"])
    assert trainer.step == 2 and "teacher_cache_hit_rate" in lines[-1]
    for entry in os.listdir(cache):
        with np.load(os.path.join(cache, entry)) as z:
            assert all(z[k].dtype == np.float16 for k in z.files)
