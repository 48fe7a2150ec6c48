"""The port's DM data reader and training CLI on the CPU.

``HDTFVideoDataset`` of the port against the JAX package's on a synthetic
chunked-npy tree (chip_smoke.py's writer: uint8 frames, f32 hubert, pose,
eye and lmk, 25-frame chunks, one video shorter than a clip, one name from
the held-out split): the same seed gives the same batches, exactly, with and
without landmarks. Then ``python -m dawn_tpu_torch.scripts.train_dm`` on
the CPU at a tiny topology (yaml ``unet:``/``lfg:`` overrides, 32x32, 4
frames): two stage-1 steps log finite metrics and save a checkpoint,
``--restore`` resumes from it, stage 2 runs a step, and the teacher-cache,
prefetch and snapshot flags parse to the JAX script's values (their runs:
tests/test_torch_train_clis.py). Also ``FramesDataset`` against the JAX
package's in test mode on that tree plus a PNG-folder video and .npy videos:
the same whole videos, resized or not, and the same held-out order.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import write_hdtf_tree
from dawn_tpu.train.data import HDTFVideoDataset as JaxDataset
from dawn_tpu_torch.scripts import train_dm as cli
from dawn_tpu_torch.train.data import HDTFVideoDataset
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

S = 32
LENGTHS = {"vid_000": 60, "vid_001": 30, "vid_002": 12, "vid_003": 51,
           "WDA_KatieHill_000": 40}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hdtf"))
    return root, write_hdtf_tree(root, LENGTHS, S, seed=3)


def _dirs(root, lmk):
    return [os.path.join(root, k) for k in ("frames", "hubert", "pose", "eye")] + [
        os.path.join(root, "length_dict.pkl")], dict(
            lmk_dir=os.path.join(root, "lmk") if lmk else None)


@pytest.mark.parametrize("lmk,num_frames", [(True, 20), (False, 41), (True, 60)])
def test_batches_match_jax(tree, lmk, num_frames):
    root, _ = tree
    args, kw = _dirs(root, lmk)
    ours = HDTFVideoDataset(*args, num_frames=num_frames, seed=5, **kw)
    theirs = JaxDataset(*args, num_frames=num_frames, seed=5, **kw)
    assert ours.videos == theirs.videos and "WDA_KatieHill_000" not in ours.videos
    for a, b in zip(ours.batches(3, 4), theirs.batches(3, 4)):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _config(tmp_path):
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "dm_train_stage1.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(img_size=S, num_frames=4, batch_size=2, fea_channels=32,
               num_frames_min=3, num_frames_max=4, frame_buckets=[3, 4],
               unet=dict(dim=16, dim_mults=[1, 2], win_width=2),
               lfg=dict(generator=dict(block_expansion=8, max_features=32,
                                       num_bottleneck_blocks=1),
                        region=dict(block_expansion=4, max_features=16, num_blocks=2),
                        bg=dict(block_expansion=4, max_features=16, num_blocks=2),
                        flow=dict(block_expansion=4, max_features=16, num_blocks=2)))
    path = os.path.join(tmp_path, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_cli_trains_restores_and_runs_stage2(tree, tmp_path):
    _, flags = tree
    work = str(tmp_path / "run")
    base = [f"--config={_config(tmp_path)}", *flags, "--device=cpu", "--log-every=1",
            f"--workdir={work}"]
    trainer = cli.main(base + ["--steps=2"])
    assert trainer.step == 2
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [0, 1]
    assert all(np.isfinite(x[k]) for x in lines for k in ("total", "loss", "floss",
                                                          "mouth_loss"))
    ckpt = cli.latest_checkpoint(os.path.join(work, "ckpt"))
    assert ckpt.endswith("step_0000002.pt")
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 2 and saved["scheduler"]["last_epoch"] == 2
    resumed = cli.main(base + ["--steps=3", "--restore"])
    assert resumed.step == 3
    assert json.loads(open(os.path.join(work, "metrics.jsonl")).readlines()[-1])["step"] == 2
    stage2 = cli.main(base + ["--steps=1", "--stage=2", f"--workdir={work}2"])
    line = json.loads(open(os.path.join(f"{work}2", "metrics.jsonl")).readline())
    assert stage2.step == 1 and line["frames"] in (4, 5)


@pytest.mark.parametrize("flag", ["--teacher-cache=x", "--prefetch", "--teacher-cache-stride=2",
                                  "--sample-every=10"])
def test_cli_unported_flags_raise(tree, flag):
    """These flags raised until they were ported (the name is kept); now each
    parses to its value, and the others keep the JAX script's defaults."""
    _, flags = tree
    args = cli.parse_args([*flags, flag])
    name, _, value = flag[2:].partition("=")
    got = getattr(args, name.replace("-", "_"))
    assert got == (True if not value else int(value) if value.isdigit() else value)
    defaults = dict(teacher_cache=None, prefetch=False, teacher_cache_stride=None,
                    sample_every=1000, teacher_cache_f16=False)
    for k, v in defaults.items():
        if k != name.replace("-", "_"):
            assert getattr(args, k) == v, k


@pytest.fixture(scope="module")
def frames_root(tree, tmp_path_factory):
    """The tree's chunked-npy videos plus a PNG-folder video and three .npy
    videos."""
    import cv2
    root, _ = tree
    frames = str(tmp_path_factory.mktemp("frames_root"))
    rng = np.random.RandomState(9)
    for name in sorted(os.listdir(os.path.join(root, "frames"))):
        os.symlink(os.path.join(root, "frames", name), os.path.join(frames, name))
    os.makedirs(os.path.join(frames, "pngs"))
    for i in range(5):
        cv2.imwrite(os.path.join(frames, "pngs", f"{i:03d}.png"),
                    (rng.rand(S, S, 3) * 255).astype(np.uint8))
    np.save(os.path.join(frames, "clip.npy"), (rng.rand(7, S, S, 3) * 255).astype(np.uint8))
    for k in range(2):
        np.save(os.path.join(frames, f"person#{k}.npy"),
                (rng.rand(4 + k, S, S, 3) * 255).astype(np.uint8))
    return frames


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("size", [S, 24])
def test_frames_dataset_matches_jax(frames_root, size):
    """FramesDataset of the port against the JAX package's in test mode: the
    same videos in the same order, whole and resized (cv2's INTER_AREA at
    24^2) or not, and the held-out order is the JAX script's."""
    from dawn_tpu.train import data as jax_data
    from dawn_tpu_torch.train import data

    ours = data.FramesDataset(frames_root, image_size=size)
    theirs = jax_data.FramesDataset(frames_root, mode="test", image_size=size)
    assert ours.videos == theirs.videos and len(ours) == len(theirs)
    for i in range(len(ours)):
        _same(ours.sample(i), theirs.sample(i))
    held = [i for i, v in enumerate(theirs.videos) if v in jax_data.HDTF_TEST_SPLIT]
    assert held and ours.held_out() == held
