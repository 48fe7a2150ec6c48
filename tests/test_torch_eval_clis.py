"""The port's evaluation CLIs on the CPU (``--device cpu``) at tiny configs
(``ood_test`` and ``eval_quality --released``: test_torch_ood_clis.py).

- ``eval_lfg`` (``FlowAE`` patched to the tiny widths of
  ``test_torch_lfg_teacher.py``, a checkpoint in the reference layout) on
  chip_smoke.py's synthetic chunked-npy tree: recon_losses.json over the
  held-out names and one side-by-side mp4 each;
- ``eval_pbnet --stgcn`` (a reemb6 pose model saved as
  ``checkpoint_*.pth.tar`` + ``opt.yaml``, 2 seeds): the dumps of every
  seed, and metrics.json equal to the JAX package's metric functions
  applied to the dumps the port wrote, and for the first seed to its
  ``STGCNEvaluation`` on the port's seeded recognizer (through
  ``convert_stgcn``);
- ``eval_quality`` in dir mode, with mouth landmarks and an 1/8-width
  I3D ``--i3d-ckpt``: the report's keys, finite;
- ``extract_audio_features --features mel_f0``: one npz per wav, equal to
  ``extract_mel_f0`` of the wav; ``--features hubert`` without
  ``--hubert-dir`` is refused.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chip_smoke import write_hdtf_tree
from dawn_tpu.evaluate import metrics as jax_metrics
from dawn_tpu.evaluate import stgcn_eval as jax_stgcn_eval
from dawn_tpu.models.pbnet import stgcn as jax_stgcn
from dawn_tpu.weights.torch_convert import convert_stgcn
from dawn_tpu_torch.evaluate.i3d import InceptionI3d
from dawn_tpu_torch.evaluate.stgcn_eval import make_dawn_head_stgcn
from dawn_tpu_torch.models.lfg import flow_ae
from dawn_tpu_torch.pipeline.audio import read_wav_16k
from dawn_tpu_torch.pipeline.mel_f0 import extract_mel_f0
from dawn_tpu_torch.pipeline.pose_blink import build_for
from dawn_tpu_torch.scripts import eval_lfg, eval_pbnet, eval_quality, extract_audio_features
from dawn_tpu_torch.train.data import HDTF_TEST_SPLIT
from dawn_tpu_torch.weights.checkpoints import lfg_reference_state, save_pbnet_checkpoint
from test_torch_lfg_teacher import TINY
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

S = 32
HELD_OUT = {"WDA_KatieHill_000": 30, "RD_Radio14_000": 27, "WRA_MarcoRubio_000": 40}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hdtf"))
    write_hdtf_tree(root, {**HELD_OUT, "vid_000": 26}, S, seed=5)
    return root


def test_eval_lfg(tree, tmp_path, monkeypatch):
    tiny = functools.partial(flow_ae.FlowAE, **TINY)
    monkeypatch.setattr(flow_ae, "FlowAE", tiny)
    torch.manual_seed(0)
    torch.save(lfg_reference_state(tiny()), tmp_path / "LFG.pth")
    work = tmp_path / "lfg_eval"
    losses = eval_lfg.main(["--lfg-ckpt", str(tmp_path / "LFG.pth"), "--frames-dir",
                            os.path.join(tree, "frames"), "--img-size", str(S), "--workdir",
                            str(work), "--write-videos", "--num-videos", "2", "--device", "cpu"])
    with open(work / "recon_losses.json") as f:
        written = json.load(f)
    assert written == losses and len(losses) == 2 and set(losses) < set(HELD_OUT)
    assert all(np.isfinite(v) and v > 0 for v in losses.values())
    assert sorted(os.listdir(work / "videos")) == sorted(f"{n}.mp4" for n in losses)


def test_eval_pbnet_stgcn_matches_jax_metrics(tree, tmp_path, monkeypatch):
    torch.manual_seed(1)
    (tmp_path / "pose").mkdir()
    ckpt = str(tmp_path / "pose" / "checkpoint_1.pth.tar")
    save_pbnet_checkpoint(build_for({}, 6, 0, "cpu"), ckpt)
    (tmp_path / "pose" / "opt.yaml").write_text("archiname: transformerreemb6\n")
    work = str(tmp_path / "pbnet_eval")
    flags = [f"--{k}-dir={os.path.join(tree, k)}" for k in ("hubert", "pose", "eye")]
    out = eval_pbnet.main(["--ckpt", ckpt, *flags, f"--length-dict={tree}/length_dict.pkl",
                           "--workdir", work, "--niter", "2", "--num-frames", "16", "--stgcn",
                           "--device", "cpu"])
    with open(os.path.join(work, "metrics.json")) as f:
        written = json.load(f)
    assert sorted(written) == ["0", "1"]
    recognizer = make_dawn_head_stgcn(3, torch.Generator().manual_seed(1234), device="cpu")
    cv = convert_stgcn(recognizer.state_dict())
    jm = jax_stgcn.STGCN(in_channels=1, num_class=3, graph=cv["graph"])
    variables = {"params": cv["params"], "batch_stats": cv["batch_stats"]}
    fwd = jax.jit(lambda x: jm.apply(variables, x))
    # JAX's compute_features traces a new program per call: one compiled
    # program for the four calls of an evaluation keeps the test short
    monkeypatch.setattr(jax_stgcn_eval, "compute_features", lambda m, v, x, batch_size: tuple(
        np.asarray(a) for a in fwd(jnp.asarray(x, jnp.float32)).values()))
    jax_eval = jax_stgcn_eval.STGCNEvaluation(jm, variables, 3)
    order = [n for n in HDTF_TEST_SPLIT if n in HELD_OUT]     # the dataset's order
    for seed in ("0", "1"):
        m = written[seed]
        assert m == out[int(seed)]
        assert sorted(os.listdir(os.path.join(work, "eval_pred", seed))) == sorted(
            f"{n}.npy" for n in HELD_OUT)
        preds = [np.load(os.path.join(work, "eval_pred", seed, f"{n}.npy")) for n in order]
        gts = [np.load(os.path.join(work, "eval_gt", seed, f"{n}.npy")) for n in order]
        assert all(p.shape == (16, 6) for p in preds + gts)
        fp, fg = np.stack([p.mean(0) for p in preds]), np.stack([g.mean(0) for g in gts])
        want = {
            "fid": jax_metrics.frechet_distance(fp, fg),
            "diversity_pred": jax_metrics.diversity(fp),
            "diversity_gt": jax_metrics.diversity(fg),
            "smoothness_pred": np.mean([jax_metrics.temporal_smoothness(p) for p in preds]),
            "smoothness_gt": np.mean([jax_metrics.temporal_smoothness(g) for g in gts]),
            "l1": np.mean([jax_metrics.l1_reconstruction(p, g) for p, g in zip(preds, gts)]),
            "acceleration_pred": jax_metrics.mean_acceleration(preds),
            "acceleration_gt": jax_metrics.mean_acceleration(gts),
        }
        if seed == "0":                 # JAX's STGCN suite on the first seed's dumps
            # (T, 6) sequences as 8-node dawn_head motions, the blink nodes zero
            motion = lambda x: np.pad(np.stack(x), ((0, 0), (0, 0), (0, 2)))[..., None]  # noqa
            labels = np.arange(3)
            sm = jax_eval.evaluate({"gt": {s: (motion(gts), labels) for s in ("train", "test")},
                                    "gen": {s: (motion(preds), labels)
                                            for s in ("train", "test")}})
            want.update({f"stgcn_{k}": v for k, v in sm.items() if k.endswith("_test")})
        assert sorted(k for k in m if not k.startswith("stgcn_") or seed == "0") == sorted(want)
        assert len(m) == 16
        for k, v in want.items():
            if k.startswith("stgcn_fid_gt"):
                assert abs(m[k]) < 1e-4 and abs(v) < 1e-4, (k, m[k], v)
            else:
                np.testing.assert_allclose(m[k], v, rtol=1e-4, atol=1e-9, err_msg=f"{seed} {k}")


def _videos(seed, n, t):
    return (np.random.RandomState(seed).rand(n, t, S, S, 3) * 255).astype(np.uint8)


def test_eval_quality_dirs(tmp_path):
    for d in ("real", "fake", "mouth"):
        (tmp_path / d).mkdir()
    real, fake = _videos(0, 2, 10), _videos(1, 2, 10)
    rng = np.random.RandomState(2)
    for i in range(2):
        np.save(tmp_path / "real" / f"v{i}.npy", real[i])
        np.save(tmp_path / "fake" / f"v{i}.npy", fake[i].astype(np.float32) / 255.0)
        np.save(tmp_path / "mouth" / f"v{i}.npy",
                (np.array([16.0, 22.0]) + 3 * rng.randn(10, 20, 2)).astype(np.float32))
    torch.manual_seed(3)
    torch.save(InceptionI3d(50, width_divisor=8).state_dict(), tmp_path / "i3d.pt")
    out = tmp_path / "q.json"
    report = eval_quality.main(["--real-dir", str(tmp_path / "real"), "--fake-dir",
                                str(tmp_path / "fake"), "--mouth-lmk-dir", str(tmp_path / "mouth"),
                                "--i3d-ckpt", str(tmp_path / "i3d.pt"), "--out", str(out),
                                "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(report) == {"fvd_lfg_frames", "fvd_lfg_videos", "l1", "mouth_l1", "mouth_ssim",
                           "fvd_i3d", "per_video_l1"}
    assert set(report["per_video_l1"]) == {"v0", "v1"}
    assert all(np.isfinite(v) for k, v in report.items() if k != "per_video_l1")


def test_extract_audio_features_mel_f0(tmp_path):
    from scipy.io import wavfile
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.RandomState(1)
    for name, sr in (("a", 16000), ("b", 44100)):
        wavfile.write(wav_dir / f"{name}.wav", sr, (rng.randn(sr) * 3000).astype(np.int16))
    (wav_dir / "notes.txt").write_text("not audio")
    out = tmp_path / "feats"
    assert extract_audio_features.main(["--wav-dir", str(wav_dir), "--out-dir", str(out),
                                        "--features", "mel_f0", "--device", "cpu"]) == [
        "a.wav", "b.wav"]
    assert sorted(os.listdir(out)) == ["a_mel_f0.npz", "b_mel_f0.npz"]
    for name in ("a", "b"):
        got = np.load(out / f"{name}_mel_f0.npz")
        want = extract_mel_f0(read_wav_16k(str(wav_dir / f"{name}.wav")))
        assert sorted(got.files) == ["f0", "f0_coarse", "mel"]
        for k, w in zip(("mel", "f0", "f0_coarse"), want):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    with pytest.raises(SystemExit):
        extract_audio_features.main(["--wav-dir", str(wav_dir), "--out-dir", str(out)])
