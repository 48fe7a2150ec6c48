"""The port's batch pipeline CLIs on the CPU (``--device cpu``), assetless
at a tiny topology: ``ood_test --metrics`` over 2 (portrait, 1.2 s WAV)
pairs, then ``eval_quality --released`` over the same pairs with a
reference dir of ``ood_test``'s PNG frames saved as ``<tag>.npy``.

HuBERT is shrunk as in ``test_torch_pipeline.py``, the PBnets run at their
shipped width, the DAWN model at ``dim_mults`` (1, 2) with a one-block LFG
bottleneck (``FlowDiffusionConfig``'s defaults patched), 32^2, 2 DDIM
steps. Checked: the cache files and 30 PNGs of each pair, metrics.json's
keys (identity accuracy, diversity, multimodality, the AV-sync proxy, per
identity); the released report's keys, and, the weights, seed and inputs
being ``ood_test``'s, every ``per_video_l1`` and the L1 exactly 0.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from dawn_tpu_torch.models.dm import flow_diffusion
from dawn_tpu_torch.models.hubert import HubertConfig
from dawn_tpu_torch.scripts import eval_quality, ood_test
from test_torch_pipeline import HUBERT
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

S = 32


@pytest.fixture()
def tiny_pipeline(monkeypatch, tmp_path):
    """HuBERT and the DAWN model shrunk; one 1.2 s WAV and two portraits."""
    from PIL import Image
    from scipy.io import wavfile
    monkeypatch.setattr(HubertConfig, "large", classmethod(lambda cls: cls(**HUBERT)))
    small = dataclasses.replace(flow_diffusion.FlowDiffusionConfig(), dim_mults=(1, 2),
                                lfg_max_features=256, lfg_num_bottleneck=1)
    monkeypatch.setattr(flow_diffusion, "FlowDiffusionConfig",
                        lambda **kw: dataclasses.replace(small, **kw))
    rng = np.random.RandomState(0)
    wav = str(tmp_path / "speech.wav")
    wavfile.write(wav, 16000, (rng.randn(int(16000 * 1.2)) * 3000).astype(np.int16))
    pairs = tmp_path / "pairs.txt"
    lines = []
    for i in range(2):
        img = str(tmp_path / f"face{i}.png")
        Image.fromarray((rng.rand(40, 40, 3) * 255).astype(np.uint8)).save(img)
        lines.append(f"{img} {wav}\n")
    pairs.write_text("".join(lines))
    return str(pairs)


def test_ood_test_then_released_eval(tiny_pipeline, tmp_path):
    base = ["--pairs", tiny_pipeline, "--resolution", str(S), "--sampling-step", "2",
            "--win-width", "4", "--device", "cpu"]
    ood = ood_test.main(base + ["--output", str(tmp_path / "ood"), "--cache",
                                str(tmp_path / "cache"), "--metrics"])
    t = 30                                     # 1.2 s at 25 fps
    assert len(ood["seconds"]) == 2
    refs = tmp_path / "refs"
    refs.mkdir()
    for i in range(2):
        tag = f"face{i}_speech"
        for name, shape in (("init_pose", (1, 7)), ("init_eye_bbox", (1, 8)),
                            ("target_audio", (t, 1024)), ("dri_pose", (t, 6)),
                            ("dri_blink", (t, 2))):
            assert np.load(tmp_path / "cache" / tag / f"{name}.npy").shape == shape
        img_dir = str(tmp_path / "ood" / tag / f"face{i}" / "img")
        assert len(os.listdir(img_dir)) == t
        frames = ood_test.load_frames(img_dir, S)
        np.save(refs / f"{tag}.npy", np.round(frames * 255).astype(np.uint8))
    with open(tmp_path / "ood" / "metrics.json") as f:
        report = json.load(f)
    assert report == json.loads(json.dumps(ood["report"]))
    for k in ("diversity", "multimodality", "identity_accuracy", "identity_confusion",
              "sync_av_corr", "sync_av_offset", "sync_av_margin", "lip_note", "per_identity"):
        assert k in report, k
    assert set(report["per_identity"]) == {"0", "1"} and np.isfinite(report["diversity"])

    out = tmp_path / "released.json"
    released = eval_quality.main(base + ["--released", "--reference-dir", str(refs),
                                         "--output", str(tmp_path / "rel"), "--cache",
                                         str(tmp_path / "cache_rel"), "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(released))
    for k in ("fvd_lfg_frames", "fvd_lfg_videos", "l1", "mouth_l1", "mouth_ssim", "av_corr",
              "av_sync_reference", "per_video_l1", "assets"):
        assert k in released, k
    assert released["per_video_l1"] == {"face0_speech": 0.0, "face1_speech": 0.0}
    assert released["l1"] == 0.0 and released["assets"]["released_weights"] is False
