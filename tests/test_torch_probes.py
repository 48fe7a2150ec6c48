"""The port's profiling utilities and its probe scripts on the CPU.

- ``utils/profiling.py``: ``Timer``, ``PhaseTimer`` and
  ``LoadAnomalyMonitor`` print the same lines as the JAX package's under
  the same (faked) clock; ``device_trace`` writes a TensorBoard trace;
  ``card_peaks`` and ``band_pairs`` give the numbers ``chip_smoke.py``'s
  kernel bounds were computed with.
- ``FlowDiffusion.sample_latents`` then ``decode_latents`` (the two phases
  ``profile_sample`` times) give ``sample_one_video``'s bits.
- each script's flags (the JAX script's defaults, ``--device`` in place of
  ``--platform``) and one tiny ``--device cpu`` call (32^2, a few frames,
  2 DDIM steps, f32), where every kernel wrapper runs its plain version.
"""

import itertools
import os
import time

import numpy as np
import pytest
import torch
import yaml

from dawn_tpu.utils import profiling as jax_profiling
from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.scripts import (make_golden, probe_micro, probe_packed_compile,
                                    probe_train_phases, probe_unet_phases, profile_sample,
                                    smoke_e2e)
from dawn_tpu_torch.utils import profiling
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive(module, monkeypatch):
    """Print every line of the profiling classes under a clock that moves
    0.375 s a reading; returns the summary."""
    for name in ("time", "perf_counter"):
        ticks = itertools.count()
        monkeypatch.setattr(time, name, lambda ticks=ticks: 0.375 * next(ticks))
    timer = module.Timer()
    timer.tic()
    print(timer.toc(), timer.toc(average=False), timer.calls)
    pt = module.PhaseTimer(verbose=True)
    for name in ("ddim", "ae", "ddim"):
        with pt.phase(name):
            pass
    monitor = module.LoadAnomalyMonitor(threshold_s=0.5)
    monitor.reset()
    print(monitor.check(3), monitor.check(4), monitor.anomalies)
    return pt.summary()


def test_profiling_prints_the_jax_lines(monkeypatch, capsys):
    want_summary = _drive(jax_profiling, monkeypatch)
    want = capsys.readouterr().out
    got_summary = _drive(profiling, monkeypatch)
    got = capsys.readouterr().out
    assert got == want and "ddim time: 0.375s" in got and "unnormal load" in got
    assert got_summary == want_summary and "ddim: 0.750s" in got_summary


def test_phase_timer_synchronises_only_a_card(monkeypatch):
    assert profiling.PhaseTimer(device="cpu").device is None
    assert profiling.PhaseTimer().device is None
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    pt = profiling.PhaseTimer(verbose=False, device="cuda:0")
    with pt.phase("step"):
        assert len(calls) == 1
    assert calls == [torch.device("cuda:0")] * 2 and pt.times["step"] >= 0


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0


def test_card_peaks_band_pairs_and_timer():
    assert profiling.card_peaks("NVIDIA H100 80GB HBM3") == ("SXM", (3.35e12, 989e12, 67e12))
    assert profiling.card_peaks("NVIDIA H100 PCIe")[0] == "PCIe"
    assert profiling.card_peaks("NVIDIA H100 NVL")[0] == "NVL"
    for t, w in ((200, 40), (20, 20), (5, 9), (1, 3)):
        brute = sum(abs(i - j) <= w for i in range(t) for j in range(t))
        assert profiling.band_pairs(t, w) == brute
    first, best, out = profiling.time_ms(lambda: 7, "cpu", repeats=2)
    assert out == 7 and first >= 0 and 0 <= best


def test_latents_then_decode_is_sample_one_video():
    """Also: profile_sample's DDIM count from 1- and 2-step calls is the
    count of the whole 3-step call."""
    torch.manual_seed(0)
    model = FlowDiffusion(FlowDiffusionConfig(img_size=32, sampling_timesteps=3,
                                              dim_mults=(1, 2), dtype=torch.float32),
                          device="cpu")
    g = torch.Generator().manual_seed(3)
    inp = dict(sample_img=torch.rand(1, 32, 32, 3, generator=g),
               audio_hubert=torch.randn(1, 6, 1024, generator=g),
               pose=torch.randn(1, 6, 6, generator=g), eye=torch.rand(1, 6, 2, generator=g),
               bbox=torch.tensor([[8.0, 24.0, 8.0, 24.0, 32.0, 32.0]]))
    whole = model.sample_one_video(**inp, generator=torch.Generator().manual_seed(1))
    pred = model.sample_latents(**inp, generator=torch.Generator().manual_seed(1))
    parts = model.decode_latents(inp["sample_img"], pred)
    assert whole.keys() == parts.keys()
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k

    def ddim():
        return model.sample_latents(**inp, generator=torch.Generator().manual_seed(1))
    assert profile_sample.count_ddim_flops(model, ddim) == profile_sample.count_flops(model, ddim)
    assert model.diffusion.sampling_timesteps == 3


def test_smoke_e2e_on_cpu(tmp_path, capsys):
    args = smoke_e2e.parse_args([])
    assert (args.img_size, args.frames, args.steps, args.attn, args.device) == (64, 8, 2, "full",
                                                                                None)
    res = smoke_e2e.main(["--device", "cpu", "--img-size", "32", "--frames", "4", "--attn",
                          "local", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("E2E SMOKE OK")
    assert sorted(os.listdir(tmp_path)) == [f"frame_{i:03d}.png" for i in range(4)]
    assert res["video"].shape == (1, 4, 32, 32, 3) and np.isfinite(res["video"]).all()
    assert res["k1_launches"] == (0, 0)          # the plain version on the CPU


def test_profile_sample_on_cpu(capsys):
    args = profile_sample.parse_args([])
    assert (args.img_size, args.frames, args.steps, args.attn, args.dtype, args.lfg_dtype,
            args.lfg_decode_chunk, args.decode_only) == (256, 200, 20, "local", "bf16", "f32",
                                                         None, False)
    res = profile_sample.main(["--device", "cpu", "--img-size", "32", "--frames", "4",
                               "--steps", "2", "--dtype", "f32", "--repeats", "1"])
    err = capsys.readouterr().err
    assert "ddim: first call" in err and "decode: first call" in err and "% of" not in err
    assert res["ddim_flops"]["counted"] > 0 and res["ddim_flops"]["k1"] == 0
    assert res["decode_flops"]["counted"] > 0
    assert min(res["ddim_ms"], res["decode_ms"], res["whole_ms"]) > 0
    res = profile_sample.main(["--device", "cpu", "--img-size", "32", "--frames", "4",
                               "--steps", "2", "--dtype", "f32", "--repeats", "1",
                               "--decode-only"])
    assert "ddim_ms" not in res and res["decode_ms"] > 0


def test_probe_unet_phases_on_cpu():
    args = probe_unet_phases.parse_args([])
    assert (args.img_size, args.frames, args.attn, args.dtype, args.modules,
            args.extras) == (256, 200, "local", "bf16", False, False)
    rows = probe_unet_phases.main(["--device", "cpu", "--img-size", "32", "--frames", "4",
                                   "--dtype", "f32", "--repeats", "1", "--modules",
                                   "--extras"])
    assert len(rows) == 3 + 3 * 4 + 6 and all(v > 0 for v in rows.values())


def test_probe_micro_on_cpu():
    args = probe_micro.parse_args([])
    assert (args.img_size, args.frames, args.dtype) == (256, 200, "bf16")
    rows = probe_micro.main(["--device", "cpu", "--img-size", "32", "--frames", "4",
                             "--dtype", "f32", "--repeats", "1"])
    assert len(rows) == 11 and all(v > 0 for v in rows.values())


def test_probe_train_phases_on_cpu(tmp_path, capsys):
    args = probe_train_phases.parse_args([])
    assert (args.batch, args.frames, args.img_size, args.repeats, args.modules) == (4, 20, 128,
                                                                                    5, False)
    assert args.config == os.path.join(ROOT, "configs", "dm_train_stage1.yaml")
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    cfg.update(fea_channels=32, unet=dict(dim=16, dim_mults=[1, 2], win_width=2),
               lfg=dict(generator=dict(block_expansion=8, max_features=32,
                                       num_bottleneck_blocks=1),
                        region=dict(block_expansion=4, max_features=16, num_blocks=2),
                        bg=dict(block_expansion=4, max_features=16, num_blocks=2),
                        flow=dict(block_expansion=4, max_features=16, num_blocks=2)))
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    rows = probe_train_phases.main(["--device", "cpu", "--config", str(path), "--img-size",
                                    "32", "--batch", "2", "--frames", "4", "--dtype", "f32",
                                    "--repeats", "1", "--modules"])
    out = capsys.readouterr().out
    assert "SUM A+C+D+cj" in out and "max|d| = 0.00e+00" in out
    assert len(rows) == 7 + 7 and all(v > 0 for v in rows.values())


def test_probe_packed_compile_on_cpu(capsys):
    args = probe_packed_compile.parse_args([])
    assert (args.t, args.big, args.chunk, args.h, args.d, args.window) == (200, 1024, 256, 8,
                                                                          32, 40)
    res = probe_packed_compile.main(["--device", "cpu", "--t", "24", "--big", "8", "--chunk",
                                     "2", "--h", "2", "--window", "4", "--dtype", "f32",
                                     "--repeats", "1"])
    assert res["nvcc_s"] is None and "not measured" in capsys.readouterr().out
    assert res["one_ms"] > 0 and res["chunked_ms"] > 0
    with pytest.raises(ValueError, match="multiple"):
        probe_packed_compile.main(["--device", "cpu", "--big", "9", "--chunk", "2"])


def test_make_golden_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(make_golden, "generate", lambda size: {
        "pixels": np.zeros(2, np.float32), "grid": np.zeros(1, np.float32),
        "checksum": np.float64(size)})
    make_golden.main(["--sizes", "256", "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == ["torch_golden_256.npz"]
    assert float(np.load(tmp_path / "torch_golden_256.npz")["checksum"]) == 256
