"""The readers of the program's own spans (``benchmark/program_spans.py``)
against records and traces whose numbers are known, and its probe on the CPU."""

import types

import pytest

from benchmark import program_spans as ps
from benchmark.tests.test_harness_counts import _Event
from dawn_tpu_torch.utils.profiling import Record

MS = 1_000_000


def _rec(name, call, parent, step, host_ms, dev_ms=None):
    """A span of ``call``: host start at ``host_ms``, device start and end at
    ``dev_ms`` (ms, both on the host's clock)."""
    dev = (None, None) if dev_ms is None else (dev_ms[0] * MS, dev_ms[1] * MS)
    return Record(name, call, parent, step, int(host_ms * MS), int(host_ms * MS) + MS, *dev)


def test_readings_by_hand():
    """Call 0: step 0 (device 10-20 ms) with one UNet (11-17, issued at 10.5)
    and its threshold (17.5-19); step 1 (20-40) with two UNets (21-27 issued
    at 20.75, 28-35 issued at 28.25) and its threshold (35-38). Call 1 is not
    counted; a span without device times is left out."""
    recs = [_rec("sample", 0, -1, None, 9, (9.5, 41)),
            _rec("ddim_step", 0, 0, 0, 10, (10, 20)),
            _rec("unet", 0, 1, 0, 10.5, (11, 17)),
            _rec("threshold", 0, 1, 0, 12, (17.5, 19)),
            _rec("ddim_step", 0, 0, 1, 13, (20, 40)),
            _rec("unet", 0, 4, 1, 20.75, (21, 27)),
            _rec("unet", 0, 4, 1, 28.25, (28, 35)),
            _rec("threshold", 0, 4, 1, 29, (35, 38)),
            _rec("ddim_step", 1, -1, 0, 50, (50, 90)),
            _rec("threshold", 0, 4, 1, 30)]
    got = ps.readings(recs, {0})
    assert got["threshold"] == pytest.approx([1.5, 3.0])
    assert got["sampler_self"] == pytest.approx([10 - 6, 20 - 6 - 7])
    assert got["unet_lead"] == pytest.approx([0.5, 0.25, -0.25])
    assert got["unet_end_lead"] == pytest.approx([17 - 11.5, 27 - 21.75, 35 - 29.25])
    assert ps.mean(got["sampler_self"]) == pytest.approx(5.5)
    assert ps.readings(recs, {1})["sampler_self"] == pytest.approx([40])


def test_readers_return_nothing_without_a_reading():
    recs = [_rec("sample", 0, -1, None, 0), _rec("ddim_step", 0, 0, 0, 1),
            _rec("unet", 0, 1, 0, 2), _rec("threshold", 0, 1, 0, 3)]
    for values in list(ps.readings(recs, {0}).values()) + list(ps.readings([], {0}).values()):
        assert values == [] and ps.mean(values) is None
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: [
            _Event("bench::call", 0, 100, note=True),
            _Event("k_a", 10, 30, device=True, corr=1)])))
    assert ps.step_kernels(prof) is None and ps.idle_gaps(prof) == []


def test_step_kernels_and_idle_gaps_by_hand():
    """One call 0-200 ns with two steps, 10-90 and 100-190. Kernels at 20-30,
    40-50 (its launch at 35 in step 0), 95-99 (launched at 92, between the
    steps), 120-150 (linked to a host op inside step 1) and 150-160 (a graph
    replay's kernel, its launch at 130 in step 1); a copy at 170-180 launched
    at 165. So 2 + 3 operations over 2 steps."""
    E = _Event
    events = [
        E("dawn::sample", 0, 200, note=True), E("dawn::ddim_step", 10, 90, note=True),
        E("dawn::ddim_step", 100, 190, note=True), E("dawn::unet", 105, 140, note=True),
        E("bench::call", 0, 200, note=True),
        E("cudaLaunchKernel", 15, 16, corr=1), E("cudaLaunchKernel", 35, 36, corr=2),
        E("cudaLaunchKernel", 92, 93, corr=3), E("aten::mm", 110, 118, corr=9),
        E("cudaGraphLaunch", 130, 131, corr=5), E("cudaMemcpyAsync", 165, 166, corr=6),
        E("aten::copy_", 45, 80, corr=8),
        E("k_a", 20, 30, device=True, corr=1), E("k_b", 40, 50, device=True, corr=2),
        E("k_c", 95, 99, device=True, corr=3), E("k_d", 120, 150, device=True, corr=4,
                                                 linked=9),
        E("k_e", 150, 160, device=True, corr=5), E("Memcpy DtoD", 170, 180, device=True,
                                                   corr=6),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert ps.step_kernels(prof) == 5 / 2
    gaps = dict(ps.idle_gaps(prof))
    # idle 0-20 (the call alone), 30-40 (step 0), 50-95 (step 0, the host in
    # copy_), 99-120 (starts between the steps), 160-170 and 180-200 (step 1)
    assert gaps == pytest.approx({"sample: python": 41e-9, "ddim_step: python": 40e-9,
                                  "ddim_step: aten::copy_": 45e-9})


def test_probe_on_the_cpu(tiny_cell):
    """The probe's control flow at the tiny size: four calls, two with the
    recorder on, and one profiled call; on the CPU no device times, so no
    span reading, and the profile's steps are the recorder's."""
    line = ps.measure(tiny_cell, 5, 4, "cpu")
    assert line["device"] == "cpu" and len(line["seconds_on"]) == 2
    assert len(line["seconds_off"]) == 2
    assert line["threshold_ms"] is None and line["unet_lead_ms_min"] is None
    assert line["profiled_steps"] == {"recorder": 2, "trace": 2}
    assert line["step_kernels"] is None and line["idle_gaps"] == []
    assert sorted(line["span_cost_us"]) == ["off", "on", "resolve"]
    for side in ("on", "off"):
        assert line["bench_spans"][side]["ddim_s"] > 0
        assert line["bench_spans"][side]["unet_ms"] is None      # no CUDA events on the CPU
