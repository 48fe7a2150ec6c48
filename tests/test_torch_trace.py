"""The port's tracing recorder (``dawn_tpu_torch/utils/profiling.py``) on the CPU.

- Off by default: sampler calls make no CUDA event and no synchronisation,
  and leave no ``dawn::`` annotation.
- On, the outputs are the same bits; the span tree of a 3-step DDIM call is
  one ``sample``, three ``ddim_step``s, each with one ``threshold`` and one
  ``unet`` (two at ``cond_scale`` 2), and no span for the precompute call.
- On a CUDA device (faked here) each span's device times are its call's
  anchor plus the events' elapsed times; calls are numbered from 0.
- ``device_trace`` switches the recorder on for its block.
"""

import contextlib
import itertools
import os
import time

import pytest
import torch

from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.utils import profiling
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)

STEPS = 3


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def tiny():
    """A 32^2 f32 model, 3 DDIM steps, and one clip of 6 frames."""
    torch.manual_seed(0)
    model = FlowDiffusion(FlowDiffusionConfig(img_size=32, sampling_timesteps=STEPS,
                                              dim_mults=(1, 2), dtype=torch.float32),
                          device="cpu")
    g = torch.Generator().manual_seed(3)
    inp = dict(sample_img=torch.rand(1, 32, 32, 3, generator=g),
               audio_hubert=torch.randn(1, 6, 1024, generator=g),
               pose=torch.randn(1, 6, 6, generator=g), eye=torch.rand(1, 6, 2, generator=g),
               bbox=torch.tensor([[8.0, 24.0, 8.0, 24.0, 32.0, 32.0]]))
    return model, inp


def _sample(tiny, cond_scale):
    model, inp = tiny
    return model.sample_one_video(**inp, cond_scale=cond_scale,
                                  generator=torch.Generator().manual_seed(1))


def _refuse(*args, **kwargs):
    raise AssertionError("the recorder touched the card while off")


@pytest.fixture(scope="module")
def runs(tiny):
    """Per ``cond_scale``, one call with the recorder off (torch.cuda's
    events and synchronisation made to raise) and one with it on: their
    outputs, the records and, at ``cond_scale`` 1 (under the CPU profiler),
    the names of the host's events."""
    out = {}
    for cond_scale in (1.0, 2.0):
        run = {}
        for side in ("off", "on"):
            profiling.disable()
            with pytest.MonkeyPatch.context() as mp:
                if side == "off":
                    mp.setattr(torch.cuda, "Event", _refuse)
                    mp.setattr(torch.cuda, "synchronize", _refuse)
                else:
                    profiling.enable("cpu")
                with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
                      if cond_scale == 1.0 else contextlib.nullcontext()) as prof:
                    run[side] = _sample(tiny, cond_scale)
                profiling.resolve()
            if prof is not None:
                run[side + "_names"] = [e.name() for e in prof.profiler.kineto_results.events()]
        profiling.disable()
        run["records"] = profiling.records()
        out[cond_scale] = run
    return out


def test_off_by_default_makes_no_event_sync_or_annotation(runs):
    names = runs[1.0]["off_names"]
    assert "aten::conv2d" in names or "aten::convolution" in names
    assert not [n for n in names if n.startswith("dawn::")]
    assert profiling.span("unet") is profiling.call("sample")   # one shared null context


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_on_gives_the_same_bits(runs, cond_scale):
    off, on = runs[cond_scale]["off"], runs[cond_scale]["on"]
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_on_the_span_tree(runs, cond_scale):
    recs = runs[cond_scale]["records"]
    unets = 1 if cond_scale == 1.0 else 2
    assert [r.name for r in recs] == ["sample"] + [
        n for _ in range(STEPS) for n in ["ddim_step"] + ["unet"] * unets + ["threshold"]]
    assert recs[0].parent == -1 and recs[0].step is None
    steps = [i for i, r in enumerate(recs) if r.name == "ddim_step"]
    assert [recs[i].step for i in steps] == list(range(STEPS))
    for i in steps:
        assert recs[i].parent == 0
        kids = [r for r in recs if r.parent == i]
        assert [r.name for r in kids] == ["unet"] * unets + ["threshold"]
        assert all(r.step == recs[i].step for r in kids)
    for r in recs:
        assert r.call == 0 and r.value is None and r.host_start_ns <= r.host_end_ns
        assert r.device_start_ns is None and r.device_end_ns is None     # no card
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.host_start_ns <= r.host_start_ns and r.host_end_ns <= p.host_end_ns


def test_on_annotates_each_span_for_the_profiler(runs):
    names = [n for n in runs[1.0]["on_names"] if n.startswith("dawn::")]
    assert sorted(set(names)) == ["dawn::ddim_step", "dawn::sample", "dawn::threshold",
                                  "dawn::unet"]
    assert names.count("dawn::ddim_step") == STEPS and names.count("dawn::unet") == STEPS


class FakeEvent:
    """A CUDA event whose device time (ms) is the next of ``TIMES``."""
    TIMES = iter(())
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = next(FakeEvent.TIMES)

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's events, streams and synchronisation faked; the host
    clock reads 1 s, then 1000 ns more at each reading."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    ticks = itertools.count(10 ** 9, 1000)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    FakeEvent.made = 0
    return syncs


def test_device_times_join_the_host_clock_at_each_call_anchor(fake_card):
    # events in order: anchor, sample start, step start, step end, sample end
    FakeEvent.TIMES = iter([50.0, 50.25, 50.5, 51.0, 52.0,
                            70.0, 70.125, 70.5])         # call 1: anchor, start, end
    h = 10 ** 9
    profiling.enable("cuda")
    profiling.count("outside", 3)                        # host reading h
    with profiling.span("loose"):                        # h+1000, h+2000: no events
        pass
    assert FakeEvent.made == 0 and fake_card == []
    with profiling.call("sample"):                       # sync, anchor; host h+3000, h+4000
        with profiling.span("ddim_step", step=7):        # h+5000
            profiling.count("kernels", 42)               # h+6000
        # step end h+7000; sample end h+8000
    with profiling.call("sample"):                       # anchor h+9000, start h+10000
        pass
    assert len(fake_card) == 2 and FakeEvent.made == 5 + 3
    profiling.resolve()
    profiling.disable()
    out, loose, s0, step, kern, s1 = profiling.records()
    assert (out.name, out.call, out.parent, out.value, out.host_start_ns) == (
        "outside", -1, -1, 3, h)
    assert (loose.call, loose.device_start_ns) == (-1, None)
    assert (s0.call, s0.parent, s0.host_start_ns, s0.host_end_ns) == (0, -1, h + 4000, h + 8000)
    assert (s0.device_start_ns, s0.device_end_ns) == (h + 3000 + 250_000, h + 3000 + 2_000_000)
    assert (step.call, step.parent, step.step) == (0, 2, 7)
    assert (step.device_start_ns, step.device_end_ns) == (h + 3000 + 500_000,
                                                          h + 3000 + 1_000_000)
    assert (kern.name, kern.parent, kern.step, kern.value, kern.call) == ("kernels", 3, 7, 42, 0)
    assert kern.device_start_ns is None
    assert (s1.call, s1.host_start_ns) == (1, h + 10000)
    assert (s1.device_start_ns, s1.device_end_ns) == (h + 9000 + 125_000, h + 9000 + 500_000)
    profiling.enable("cuda")                             # afresh: calls from 0, nothing kept
    assert profiling.records() == []


def test_device_trace_switches_the_recorder_on_for_its_block(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.call("sample"):
            with profiling.span("unet"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert profiling.span("unet") is profiling.call("sample")     # off again
    assert [(r.name, r.call, r.parent) for r in profiling.records()] == [
        ("sample", 0, -1), ("unet", 0, 0)]
    (trace,) = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    text = (tmp_path / trace).read_text()
    assert '"dawn::sample"' in text and '"dawn::unet"' in text
    profiling.enable("cpu")                              # an operator's recorder stays on
    with profiling.device_trace(str(tmp_path / "b")):
        pass
    with profiling.span("after"):
        pass
    assert [r.name for r in profiling.records()] == ["after"]
