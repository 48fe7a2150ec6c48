"""The benchmark's arithmetic against hand counts at small shapes, and the
metric readers against runs whose numbers are known."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import arith, manifest
from benchmark.drivers import dawn as driver
from benchmark.reference import dawn as reference
from benchmark.spans import Spans


def test_band_pairs_by_hand():
    # T=5, w=1: keys {0,1}, {0,1,2}, {1,2,3}, {2,3,4}, {3,4}
    assert arith.band_pairs(5, 1) == 13
    # w >= T-1: every pair
    assert arith.band_pairs(4, 9) == 16
    assert arith.attention_flops(2, 5, 3, 4, 1) == 4 * 4 * 13 * 2 * 3
    # q, k, v and out of 2 x 5 x 3 x 4 bf16 entries, a (3, 3) f32 bias
    assert arith.attention_bytes(2, 5, 3, 4, 2, 9) == 4 * 2 * 5 * 3 * 4 * 2 + 9 * 4


def test_roofline_takes_the_larger_bound():
    rates = (2.0, 10.0, 1.0)
    assert arith.roofline_seconds(100.0, 4.0, rates) == 10.0
    assert arith.roofline_seconds(10.0, 40.0, rates) == 20.0
    assert arith.card_peaks("NVIDIA H100 80GB HBM3") == ("SXM", (3.35e12, 989e12, 67e12))


def test_call_flops_by_hand(tiny_cell):
    """call_flops (meta device, the temporal attention as its band) equals
    the products the reference really computes at this size, less its whole
    (T, T) attention products plus the band's, counted by hand."""
    config, traffic = tiny_cell.config, tiny_cell.traffic
    b, t, steps = traffic["batch"], traffic["frames"], config["sampling_timesteps"]
    heads, d, w = config["unet"]["attn_heads"], config["unet"]["attn_dim_head"], \
        config["win_width"]
    # temporal attentions a UNet call at 32^2 (latent 8^2), two levels:
    # init, down 0 (8x8), down 1 (4x4), mid, up 0 (4x4), up 1 (8x8)
    seqs = [b * s for s in (64, 64, 16, 16, 16, 64)]
    whole = steps * sum(4 * n * heads * t * t * d for n in seqs)
    band = steps * sum(4 * d * arith.band_pairs(t, w) * n * heads for n in seqs)
    model = reference.FlowDiffusion(config)
    model.load_state_dict(reference.seeded_state_dict(config, 3, "cpu"))
    inputs = reference.make_inputs(config, traffic, 3, 0, "cpu")
    with FlopCounterMode(display=False) as fc:
        model.sample(inputs)
    assert reference.call_flops(config, traffic) == fc.get_total_flops() - whole + band


@pytest.mark.parametrize("packed", [True, False])
def test_attention_span_counts_by_hand(packed):
    from dawn_tpu_torch.ops import local_attention as la
    n, t, heads, d, w = 3, 12, 2, 32, 4
    g = torch.Generator().manual_seed(0)
    if packed:
        q, k, v = (torch.randn(n, t, heads * d, generator=g) for _ in range(3))
        args, fn = (heads,), la.local_attention_packed
    else:
        q, k, v = (torch.randn(n, heads, t, d, generator=g) for _ in range(3))
        args, fn = (), la.local_attention
    vec = torch.randn(heads, 2 * w + 1, generator=g)
    spans = Spans("cpu")
    spans.call = 7
    got = driver._attention_wrapper(fn, spans, packed)(q, k, v, vec, w, *args)
    assert torch.equal(got, fn(q, k, v, vec, w, *args))
    assert spans.counts["temporal_attn"] == [
        (7, 4 * d * arith.band_pairs(t, w) * n * heads,
         4 * n * t * heads * d * 4 + heads * (2 * w + 1) * 4)]


def _run(**kw):
    cell = types.SimpleNamespace(config={"sampling_timesteps": 20})
    base = dict(cell=cell, setup_s=12.5, window_s=10.0, spans=None, trace=None,
                device_busy=None, call_flops=None, rates=(3.35e12, 989e12, 67e12), peak_window_bytes=0,
                calls=[{"frames": 800, "clips": 4}] * 2, steps=20)
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, run):
    return manifest.reader(name)(run)


def test_end_to_end_readers():
    run = _run()
    assert read("video_fps", run) == 160.0
    assert read("clip_s", run) == 1.25
    assert read("setup_s", run) == 12.5


def test_span_readers_by_hand():
    spans = Spans("cpu")
    for call, ddim, units in ((0, 4.0, [100.0, 110.0]), (1, 5.0, [120.0, 130.0]),
                              (2, 9.0, [999.0])):             # call 2: a traced call
        spans.host_s["ddim"].append((call, ddim))
        spans.host_s["decode"].append((call, 0.5 + call))
        for u in units:
            spans.device_ms["unet"].append((call, u))
            spans.issue_ms["unet"].append((call, u / 2))
    run = _run(spans=spans)
    assert read("ddim_s", run) == 4.5
    assert read("decode_s.clip", run) == 1.0
    assert read("unet_ms", run) == 115.0
    assert read("unet_enqueue_ms.clip", run) == 57.5
    # ((4000 - 210) / 20 + (5000 - 250) / 20) / 2
    assert read("sampler_ms", run) == pytest.approx((189.5 + 237.5) / 2)


def test_trace_readers_by_hand():
    spans = Spans("cpu")
    spans.counts["temporal_attn"] += [(0, 1e12, 1e6), (2, 989e9, 1e6), (3, 0.0, 3.35e9)]
    trace = types.SimpleNamespace(window_s=9.0, busy_s=1.0,
                                  span_device_s={"temporal_attn": 0.004})
    run = _run(spans=spans, trace=trace, device_busy=(3.0, 4.0), call_flops=989e12 / 10,
               peak_window_bytes=3 * 2 ** 30)
    # calls 2 and 3 are the traced ones: 1 ms + 1 ms of least time over 4 ms
    assert read("temporal_attn_roofline", run) == pytest.approx(50.0)
    assert read("device_idle", run) == 25.0
    assert read("mfu", run) == pytest.approx(100.0 * 2 / 10 / 10)
    assert read("peak_mem_gib.clip", run) == 3.0


def test_readers_return_nothing_without_a_reading():
    run = _run()
    for name in ("ddim_s", "decode_s", "unet_ms", "sampler_ms", "unet_enqueue_ms",
                 "temporal_attn_roofline", "mfu", "device_idle", "peak_mem_gib"):
        assert read(name, run) is None, name


class _Event:
    """A stand-in for one raw profiler record (``_KinetoEvent``)."""

    def __init__(self, name, start, end, device=False, note=False, corr=0, linked=0,
                 thread=1):
        self._v = (name, start, end, device, note, corr, linked, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


def test_trace_reading_by_hand():
    """Two calls 0-100 and 100-200 ns; kernels at 10-30, 20-40 (overlapping),
    60-70 and 150-190; the 60-70 kernel launched inside a temporal-attention
    span, the 150-190 one linked to a host op inside it."""
    from benchmark import trace
    E = _Event
    events = [
        E("bench::call", 0, 100, note=True), E("bench::call", 100, 200, note=True),
        E("bench::temporal_attn", 50, 55, note=True),
        E("bench::temporal_attn", 140, 160, note=True),
        E("aten::mm", 141, 150, corr=9), E("aten::copy_", 40, 60, corr=8),
        E("cudaLaunchKernel", 5, 6, corr=1), E("cudaLaunchKernel", 7, 8, corr=2),
        E("cudaLaunchKernel", 52, 53, corr=3),
        E("k_a", 10, 30, device=True, corr=1), E("k_b", 20, 40, device=True, corr=2),
        E("k_a", 60, 70, device=True, corr=3),
        E("k_c", 150, 190, device=True, corr=4, linked=9),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    s = trace.summarize(prof)
    assert s.window_s == 200e-9 and s.busy_s == (30 + 10 + 40) * 1e-9
    assert s.span_device_s["temporal_attn"] == pytest.approx((10 + 40) * 1e-9)
    assert s.span_device_s["call"] == pytest.approx((20 + 20 + 10 + 40) * 1e-9)
    assert s.device_ops[0] == ("k_c", 40e-9) and dict(s.device_ops)["k_a"] == 30e-9
    gaps = dict(s.idle_gaps)
    # idle 0-10, 40-60 (host in copy_), 70-150, 190-200
    assert gaps["call: aten::copy_"] == pytest.approx(20e-9)
    assert sum(gaps.values()) == pytest.approx(120e-9)


def test_device_busy_by_hand():
    """A trace of the card alone: kernels at 10-30, 20-40 and 60-70 ns and a
    copy at 90-100; the host's runtime calls are no device time."""
    from benchmark import trace
    E = _Event
    events = [E("cudaLaunchKernel", 0, 5, corr=1), E("k_a", 10, 30, device=True, corr=1),
              E("k_b", 20, 40, device=True, corr=2), E("k_a", 60, 70, device=True, corr=3),
              E("Memcpy DtoH", 90, 100, device=True, corr=4)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    busy, window = trace.device_busy(prof)
    assert busy == pytest.approx(50e-9) and window == pytest.approx(90e-9)
    empty = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events[:1])))
    assert trace.device_busy(empty) == (0.0, 0.0)
