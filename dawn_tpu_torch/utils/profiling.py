"""The port's tracing recorder, a ``torch.profiler`` exporter, timing
helpers and the card's peak rates.

**The recorder** times the sampler from inside: its spans are

- ``dawn::sample``: one call of ``FlowDiffusion._sample`` (every sampling
  entry goes through it), the top-level call;
- ``dawn::ddim_step``: one iteration of the DDIM loop, with its step index;
- ``dawn::unet``: one denoiser call (``Unet3D.forward``; the step-constant
  ``precompute_static`` call is left out);
- ``dawn::threshold``: the dynamic thresholding of one step (``abs``, the
  all-gather of a frame-sharded video, the quantile, clamp and divide).

It is off by default, and then a span site costs one read of a module-level
variable: no annotation, no CUDA event, no synchronisation, no allocation.
An operator switches it on around the calls to trace::

    profiling.enable("cuda")
    ...  # calls of sample_one_video
    profiling.resolve()            # reads the CUDA events (synchronises)
    profiling.disable()
    for r in profiling.records(): ...

While on, each span keeps its name, the index of its top-level call (numbered
from 0 after :func:`enable`), its parent span, its step, the host's
``perf_counter_ns`` at both ends and, on a CUDA device, a CUDA event recorded
at each end on the current stream (no synchronisation). At the start of each
top-level call the recorder synchronises the card, records an anchor event and
reads the host clock, so after :func:`resolve` each span's device times are on
the host's clock too: the anchor's host time plus ``anchor.elapsed_time(event)``.
Spans outside a top-level call keep host times only. Each span is also a
``torch.profiler.record_function("dawn::<name>")`` annotation, so under any
profiler its kernels and the card's idle gaps fall inside it on the profiler's
own clock. :func:`count` records a number, tagged as a span is. Spans are
recorded from the thread that runs the calls.

:func:`device_trace` writes a ``torch.profiler`` trace for TensorBoard's
profiler plugin, with the recorder on for its duration. :func:`time_ms` times
a callable with CUDA events on the current stream. :func:`card_peaks` holds the
H100's published dense peak rates, which ``chip_smoke.py`` and the probe
scripts read for bounds and MFU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

# Dense peak rates from NVIDIA's data sheets: (bytes/s, bf16 FLOP/s, f32 FLOP/s)
PEAKS = {"PCIe": (2.0e12, 756e12, 51e12), "NVL": (3.9e12, 835e12, 60e12),
         "SXM": (3.35e12, 989e12, 67e12)}


@dataclasses.dataclass
class Record:
    """One span or count. Times are ``time.perf_counter_ns``; a span's device
    times are on the same clock, joined at its call's anchor, once resolved."""
    name: str
    call: int                   # top-level call from 0 after enable(); -1 outside one
    parent: int                 # index in records() of the enclosing span; -1 at the top
    step: Optional[int]         # the sampler step, inherited from the enclosing span
    host_start_ns: int
    host_end_ns: int
    device_start_ns: Optional[float] = None   # when the card reached the start event
    device_end_ns: Optional[float] = None
    value: Optional[float] = None             # a count's number; None for a span


class _Recorder:
    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.records: List[Record] = []
        self.calls = 0
        self._call = -1
        self._stack: List[int] = []
        self._anchors: List[Tuple[int, Any]] = []          # per call: (host ns, event)
        self._pending: List[Tuple[int, Any, Any]] = []     # (record, start, end)

    def _event(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _open(self, name: str, step: Optional[int]) -> int:
        parent = self._stack[-1] if self._stack else -1
        if step is None and parent >= 0:
            step = self.records[parent].step
        self.records.append(Record(name, self._call, parent, step, 0, 0))
        self._stack.append(len(self.records) - 1)
        return len(self.records) - 1

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int], top: bool):
        with torch.profiler.record_function(f"dawn::{name}"):
            if top and not self._stack:
                self._call, self.calls = self.calls, self.calls + 1
                if self.cuda:
                    torch.cuda.synchronize(self.device)
                    anchor = self._event()
                    self._anchors.append((time.perf_counter_ns(), anchor))
            index = self._open(name, step)
            record = self.records[index]
            timed = self.cuda and record.call >= 0
            record.host_start_ns = time.perf_counter_ns()
            start = self._event() if timed else None
            try:
                yield
            finally:
                if timed:
                    self._pending.append((index, start, self._event()))
                record.host_end_ns = time.perf_counter_ns()
                self._stack.pop()
                if not self._stack:
                    self._call = -1

    def count(self, name: str, value: float) -> None:
        index = self._open(name, None)
        self._stack.pop()
        record = self.records[index]
        record.host_start_ns = record.host_end_ns = time.perf_counter_ns()
        record.value = value

    def resolve(self) -> None:
        if self._pending:
            torch.cuda.synchronize(self.device)
        for index, start, end in self._pending:
            record = self.records[index]
            host_ns, anchor = self._anchors[record.call]
            record.device_start_ns = host_ns + anchor.elapsed_time(start) * 1e6
            record.device_end_ns = record.device_start_ns + start.elapsed_time(end) * 1e6
        self._pending.clear()


_on: Optional[_Recorder] = None      # the recorder while tracing is on
_last: Optional[_Recorder] = None    # the latest one, read after disable()
_OFF = contextlib.nullcontext()


def enable(device) -> None:
    """Switches the recorder on, afresh: top-level calls numbered from 0 on
    ``device`` (CUDA events and the anchor only on a CUDA device)."""
    global _on, _last
    _on = _last = _Recorder(device)


def disable() -> None:
    """Switches the recorder off; what it kept stays readable."""
    global _on
    _on = None


def records() -> List[Record]:
    """What the latest recorder kept, in the order the spans opened."""
    return _last.records if _last is not None else []


def resolve() -> None:
    """Reads the pending CUDA events into the records' device times (it
    synchronises the card first)."""
    if _last is not None:
        _last.resolve()


def span(name: str, step: Optional[int] = None):
    """A span ``dawn::<name>`` around the block while the recorder is on."""
    return _OFF if _on is None else _on.span(name, step, False)


def call(name: str):
    """A top-level span: it numbers the call and takes the anchor (nested
    inside another span, it is a plain span)."""
    return _OFF if _on is None else _on.span(name, None, True)


def count(name: str, value: float) -> None:
    """Records ``value`` under ``name``, tagged as a span opened here is."""
    if _on is not None:
        _on.count(name, value)


def card_peaks(name: str) -> Tuple[str, Tuple[float, float, float]]:
    """(H100 part, (bytes/s, bf16 FLOP/s, f32 FLOP/s)) for a device name as
    ``torch.cuda.get_device_name`` gives it; the SXM part when the name
    names none of them."""
    for key, rates in PEAKS.items():
        if key in name:
            return key, rates
    return "SXM", PEAKS["SXM"]


def band_pairs(t: int, w: int) -> int:
    """In-band (query, key) pairs of one (sequence, head) of windowed
    attention over ``t`` frames at window ``w``: K1's work is 4 x head_dim
    FLOP a pair forward (Q K^T and P V), 10 x head_dim backward."""
    return sum(min(t - 1, i + w) - max(0, i - w) + 1 for i in range(t))


def time_ms(fn: Callable[[], Any], device, repeats: int = 3) -> Tuple[float, float, Any]:
    """(ms of the first call, best ms of ``repeats`` calls after it, the last
    call's result) of ``fn()``; the first call also warms up. On a CUDA
    device each timed call is bracketed by CUDA events on the current
    stream, where the port's kernels launch, read after one synchronize;
    elsewhere the host clock times each call."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def once():
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3, out

    first, out = once()
    if not cuda:
        best = float("inf")
        for _ in range(repeats):
            ms, out = once()
            best = min(best, ms)
        return first, best, out
    stream = torch.cuda.current_stream(device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(repeats)]
    for start, end in events:
        start.record(stream)
        out = fn()
        end.record(stream)
    torch.cuda.synchronize(device)
    return first, min(s.elapsed_time(e) for s, e in events), out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host ops, and the card's
    kernels when CUDA is available) written to ``log_dir`` for TensorBoard's
    profiler plugin, the recorder on for the block (unless it already is),
    so the trace carries the ``dawn::`` spans; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    owner = _on is None
    if owner:
        enable("cuda" if cuda else "cpu")
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
            yield prof
    finally:
        if owner:
            resolve()
            disable()
