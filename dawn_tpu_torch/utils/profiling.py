"""Tracing and profiling utilities, and the card's peak rates.

Port of ``dawn_tpu/utils/profiling.py``. The reference's observability is
ad-hoc time.time() probes ("DDIM time", "AE time", ..._init_cond_test.py:
355-398; "unnormal load" warnings, train...6D.py:263-269) plus a Timer class
(FaceBoxes/utils/timer.py). Here, as in the JAX module, the same surface is
structured: a Timer with tic/toc/average, PhaseTimer context managers, a
load-anomaly monitor (the same printed lines as JAX's), and
:func:`device_trace`, a ``torch.profiler`` trace for TensorBoard, the
counterpart of the ``jax.profiler`` trace.

The card runs asynchronously, so a host clock around work on it measures the
enqueue unless the stream is synchronised: a :class:`PhaseTimer` given a
CUDA device synchronises it at both ends of each phase.

:func:`card_peaks` holds the H100's published dense peak rates, which
``chip_smoke.py`` and the probe scripts read for bounds and MFU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

# Dense peak rates from NVIDIA's data sheets: (bytes/s, bf16 FLOP/s, f32 FLOP/s)
PEAKS = {"PCIe": (2.0e12, 756e12, 51e12), "NVL": (3.9e12, 835e12, 60e12),
         "SXM": (3.35e12, 989e12, 67e12)}


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


class Timer:
    """tic/toc with running average (FaceBoxes/utils/timer.py:13)."""

    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True) -> float:
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def clear(self):
        self.__init__()


class PhaseTimer:
    """Named phase timers with a summary: the structured version of the
    reference's "DDIM time ..." prints. With a CUDA ``device``, each phase
    starts and ends with ``torch.cuda.synchronize(device)``, so its time is
    the device work enqueued inside it."""

    def __init__(self, verbose: bool = True, device=None):
        self.times: Dict[str, float] = {}
        self.verbose = verbose
        device = None if device is None else torch.device(device)
        self.device = device if device is not None and device.type == "cuda" else None

    def _sync(self):
        if self.device is not None:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self.verbose:
                print(f"{name} time: {dt:.3f}s")

    def summary(self) -> str:
        total = sum(self.times.values())
        lines = [f"  {k}: {v:.3f}s ({100 * v / max(total, 1e-9):.0f}%)"
                 for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])]
        return "\n".join([f"phases (total {total:.3f}s):"] + lines)


class LoadAnomalyMonitor:
    """Flags slow data-loading steps (train...6D.py:263-269 'unnormal load')."""

    def __init__(self, threshold_s: float = 1.0):
        self.threshold = threshold_s
        self.anomalies = 0
        self._t0 = time.time()

    def reset(self):
        self._t0 = time.time()

    def check(self, step: int) -> Optional[float]:
        dt = time.time() - self._t0
        if dt > self.threshold:
            self.anomalies += 1
            print(f"unnormal load {dt:.2f}s at step {step}")
            return dt
        return None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host ops, and the card's
    kernels when CUDA is available) written to ``log_dir`` for TensorBoard's
    profiler plugin; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
