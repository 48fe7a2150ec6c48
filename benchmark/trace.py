"""Reads a ``torch.profiler`` trace of the traced calls.

From the raw events (CUPTI's device activity and the host's annotations):
the traced window (the first ``bench::call`` start to the last end), the
device's busy seconds in it (kernels, copies and sets, their intervals
merged), the device seconds of the kernels launched inside each
``bench::`` span (a kernel belongs to the span in which its launch call
ran: the host runtime call with the kernel's correlation id, else the host
op it is linked to), the device operations that took most time, and the
longest idle stretches of the device named by what the host was doing
then (the innermost ``bench::`` span and host op around the stretch's
start on the thread that runs the calls). Kernel names are read for the
breakdown only. From a trace of the card's activity alone: its busy
seconds and window (:func:`device_busy`).
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    span_device_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    events: int


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(spans, t):
    """Whether t lies inside one of the sorted, merged ``spans``."""
    i = bisect.bisect_right(spans, [t, float("inf")]) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def device_busy(prof) -> Tuple[float, float]:
    """(busy seconds, window seconds) of the card: the window from the first
    device event's start to the last one's end, busy the union of every
    kernel's, copy's and set's interval in it; (0, 0) without any."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and not e.is_user_annotation()]
    if not events:
        return 0.0, 0.0
    busy = _merge(events)
    return (sum(e - s for s, e in busy) / 1e9,
            (max(e for _, e in events) - min(s for s, _ in events)) / 1e9)


def summarize(prof) -> TraceSummary:
    cuda = torch.autograd.DeviceType.CUDA
    device, host, notes, runtime = [], [], defaultdict(list), {}
    raw = prof.profiler.kineto_results.events()
    for e in raw:
        name, start, end = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((start, end, name, e.correlation_id(), e.linked_correlation_id()))
        elif e.is_user_annotation():
            if name.startswith("bench::"):
                notes[name[7:]].append((start, end, e.start_thread_id()))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = start
        else:
            host.append((start, end, name, e.correlation_id(), e.start_thread_id()))
    calls = notes.get("call", [])
    if not calls or not device:
        return TraceSummary(0.0, 0.0, {}, [], [], len(raw))
    w0, w1 = min(s for s, _, _ in calls), max(e for _, e, _ in calls)
    main = calls[0][2]
    host_start = {c: s for s, _, _, c, _ in host}
    busy = _merge((max(s, w0), min(e, w1)) for s, e, *_ in device if e > w0 and s < w1)
    busy_ns = sum(e - s for s, e in busy)

    launches = [(runtime.get(corr, host_start.get(linked)), e - s)
                for s, e, _, corr, linked in device]
    span_device = {}
    for name, intervals in notes.items():
        spans = _merge((s, e) for s, e, _ in intervals)
        span_device[name] = sum(ns for t, ns in launches
                                if t is not None and _inside(spans, t)) / 1e9

    by_name = defaultdict(int)
    for s, e, name, *_ in device:
        if e > w0 and s < w1:
            by_name[name] += min(e, w1) - max(s, w0)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1] - edges[i]))
    stack_events = sorted([(s, e, n) for s, e, n, _, th in host if th == main]
                          + [(s, e, "bench::" + k) for k, v in notes.items()
                             for s, e, th in v if th == main])
    labels = defaultdict(int)
    stack, j = [], 0
    for start, length in sorted(gaps):
        while j < len(stack_events) and stack_events[j][0] <= start:
            s, e, n = stack_events[j]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, n))
            j += 1
        live = [n for s, e, n in stack if e >= start]
        span = next((n[7:] for n in reversed(live) if n.startswith("bench::")), "outside")
        op = next((n for n in reversed(live) if not n.startswith("bench::")), "python")
        labels[f"{span}: {op}"] += length
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                        span_device_s=span_device,
                        device_ops=[(n[:120], v / 1e9) for n, v in device_ops],
                        idle_gaps=[(n[:120], v / 1e9) for n, v in idle], events=len(raw))
