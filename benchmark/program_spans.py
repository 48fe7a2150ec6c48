"""Reads the program's own spans: the records of ``dawn_tpu_torch``'s tracing
recorder (``dawn_tpu_torch.utils.profiling``) and the ``dawn::`` annotations
it leaves in a ``torch.profiler`` trace.

From the records of the calls counted (each a list of values; a reading is
their mean):

- ``threshold``: device ms of each ``dawn::threshold`` (its two events);
- ``sampler_self``: device ms of each ``dawn::ddim_step`` less that of the
  ``dawn::unet`` spans inside it: a step's own work, on one clock;
- ``unet_lead``: at the start of each ``dawn::unet``, when the card reached
  the start event less when the host recorded it, both on the host's clock
  (joined at the call's anchor): how long the UNet's first operation waited
  in the stream, how far the host ran ahead of the card;
- ``unet_end_lead``: the same at the end of each ``dawn::unet``: how far the
  card was behind when the host had issued the whole UNet.

From a trace with the host's operations: ``step_kernels``, the device
operations (kernels, copies, sets) launched inside a ``dawn::ddim_step``
annotation a step, by :func:`benchmark.trace.summarize`'s rule (a device
operation belongs to the span in which the runtime call with its correlation
id ran, else its linked host op), so a CUDA graph's replayed kernels count
through their launch; and the longest idle stretches of the card in the
``dawn::sample`` calls, named by the innermost ``dawn::`` span and host op on
the thread that runs them, as ``summarize`` names them by ``bench::`` span.

``python3 -m benchmark.program_spans --workload <cell> --seed <n> --calls <n>``
runs a cell's calls inside the benchmark's traced spans, the recorder on for
every other pair of calls (off, on, on, off, ...), then ``trace_calls`` calls
under ``torch.profiler`` with the recorder on, and prints one JSON line: the
recorder's cost (host seconds a call, on against off, and the host time of a
call's spans alone, :func:`span_cost_us`), the benchmark's own span readings
on against off, the readings above, and the profile's.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

from benchmark.trace import TOP, _inside, _merge


def _device_ms(r) -> float:
    return (r.device_end_ns - r.device_start_ns) / 1e6


def readings(records, calls) -> Dict[str, List[float]]:
    """The per-item values (ms) of the readings the module docstring names,
    over the records whose call is in ``calls`` and whose device times are
    resolved."""
    timed = [(i, r) for i, r in enumerate(records)
             if r.call in calls and r.device_start_ns is not None]
    unet = defaultdict(float)
    for _, r in timed:
        if r.name == "unet" and r.parent >= 0:
            unet[r.parent] += _device_ms(r)
    return {"threshold": [_device_ms(r) for _, r in timed if r.name == "threshold"],
            "sampler_self": [_device_ms(r) - unet[i] for i, r in timed
                             if r.name == "ddim_step"],
            "unet_lead": [(r.device_start_ns - r.host_start_ns) / 1e6 for _, r in timed
                          if r.name == "unet"],
            "unet_end_lead": [(r.device_end_ns - r.host_end_ns) / 1e6 for _, r in timed
                              if r.name == "unet"]}


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def _events(prof):
    """(device ops (start, end, correlation, linked correlation), host ops
    (start, end, name, correlation, thread), annotations by name
    ([(start, end, thread)]), runtime calls' starts by correlation)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, notes, runtime = [], [], defaultdict(list), {}
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((start, end, e.correlation_id(), e.linked_correlation_id()))
        elif e.is_user_annotation():
            notes[name].append((start, end, e.start_thread_id()))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = start
        else:
            host.append((start, end, name, e.correlation_id(), e.start_thread_id()))
    return device, host, notes, runtime


def step_kernels(prof) -> Optional[float]:
    """Device operations launched inside ``dawn::ddim_step`` annotations, over
    the annotations; None without any."""
    device, host, notes, runtime = _events(prof)
    steps = notes.get("dawn::ddim_step", [])
    if not steps or not device:
        return None
    host_start = {c: s for s, _, _, c, _ in host}
    spans = _merge((s, e) for s, e, _ in steps)
    launches = (runtime.get(corr, host_start.get(linked)) for _, _, corr, linked in device)
    return sum(1 for t in launches if t is not None and _inside(spans, t)) / len(steps)


def idle_gaps(prof):
    """The card's longest idle stretches (label, seconds) between the first
    ``dawn::sample`` start and the last end, each named ``"<span>: <op>"`` by
    the innermost ``dawn::`` span and host op around its start; [] without
    a call."""
    device, host, notes, _ = _events(prof)
    calls = notes.get("dawn::sample", [])
    if not calls or not device:
        return []
    w0, w1, main = min(s for s, _, _ in calls), max(e for _, e, _ in calls), calls[0][2]
    busy = _merge((max(s, w0), min(e, w1)) for s, e, *_ in device if e > w0 and s < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1] - edges[i]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    stack_events = sorted([(s, e, n) for s, e, n, _, th in host if th == main]
                          + [(s, e, k) for k, v in notes.items() if k.startswith("dawn::")
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
        span = next((n[6:] for n in reversed(live) if n.startswith("dawn::")), "outside")
        op = next((n for n in reversed(live) if not n.startswith("dawn::")), "python")
        labels[f"{span}: {op}"] += length
    return [(n[:120], v / 1e9) for n, v in sorted(labels.items(), key=lambda kv: -kv[1])[:TOP]]


def span_cost_us(device, steps: int, repeats: int = 50) -> Dict[str, float]:
    """Host microseconds of one call's spans with no work inside them (the
    call, and a step with one UNet and one threshold ``steps`` times), the
    median of ``repeats``: recorder off; on (the anchor's synchronisation
    included); and its ``resolve()`` after each call on."""
    from dawn_tpu_torch.utils import profiling

    def skeleton():
        with profiling.call("sample"):
            for i in range(steps):
                with profiling.span("ddim_step", step=i):
                    with profiling.span("unet"):
                        pass
                    with profiling.span("threshold"):
                        pass

    times = defaultdict(list)
    for _ in range(repeats):
        t0 = time.perf_counter()
        skeleton()
        off = time.perf_counter() - t0
        profiling.enable(device)
        t1 = time.perf_counter()
        skeleton()
        t2 = time.perf_counter()
        profiling.resolve()
        t3 = time.perf_counter()
        profiling.disable()
        for k, v in (("off", off), ("on", t2 - t1), ("resolve", t3 - t2)):
            times[k].append(v * 1e6)
    return {k: statistics.median(v) for k, v in times.items()}


def measure(cell, seed: int, calls: int, device) -> dict:
    """The cell's calls as the module docstring says; returns the line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.spans import Spans, sync
    from dawn_tpu_torch.utils import profiling

    config, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    driver = importlib.import_module(f"benchmark.drivers.{config['family']}")
    reference = importlib.import_module(f"benchmark.reference.{config['family']}")
    driver.set_precision(config)
    model = driver.build(config, reference.seeded_state_dict(config, seed, device), device)

    def one(i):
        inputs = reference.make_inputs(config, traffic, seed, i, device)
        return driver.failed_items(driver.call(model, config, inputs))

    one(-1)
    sync(device)
    spans, seconds, values = Spans(device), {True: [], False: []}, defaultdict(list)
    on_calls = set()
    with driver.traced(model, spans):
        for i in range(calls):
            on = i % 4 in (1, 2)
            spans.call = i
            if on:
                profiling.enable(device)
                on_calls.add(i)
            c0 = time.perf_counter()
            failed = one(i)
            seconds[on].append(time.perf_counter() - c0)
            if on:
                profiling.resolve()
                profiling.disable()
                for k, v in readings(profiling.records(), {0}).items():
                    values[k] += v
            if failed:
                raise RuntimeError(f"call {i}: {failed} clips not finite")
        spans.resolve()
        profiling.enable(device)
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
            for i in range(calls, calls + traffic["trace_calls"]):
                spans.call = i
                with record_function("bench::call"):
                    one(i)
        profiling.resolve()
        profiling.disable()
    recorded_steps = sum(r.name == "ddim_step" for r in profiling.records())
    traced_steps = len(_events(prof)[2]["dawn::ddim_step"])

    steps = config["sampling_timesteps"]
    ddim, unet = (spans.per_call(spans.host_s, "ddim"), spans.per_call(spans.device_ms, "unet"))
    issue, decode = (spans.per_call(spans.issue_ms, "unet"),
                     spans.per_call(spans.host_s, "decode"))
    bench = {}
    for side, picked in (("on", sorted(on_calls)),
                         ("off", [i for i in range(calls) if i not in on_calls])):
        bench[side] = {
            "ddim_s": mean([v for i in picked for v in ddim[i]]),
            "decode_s": mean([v for i in picked for v in decode[i]]),
            "unet_ms": mean([v for i in picked for v in unet[i]]),
            "unet_enqueue_ms": mean([v for i in picked for v in issue[i]]),
            "sampler_ms": mean([(sum(ddim[i]) * 1e3 - sum(unet[i])) / steps for i in picked])}
    med = {side: statistics.median(s) for side, s in (("on", seconds[True]),
                                                      ("off", seconds[False]))}
    return {
        "workload": cell.name, "seed": seed, "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "seconds_on": seconds[True], "seconds_off": seconds[False],
        "recorder_cost_ms": (med["on"] - med["off"]) * 1e3, "bench_spans": bench,
        "threshold_ms": mean(values["threshold"]),
        "sampler_self_ms": mean(values["sampler_self"]),
        "unet_lead_ms": mean(values["unet_lead"]),
        "unet_lead_ms_min": min(values["unet_lead"], default=None),
        "unet_lead_ms_max": max(values["unet_lead"], default=None),
        "unet_end_lead_ms": mean(values["unet_end_lead"]),
        "items": {k: len(v) for k, v in values.items()},
        "step_kernels": step_kernels(prof),
        "profiled_steps": {"recorder": recorded_steps, "trace": traced_steps},
        "span_cost_us": span_cost_us(device, steps),
        "idle_gaps": idle_gaps(prof)}


def main(argv=None) -> int:
    from benchmark import manifest
    from benchmark.run import set_cache_dirs
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=8)
    args = p.parse_args(argv)
    set_cache_dirs(manifest.ROOT)
    cell = manifest.resolve(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("program_spans: no CUDA card; no run on the CPU", file=sys.stderr)
        return 3
    print(json.dumps(measure(cell, args.seed, args.calls, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
