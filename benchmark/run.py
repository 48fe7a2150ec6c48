"""Runs one cell of the benchmark once and prints its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (``setup_s``, from the start of this module): the CUDA
context, the program and its kernel builds, the weights made on the card
from the seed, and one warm-up call at the cell's shapes. The window then
runs whole calls back to back, each on new inputs drawn on the card from
the seed and the call's index, each waited for (one client, closed loop),
and ends at the end of the last call started inside ``--seconds``.

With ``--trace 1`` the window also records the benchmark's spans around
the program's layers, and after it a few more calls run under
``torch.profiler`` with the host's operations recorded, then as many with
the card's activity alone (the busy share); the result carries the
per-layer metrics instead of the end-to-end ones.

Once the window has closed and its memory peak is read, the program is
freed, and one call of the window, drawn from the seed, is computed again
by the plain float32 reference from the same weights and inputs; the
numbers compared and their limits are the last lines of standard error and
the ``checks`` of the result, the last line of standard output. A run
prints no result and exits non-zero without a card, with fewer cards than
the cell asks for, without the program, or when a module of the JAX
package or of JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from benchmark import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dawn_tpu")
WARMUP_INDEX = -1


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` of JAX and of the JAX package,
    each compared whole (``dawn_tpu_torch`` is not ``dawn_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Every kernel cache of PyTorch at a fixed path inside the checkout
    (the program builds its own kernels into ``dawn_tpu_torch/_build``)."""
    base = os.path.join(root, manifest.PKG, "_cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(base, "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


@dataclasses.dataclass
class Run:
    """What the metric readers read (``benchmark/metrics/<name>.py``)."""
    cell: manifest.Cell
    setup_s: float
    window_s: float
    calls: List[dict]                   # per call: seconds, frames, clips
    spans: Optional[object] = None      # benchmark.spans.Spans of a traced run
    trace: Optional[object] = None      # benchmark.trace.TraceSummary of a traced run
    device_busy: Optional[tuple] = None  # (busy s, window s) of the card-only profile
    call_flops: Optional[int] = None
    rates: Optional[tuple] = None       # (bytes/s, bf16 FLOP/s, f32 FLOP/s)
    peak_window_bytes: int = 0

    @property
    def steps(self) -> int:
        return self.cell.config["sampling_timesteps"]


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START):
    """One run of ``cell``; returns (result dict, lines for standard output,
    lines for standard error). The card check is the caller's."""
    import torch
    from benchmark.arith import card_peaks
    from benchmark.spans import Spans, sync

    config, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    family = config["family"]
    driver = importlib.import_module(f"{manifest.PKG}.drivers.{family}")
    reference = importlib.import_module(f"{manifest.PKG}.reference.{family}")
    out_lines: List[str] = []

    driver.set_precision(config)
    model = driver.build(config, reference.seeded_state_dict(config, seed, device), device)
    driver.call(model, config, reference.make_inputs(config, traffic, seed, WARMUP_INDEX, device))
    sync(device)
    setup_s = time.perf_counter() - t_start

    spans = Spans(device) if trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rng = random.Random(seed)
    calls: List[dict] = []
    kept_index, kept = None, None
    failed = 0
    frames = traffic["batch"] * traffic["frames"]
    with driver.traced(model, spans) if trace else contextlib.nullcontext():
        w0 = time.perf_counter()
        while not calls or time.perf_counter() - w0 < seconds:
            i = len(calls)
            if spans is not None:
                spans.call = i
            c0 = time.perf_counter()
            with torch.profiler.record_function("bench::call"):
                out = driver.call(model, config,
                                  reference.make_inputs(config, traffic, seed, i, device))
                bad = driver.failed_items(out)
            c1 = time.perf_counter()
            failed += bad
            calls.append({"seconds": c1 - c0, "end": c1 - w0, "frames": frames,
                          "clips": traffic["batch"]})
            if rng.random() * (i + 1) < 1.0:       # one call drawn uniformly, by the seed
                kept_index, kept = i, out
            del out
        window_s = calls[-1]["end"]
        if spans is not None:
            spans.resolve()
        peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
        p0 = time.perf_counter()
        summary = _profile(model, driver, reference, config, traffic, seed, spans,
                           len(calls), device) if trace else None
    busy, busy_calls = (_profile_device(model, driver, reference, config, traffic, seed,
                                        len(calls) + traffic["trace_calls"], device)
                        if trace and cuda else (None, []))
    out_lines.append("calls: " + " ".join(f"{c['seconds']:.4f}" for c in calls))
    if busy_calls:
        out_lines.append("calls profiled on the card alone: "
                         + " ".join(f"{x:.4f}" for x in busy_calls))
    out_lines.append(f"seconds: set-up {setup_s:.3f}, window {window_s:.3f}, "
                     f"profiled calls and their reading {time.perf_counter() - p0:.3f}")
    peak_run = torch.cuda.max_memory_allocated(device) if cuda else 0

    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, err_lines = _check(cell, reference, seed, kept_index, kept, failed, device)
    rates = card_peaks(torch.cuda.get_device_name(device) if cuda else "")[1]
    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, calls=calls, spans=spans,
              trace=summary, device_busy=busy, rates=rates, peak_window_bytes=peak_window,
              call_flops=reference.call_flops(config, traffic) if trace else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = manifest.reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak_run)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": sum(c["clips"] for c in calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if busy is not None:
        dev["busy_s"], dev["window_s"] = busy
        out_lines.append(f"card alone: window {busy[1]:.6f} s, busy {busy[0]:.6f} s")
    if summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
        out_lines.append(f"trace with the host's operations: {summary.events} events, "
                         f"window {summary.window_s:.6f} s, busy {summary.busy_s:.6f} s, "
                         f"spans {summary.span_device_s}")
    result["checks"] = checks
    return result, out_lines, err_lines


def _profile(model, driver, reference, config, traffic, seed, spans, first, device):
    """``traffic['trace_calls']`` more calls under ``torch.profiler``, the
    host's operations recorded with the card's: the device time of each
    span, the top device operations, the idle stretches by host op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from benchmark import trace as tracing
    from benchmark.spans import sync
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for i in range(first, first + traffic["trace_calls"]):
            spans.call = i
            with torch.profiler.record_function("bench::call"):
                driver.call(model, config, reference.make_inputs(config, traffic, seed, i, device))
                sync(device)
    spans.resolve()
    return tracing.summarize(prof)


def _profile_device(model, driver, reference, config, traffic, seed, first, device):
    """``traffic['trace_calls']`` more calls, as the window runs them (no
    spans), under ``torch.profiler`` with the card's activity alone:
    recording the host's operations as well slows the host's dispatch, and
    the card's idle share with it. Returns ((busy s, window s), the host
    seconds of each call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from benchmark import trace as tracing
    from benchmark.spans import sync
    seconds = []
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + traffic["trace_calls"]):
            c0 = time.perf_counter()
            driver.failed_items(driver.call(
                model, config, reference.make_inputs(config, traffic, seed, i, device)))
            seconds.append(time.perf_counter() - c0)
    busy = tracing.device_busy(prof)
    return (busy if busy[0] > 0 else None), seconds


def _check(cell, reference, seed, index, got, failed, device):
    """The kept call against the reference; returns the checks and the
    lines for standard error (each number beside its limit)."""
    config = cell.config
    ref = reference.build(config, reference.seeded_state_dict(config, seed, device), device)
    t0 = time.perf_counter()
    values = reference.judge(ref, reference.make_inputs(config, cell.traffic, seed, index, device),
                             got)
    ref_s = time.perf_counter() - t0
    checks: Dict[str, dict] = {}
    for name, value in values.items():
        limit = cell.limits.get(name, {}).get("limit", float("-inf"))
        checks[name] = {"value": value, "limit": limit}
    checks["failed_clips"] = {"value": failed, "limit": 0}
    lines = [f"reference: call {index} of the window, {ref_s:.3f} s"]
    lines += [f"{name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return checks, lines


def _finite(x):
    """The result with every number that is not finite (a check of a video
    that holds NaN) written as null, so that the line is strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs(manifest.ROOT)
    try:
        cell = manifest.resolve(args.workload)
    except (manifest.ManifestError, OSError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), found {have}; "
              "no run on the CPU", file=sys.stderr)
        return 3
    try:
        result, out_lines, err_lines = run_cell(cell, args.seed, args.seconds,
                                                bool(args.trace), "cuda")
    except ImportError as e:
        print(f"benchmark: the program cannot be imported: {e}", file=sys.stderr)
        return 4
    return report(result, out_lines, err_lines)


def report(result: dict, out_lines: List[str], err_lines: List[str]) -> int:
    """Prints a run's lines, and its result last, unless a module of JAX or
    of the JAX package is loaded by now: after the window, the metric
    readers and the reference, just before the result would be printed."""
    for line in out_lines:
        print(line)
    for line in err_lines:
        print(line, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}; no result",
              file=sys.stderr)
        return 5
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
