"""Share of its roofline that the temporal attention reaches in the traced
calls: the least time its calls need (each call's operations at the bf16
peak or its bytes at the memory rate, whichever is larger, counted from
its shapes) over the device time of the kernels launched inside the
benchmark's span around it."""

from benchmark.arith import roofline_seconds


def read(run):
    if run.spans is None or run.trace is None:
        return None
    device_s = run.trace.span_device_s.get("temporal_attn", 0.0)
    least = sum(roofline_seconds(flops, nbytes, run.rates)
                for call, flops, nbytes in run.spans.counts.get("temporal_attn", [])
                if call >= len(run.calls))
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
