"""Mean device milliseconds of one UNet call in the window (CUDA events
around the call on the current stream)."""


def read(run):
    spans = run.spans.per_call(run.spans.device_ms, "unet") if run.spans else {}
    values = [v for call, vs in spans.items() if call < len(run.calls) for v in vs]
    return sum(values) / len(values) if values else None
