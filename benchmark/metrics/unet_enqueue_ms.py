"""Mean host milliseconds to issue one UNet call in the window, without a
synchronisation."""


def read(run):
    spans = run.spans.per_call(run.spans.issue_ms, "unet") if run.spans else {}
    values = [v for call, vs in spans.items() if call < len(run.calls) for v in vs]
    return sum(values) / len(values) if values else None
