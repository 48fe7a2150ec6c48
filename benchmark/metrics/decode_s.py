"""Mean seconds of ``decode_latents`` a call of the window (host clock,
the card synchronised at both ends)."""


def read(run):
    spans = run.spans.per_call(run.spans.host_s, "decode") if run.spans else {}
    values = [v for call, vs in spans.items() if call < len(run.calls) for v in vs]
    return sum(values) / len(values) if values else None
