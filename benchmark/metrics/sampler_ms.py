"""Self time of one DDIM step in milliseconds: a call's ``ddim_s`` less
the device time of the UNet calls inside it, over the steps; the mean over
the calls of the window."""


def read(run):
    if run.spans is None:
        return None
    ddim = run.spans.per_call(run.spans.host_s, "ddim")
    unet = run.spans.per_call(run.spans.device_ms, "unet")
    values = [(sum(ddim[c]) * 1e3 - sum(unet.get(c, []))) / run.steps
              for c in ddim if c < len(run.calls)]
    return sum(values) / len(values) if values else None
