"""The window over the number of clips it finished."""


def read(run):
    return run.window_s / sum(c["clips"] for c in run.calls)
