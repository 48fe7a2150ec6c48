"""Frames of finished video (decode included) over the whole window."""


def read(run):
    return sum(c["frames"] for c in run.calls) / run.window_s
