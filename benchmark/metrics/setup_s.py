"""Seconds from the start of the run to the first timed call."""


def read(run):
    return run.setup_s
