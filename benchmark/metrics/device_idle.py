"""Share of the window of calls profiled with the card's activity alone
(first device event to last) in which no kernel, copy or set ran on the
card (their intervals merged)."""


def read(run):
    if run.device_busy is None or run.device_busy[1] <= 0 or run.device_busy[0] <= 0:
        return None
    busy_s, window_s = run.device_busy
    return 100.0 * (1.0 - busy_s / window_s)
