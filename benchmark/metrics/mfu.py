"""Share of the card's bf16 dense peak: the operations of one call
(counted on the plain reference at the cell's shapes) times the calls of
the window, over the window."""


def read(run):
    if not run.call_flops or not run.rates:
        return None
    return 100.0 * run.call_flops * len(run.calls) / (run.window_s * run.rates[1])
