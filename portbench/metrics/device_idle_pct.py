"""The share of the traced window in which no kernel, copy or memset ran
on the card."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_window_s)
