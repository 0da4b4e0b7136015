"""Points whose md the exact chain's brute-force fixup computed, per frame
of the window: the chain's own returned count, summed."""


def read(run):
    if run.uncovered is None:
        return None
    return run.uncovered / run.frames
