"""Process start to the first timed frame: imports, the card's context,
the data, the kernels' load (and build, in a checkout's first run) and the
warm-up."""


def read(run):
    return run.setup_s
