"""Frames completed over the whole measured window, per second of it."""


def read(run):
    return run.frames / run.window_s
