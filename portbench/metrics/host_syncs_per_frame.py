"""Host waits for the card inside the traced frames, per frame: runtime
synchronize calls and blocking copies (a host read of a device value is
one of them); the harness's synchronize that ends a frame is not counted."""

from harness.readers import SYNC_CALLS, in_frames


def read(run):
    if run.trace is None:
        return None
    n = sum(1 for name, s, _, _ in run.trace.runtime if name in SYNC_CALLS and in_frames(run, s))
    return n / run.traced_frames
