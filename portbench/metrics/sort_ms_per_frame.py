"""Device milliseconds a frame of the downsample's sort: the kernels
launched under the ``aten::sort`` of the input buffer's capacity (the
Morton keys of every slot), found through the launches' correlation ids."""


def read(run):
    if run.trace is None:
        return None
    spans = [(s, s + d) for name, s, d, _, dims in run.trace.ops
             if name == "aten::sort" and dims and dims[0] == [run.capacity]]
    if not spans:
        return None
    corr = {c for _, s, _, c in run.trace.runtime if c is not None and any(a <= s <= b for a, b in spans)}
    secs = sum(d for _, _, d, c in run.trace.kernels if c in corr) / 1e6
    return 1e3 * secs / run.traced_frames if secs > 0 else None
