"""The card's idle share of the traced window: 1 - the union of the
profiler's kernel, copy and memset intervals over the window."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
