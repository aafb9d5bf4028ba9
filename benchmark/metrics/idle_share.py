"""Share of the traced window, one whole epoch, in which the device runs
nothing (%), from the profiler's device records."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
