"""Share of the traced window's wall time in which no operation ran on
the device (kernels, copies and fills), from the profiler's timeline."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
