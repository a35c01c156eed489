"""Device microseconds per decode step: every device operation of the
traced calls (kernels, copies and fills) over their steps."""


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    t = run.trace.op_seconds()
    return t / (run.steps * len(run.traced_calls)) * 1e6 if t > 0 else None
