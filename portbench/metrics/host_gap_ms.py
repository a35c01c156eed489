"""Device-idle milliseconds per `run_many` call before its device work:
from the call's start (the benchmark's span around it) to the first
device operation inside it, averaged over every call of the traced
window. It is the host's preparation of a call (tables, padding,
stacking, the packed incidence) that the device waits for."""
import numpy as np


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    start = np.sort(tr.dev_start)
    gaps = []
    for c0, c1 in tr.calls:
        lo, hi = np.searchsorted(start, [c0, c1])
        if hi <= lo:
            return None
        gaps.append(start[lo] - c0)
    return float(np.mean(gaps)) * 1e-6
