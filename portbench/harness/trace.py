"""The device trace of a window, read from `torch.profiler`, reduced to
what the per-layer metrics read: the device's operations (name, start,
end), the window's calls (the benchmark's own spans around each
`run_many`), and the host's operations that labels the idle gaps.

Times are nanoseconds on the profiler's clock, which it shares between
host and device records. The raw records are dropped once reduced.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

CALL_SPAN = "portbench.run_many"


@dataclass
class Trace:
    window: tuple                     # (start, end) of the traced window
    calls: List[tuple]                # (start, end) of each run_many
    dev_names: List[str]              # device operation names, by id
    dev_op: np.ndarray                # (n,) name id of each device op
    dev_start: np.ndarray             # (n,) int64
    dev_end: np.ndarray               # (n,) int64
    host: List[tuple] = field(default_factory=list)  # (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        """The union of the device's operations, clipped to the window:
        sorted disjoint (start, end) arrays."""
        lo, hi = self.window
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        if not len(s):
            return s, e
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        idx = np.flatnonzero(new)
        # a piece ends at the running end just before the next one starts
        return s[idx], run_end[np.r_[idx[1:] - 1, len(s) - 1]]

    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) * 1e-9

    def gaps(self):
        """The idle gaps inside the window: (start, end) arrays."""
        s, e = self.busy_intervals()
        lo, hi = self.window
        g_s = np.r_[lo, e]
        g_e = np.r_[s, hi]
        keep = g_e > g_s
        return g_s[keep], g_e[keep]

    def op_seconds(self, patterns=None) -> float:
        """Device seconds of the operations whose name holds one of
        `patterns` (all operations when None)."""
        dur = (self.dev_end - self.dev_start).astype(np.float64)
        if patterns is None:
            return float(dur.sum()) * 1e-9
        hit = np.array([any(p in n for p in patterns)
                        for n in self.dev_names], bool)
        if not hit.any():
            return 0.0
        return float(dur[hit[self.dev_op]].sum()) * 1e-9

    def by_name(self):
        """[(name, device seconds)] of every operation name, longest
        first."""
        dur = (self.dev_end - self.dev_start).astype(np.float64) * 1e-9
        tot = np.bincount(self.dev_op, weights=dur,
                          minlength=len(self.dev_names))
        order = np.argsort(-tot, kind="stable")
        return [(self.dev_names[i], float(tot[i])) for i in order
                if tot[i] > 0]

    def host_label(self, t: int) -> str:
        """The innermost host operation that spans time t; inside a call
        but no torch operation, the host's own work (Python, numpy)."""
        best = None
        for s, e, name in self.host:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        if best is None:
            return "between calls"
        if best[2] == CALL_SPAN:
            return f"{CALL_SPAN}: host work outside torch operations"
        return f"{CALL_SPAN}: {best[2]}"


class Profiler:
    """`torch.profiler` over host and device, started and stopped around
    part of a window; `trace()` reduces what it recorded."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self):
        self._prof.start()

    def stop(self):
        self._prof.stop()

    def trace(self) -> "Trace":
        import torch
        out = reduce(self._prof.profiler.kineto_results.events(), torch)
        self._prof = None
        return out


def reduce(events, torch) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    names, ids = [], {}
    op, start, end = [], [], []
    host, calls = [], []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if ev.is_user_annotation():     # a host span's device range
                continue
            n = ev.name()
            i = ids.get(n)
            if i is None:
                i = ids[n] = len(names)
                names.append(n)
            op.append(i)
            start.append(s)
            end.append(e)
        else:
            n = ev.name()
            if n == CALL_SPAN:
                calls.append((s, e))
            host.append((s, e, n))
    calls.sort()
    window = (calls[0][0], calls[-1][1]) if calls else (0, 0)
    return Trace(window=window, calls=calls, dev_names=names,
                 dev_op=np.array(op, np.int64),
                 dev_start=np.array(start, np.int64),
                 dev_end=np.array(end, np.int64), host=host)
