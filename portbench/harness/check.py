"""The comparison that decides `correct`: every completion time that the
window's calls returned, against the plain reference's for the same
scenario.

Each number compared is computed over all of them and has its limit in
`portbench/cells/<cell>.json`:

- `fct_rel_max`: the largest relative gap |got - ref| / ref of any flow;
- `fct_rel_p99`: the 99th percentile of the relative gaps of all flows;
- `answer_rel_p50_max`: per answer (one scenario's completion times, as
  one request of a call returned them) the median relative gap of its
  flows, and the largest of these over every answer of the window.

A flow with no finite time, or of an answer that did not come back, has
an infinite gap. A cell compares those numbers that its file gives a
limit.
"""
from __future__ import annotations

import numpy as np


def gaps(calls, refs):
    """Relative gaps of every flow of every answer, one array an answer.
    `calls`: [(pool index, [fcts per scenario])]; `refs`: pool index ->
    [reference times per scenario]."""
    rel = []
    for k, fcts in calls:
        for b, want in enumerate(refs[k]):
            got = fcts[b] if b < len(fcts) else None
            w = np.asarray(want, np.float64)
            if got is None or len(got) != len(want):
                got = np.full(len(w), np.nan)
            got = np.asarray(got, np.float64)
            ok = np.isfinite(got)
            gap = np.full(len(w), np.inf)
            gap[ok] = np.abs(got[ok] - w[ok]) / np.abs(w[ok])
            rel.append(gap)
    return rel


def numbers(calls, refs) -> dict:
    per = gaps(calls, refs)
    rel = np.concatenate(per) if per else np.zeros(0)
    inf = float("inf")
    return {"fct_rel_max": float(rel.max()) if rel.size else inf,
            "fct_rel_p99": float(np.quantile(rel, 0.99)) if rel.size
            else inf,
            "answer_rel_p50_max": max((float(np.median(r)) if r.size
                                       else inf for r in per), default=inf)}


def judge(nums: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for every number with a limit."""
    return {k: {"value": nums[k], "limit": lim, "ok": nums[k] <= lim}
            for k, lim in limits.items()}
