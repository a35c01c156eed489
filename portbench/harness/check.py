"""The judgement that decides `correct`: each number that the cell's lane
compares (`Lane.numbers`: the window's answers against the plain
reference's) held to its limit in `portbench/cells/<cell>.json`. A cell
compares those numbers that its file gives a limit.
"""
from __future__ import annotations


def judge(nums: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for every number with a limit."""
    return {k: {"value": nums[k], "limit": lim, "ok": nums[k] <= lim}
            for k, lim in limits.items()}
