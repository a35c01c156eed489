"""Injectable time source for the serving layer (the port of
`repro.serve.clock`, unchanged).

The dispatcher's deadline-flush logic ("flush this bucket 50ms after its
oldest request arrived") is pure bookkeeping over *some* notion of now —
nothing about it requires wall time. `Clock` narrows the two operations
the service performs (read now, wait-until-notified-or-deadline) so tests
can swap in `ManualClock` and drive every deadline decision explicitly:
no `time.sleep` in the suite, no flaky "was 50ms long enough on a loaded
CI box" timing, and a wedged dispatcher fails fast instead of hanging on
a real timer.

`ManualClock.advance()` wakes every condition the service has waited on,
so a test advances simulated time past a flush deadline and the
dispatcher observes it on its next scan — deterministically.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class Clock:
    """Time source protocol: `now()` plus condition-variable waiting."""

    def now(self) -> float:
        """Current time in seconds (monotonic; origin unspecified)."""
        raise NotImplementedError

    def wait(self, cond: threading.Condition, timeout: Optional[float]):
        """Block on `cond` (which the caller holds) until notified or —
        for real clocks — until `timeout` seconds elapse."""
        raise NotImplementedError


class MonotonicClock(Clock):
    """Production clock: `time.monotonic` + plain timed condition waits."""

    def now(self) -> float:
        return time.monotonic()

    def wait(self, cond: threading.Condition, timeout: Optional[float]):
        cond.wait(timeout if timeout is None else max(0.0, timeout))


class ManualClock(Clock):
    """Test clock: time moves only via `advance()`/`set()`.

    `wait` ignores the requested timeout entirely and blocks until
    notified — the service is woken by submissions, shutdown, and by
    `advance()` (which notifies every condition ever waited on), so a
    test controls exactly when the dispatcher re-evaluates its deadlines.
    A dispatcher that would "oversleep" a deadline under this clock waits
    forever instead, which the suite's future timeouts turn into a loud
    failure rather than a silent race.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()
        self._waiters: set = set()

    def now(self) -> float:
        with self._lock:
            return self._t

    def wait(self, cond: threading.Condition, timeout: Optional[float]):
        with self._lock:
            self._waiters.add(cond)
        cond.wait(None)

    def set(self, t: float):
        """Jump to absolute time `t` and wake every waiter."""
        with self._lock:
            if t < self._t:
                raise ValueError(f"clock cannot run backwards "
                                 f"({t} < {self._t})")
            self._t = float(t)
            waiters = list(self._waiters)
        for cond in waiters:
            with cond:
                cond.notify_all()

    def advance(self, dt: float):
        """Move time forward by `dt` seconds and wake every waiter."""
        if dt < 0:
            raise ValueError(f"negative advance {dt}")
        with self._lock:
            target = self._t + float(dt)
        self.set(target)
