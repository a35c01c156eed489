"""Flows whose completion times the window's `run_many` calls returned
(each call's units), over the wall seconds from the first call's start
to the last call's return (results on the host): all the work and all
the time of the window (whole passes over the pool), host preparation
between calls included."""


def read(run):
    calls = run.calls
    return sum(c.units for c in calls) / (calls[-1].end - calls[0].start)
