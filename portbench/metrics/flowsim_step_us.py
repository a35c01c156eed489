"""Device microseconds per batched flowSim event: every device operation
of the traced window over its batched events (2N a call)."""
from portbench.harness import flows


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    t = run.trace.op_seconds()
    return t / flows.events(run) * 1e6 if t > 0 else None
