"""The GraphSAGE rounds' share of their roofline: the bound of the
function's work (every round of an event for the batch, over the live
edges the reference counts) over the device time of the kernels that do
it."""
from portbench.harness import counts

KERNELS = ("bipartite_rounds_kernel",)


def read(run):
    tr = run.trace
    if tr is None or not run.traced_calls:
        return None
    t = tr.op_seconds(KERNELS)
    if t <= 0:
        return None
    bound = 0.0
    for c in run.traced_calls:
        events = 2 * run.num_flows
        live = float(run.counts[c.pool]["live_edges"].sum()) / events
        bound += events * counts.bound_s(*counts.gnn_work(
            run.model, run.batch, live))
    return 100.0 * bound / t
