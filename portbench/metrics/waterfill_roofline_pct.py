"""The water-filling's share of its roofline: per event, the bound of the
function's work (its inputs and outputs once; the rounds that these
inputs need, as the reference counts them, over every incidence entry,
link and flow), summed over the traced window's events, over the device
time of the kernel that does it."""
from portbench.harness import counts

KERNELS = ("waterfill_event_kernel",)
LIST_WIDTH = 4       # links a flow in the incidence's one encoding


def read(run):
    tr = run.trace
    if tr is None or not run.traced_calls:
        return None
    t = tr.op_seconds(KERNELS)
    if t <= 0:
        return None
    per_pool = {}
    for k in {c.pool for c in run.traced_calls}:
        rounds, nnz = run.counts[k]["rounds"], run.nnz[k]
        per_pool[k] = sum(counts.bound_s(*counts.waterfill_event_work(
            run.batch, run.num_flows, run.num_links[k], LIST_WIDTH, r, nnz))
            for r in rounds)
    bound = sum(per_pool[c.pool] for c in run.traced_calls)
    return 100.0 * bound / t
