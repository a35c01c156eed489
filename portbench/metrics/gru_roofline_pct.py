"""The fused GRU stages' share of their roofline: the bound of the
function's work (both stages of an event at the snapshot's shapes, for
the batch) over the device time of the kernels that do it."""
from portbench.harness import counts, flows

KERNELS = ("gru_pair_kernel",)


def read(run):
    tr = run.trace
    if tr is None or not run.traced_calls:
        return None
    t = tr.op_seconds(KERNELS)
    if t <= 0:
        return None
    bound = flows.events(run) * counts.bound_s(*counts.gru_work(run.model,
                                                           run.batch))
    return 100.0 * bound / t
