"""Host milliseconds a traced call spends turning completion times read
back into results: the self time of the port's `sim.results` span
(flowSim: each flow's ideal completion time and slowdown), averaged over
the traced calls."""
from portbench.harness import spans


def read(run):
    return spans.self_ms(run, "sim.results")
