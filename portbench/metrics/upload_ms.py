"""Host milliseconds a traced call spends handing its batch to the
device: the self time of the port's `sim.upload` span (flowSim: the
stacking of the packed scenarios and the pageable host-to-device copy,
which the host waits for), averaged over the traced calls."""
from portbench.harness import spans


def read(run):
    return spans.self_ms(run, "sim.upload")
