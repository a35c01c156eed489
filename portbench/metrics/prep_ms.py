"""Host milliseconds a traced call spends preparing its batch before the
first upload: the self time of the port's `sim.prep` span (m4: the
padded sizes, `make_static` and the arrival order of each scenario;
flowSim: the sizes and each flow's row of link ids, `_pack`), averaged
over the traced calls."""
from portbench.harness import spans


def read(run):
    return spans.self_ms(run, "sim.prep")
