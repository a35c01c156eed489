"""The whole m4 step's share of the card's float32 peak: the model's
operations in the traced window's events (both GRU stages, the
projections, the GraphSAGE rounds over the snapshots' live edges as the
reference counts them, MLP-sldn, MLP-init of each arrival), each counted
once, over the window's wall seconds, over 67 TFLOP/s."""
from portbench.harness import counts


def read(run):
    tr = run.trace
    if tr is None or not run.traced_calls or tr.window_s <= 0:
        return None
    flops = 0.0
    for c in run.traced_calls:
        events = 2 * run.num_flows
        live = float(run.counts[c.pool]["live_edges"].sum())
        flops += events * counts.m4_step_flops(
            run.model, run.batch, live / events, c.units / events)
    return 100.0 * flops / tr.window_s / counts.PEAK_FP32_FLOPS
