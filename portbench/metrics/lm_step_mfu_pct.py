"""The whole decode step's share of its roofline: per step of the traced
calls the bound of its work (`counts.lm_decode_work`: the larger of its
operations over 989 TFLOP/s in bfloat16 and its bytes over 3.35 TB/s;
weights, KV cache up to the step's position after the prompt, SSM
states), summed, over the traced window's wall seconds."""
from portbench.harness import counts


def read(run):
    tr = run.trace
    if tr is None or not run.traced_calls or tr.window_s <= 0:
        return None
    m, c = run.model, run.cell.config["constants"]
    per_call = sum(counts.bound_s(*counts.lm_decode_work(m, c, run.batch, t),
                                  peak_flops=counts.PEAK_BF16_FLOPS)
                   for t in range(run.prompt, run.prompt + run.steps))
    return 100.0 * per_call * len(run.traced_calls) / tr.window_s
