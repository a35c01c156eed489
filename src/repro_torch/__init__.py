"""repro_torch — m4 and flowSim in PyTorch, with hand-written CUDA kernels
for Hopper (`sm_90a`).

The package mirrors the layout of the JAX package `repro`, which stays the
reference it is held against, but imports nothing of it (nor `jax`):

    repro_torch.net        FatTree, NetConfig, Flow, the packet DES
    repro_torch.data       the Table-2 traffic generator and the workload
                           families
    repro_torch.nn         linear / mlp / gru_cell on (d_in, d_out) weights
    repro_torch.kernels    the fused GRU pair, the bipartite GraphSAGE round
                           and flowSim's water-filling (an event's rounds
                           in one launch; the row-min alone): CUDA kernels
                           on a card, plain PyTorch on the CPU
    repro_torch.core       M4Config, the model, m4's open and closed loops,
                           flowSim (numpy) and flowsim_fast, make_backlog;
                           `core.compiled`, one compiled program (a CUDA
                           graph on a card) per arena shape of the open
                           loops
    repro_torch.sim        SimRequest / SimResult, the backend registry
                           (packet, flowsim, flowsim_fast, m4),
                           run_closed_loop
    repro_torch.scenarios  scenario specs, named suites, SweepRunner
                           (python -m repro_torch.scenarios)
    repro_torch.train      dataset store, fit, evaluate_m4, train_suite
                           (python -m repro_torch.train)
    repro_torch.serve      SimService: dynamic batching into shape
                           buckets, coalescing, backpressure, an HTTP
                           front-end (python -m repro_torch.serve)
    repro_torch.fleet      supervised spawn workers for sweeps and dataset
                           builds: leases, retry, poison, reaping, chaos
                           plans (python -m repro_torch.fleet)
    repro_torch.runtime    checkpoints, blob store and leases, zstd
                           reader, guards (no_retrace), fault-tolerance
                           policies
    repro_torch.weights    the bridge from a JAX parameter tree

Entry points:

    from repro_torch.sim import SimRequest, get_backend, run_closed_loop
    res = get_backend("m4", params=params, cfg=cfg).run(req)   # on the card
    res = get_backend("flowsim_fast").run(req)                 # on the card

Precision: everything runs in float32, except flowsim_fast's two link
sums, taken exactly in float64 and rounded once (see
`repro_torch.core.flowsim_fast`). TF32 is switched off for matrix
products and for cuDNN when the package is imported, so the plain
matmuls around the kernels (projections, MLP heads) round as the JAX
reference does.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
