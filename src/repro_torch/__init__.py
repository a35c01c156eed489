"""repro_torch — m4's open-loop inference in PyTorch, with hand-written
CUDA kernels for Hopper (`sm_90a`).

The package mirrors the layout of the JAX package `repro`, which stays the
reference it is held against, but imports nothing of it (nor `jax`):

    repro_torch.net        FatTree, NetConfig, Flow
    repro_torch.data       the Table-2 traffic generator
    repro_torch.nn         linear / mlp / gru_cell on (d_in, d_out) weights
    repro_torch.kernels    the fused GRU pair and bipartite GraphSAGE round:
                           CUDA kernels on a card, plain PyTorch on the CPU
    repro_torch.core       M4Config, the model, the open-loop event loop
    repro_torch.sim        SimRequest / SimResult and the backend registry
    repro_torch.weights    the bridge from a JAX parameter tree

Entry point:

    from repro_torch.sim import SimRequest, get_backend
    res = get_backend("m4", params=params, cfg=cfg).run(req)   # on the card

Precision: everything runs in float32. TF32 is switched off for matrix
products and for cuDNN when the package is imported, so the plain
matmuls around the kernels (projections, MLP heads) round as the JAX
reference does.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
