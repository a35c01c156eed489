"""The benchmark's m4 recipe, for the port's users of a trained model
(`python -m repro_torch.serve --backend m4`, the examples).

benchmarks/common.py's `BENCH_M4` widths, the corpus of its
`train_suite_spec` (N_TRAIN_SIMS synthetic sims of FLOWS_PER_SIM flows of
table2_train_space) and `BENCH_TC`, copied so that the port imports
nothing of it.
"""
from __future__ import annotations

import dataclasses

BENCH_M4 = dict(hidden=96, gnn_dim=64, mlp_hidden=64, snap_flows=16,
                snap_links=48)
N_TRAIN_SIMS = 12
FLOWS_PER_SIM = 150
BENCH_TC = dict(epochs=10, lr=1e-3, schedule="const", step_mode="per_sim",
                shuffle=False)


def train_suite_spec(n: int = N_TRAIN_SIMS):
    """The benchmark training corpus (`benchmarks.common.train_suite_spec`)."""
    from ..scenarios import get_suite
    return get_suite("table2_train_space", n=n, num_flows=FLOWS_PER_SIM,
                     synthetic=True)


def trained_m4(ckpt_dir: str, data_dir: str, device, log=print):
    """The benchmark model from `ckpt_dir` (a checkpoint of either
    package), trained there first with `train_suite`, its dataset in
    `data_dir` built by one worker, when no finished checkpoint is found;
    a half-trained one resumes. Returns (params on `device`, cfg)."""
    from ..core.model import M4Config
    from .loop import TrainConfig, load_state, train_suite
    cfg = M4Config(**BENCH_M4)
    tc = TrainConfig(**BENCH_TC)
    state, done = load_state(ckpt_dir, cfg, device=device)
    if state is not None and done >= tc.epochs:
        log(f"[m4] weights {state.weights_hash()[:12]} from {ckpt_dir} "
            f"(epoch {done})")
        return state.params, cfg
    log(f"[m4] no finished checkpoint in {ckpt_dir}: training the "
        "benchmark model")
    state, _ = train_suite(train_suite_spec(), cfg,
                           dataclasses.replace(tc, ckpt_dir=ckpt_dir),
                           data_root=data_dir, workers=1, device=device,
                           log=log)
    return state.params, cfg
