"""Quickstart on the PyTorch port: the whole m4 pipeline end to end (the
twin of examples/quickstart.py). Runs on the card unless given
`--device cpu`.

1. Declare Table-2 scenarios on the paper's 8-rack training fat-tree.
2. Build the ground-truth corpus through the `repro_torch.train` dataset
   store (packet-level DES shards, content-hash cached: rerunning this
   script skips straight to training).
3. Train m4 (GRUs + bipartite GNN + 3 query MLPs) with dense supervision
   via the bucketed, resumable `repro_torch.train.fit` loop.
4. Evaluate per-flow FCT-slowdown error on a held-out empirical workload,
   against the flowSim baseline, through the `repro_torch.sim` registry.

  PYTHONPATH=src python examples/quickstart_torch.py [--flows 100] [--sims 4]
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core.model import M4Config
from repro_torch.scenarios import get_suite, random_spec
from repro_torch.train import TrainConfig, build_dataset, evaluate_m4, fit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--flows", type=int, default=100)
    ap.add_argument("--sims", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--workdir", default="results")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = M4Config(hidden=64, gnn_dim=48, mlp_hidden=32,
                   snap_flows=16, snap_links=48)

    print("== building ground truth (packet-level DES, cached shards) ==")
    # training sims = the paper's Table-2 training distribution as a
    # declarative suite; holdout = one empirical (test-distribution) spec
    suite = get_suite("table2_train_space", n=args.sims,
                      num_flows=args.flows)
    holdout = random_spec(args.sims, num_flows=args.flows, synthetic=False)
    batches, report = build_dataset(suite, cfg,
                                    f"{args.workdir}/train_data", log=print)

    print("== training m4 (dense supervision: FCT + size + queue) ==")
    tc = TrainConfig(epochs=args.epochs, lr=1e-3, schedule="const",
                     step_mode="per_sim", shuffle=False)
    state, hist = fit(batches, cfg, tc, device=args.device)

    print("== held-out evaluation ==")
    ev = evaluate_m4(state.params, cfg, [holdout],
                     cache_dir=f"{args.workdir}/sweep_cache",
                     device=args.device)
    e_fs, e_m4 = ev["flowsim_err_mean"], ev["m4_err_mean"]
    print(f"  flowSim err: mean={e_fs:.3f}")
    print(f"  m4      err: mean={e_m4:.3f}")
    print(f"  m4 reduces mean error by {1 - e_m4 / e_fs:.0%} (paper: 45.3%)")
    return ev


if __name__ == "__main__":
    main()
