"""Closed-loop interactive application (paper §5.4) on the PyTorch port
(the twin of examples/closed_loop.py). m4 runs on the card unless given
`--device cpu`.

Client racks keep at most N requests inflight to storage racks; each
completion releases the next request. Throughput (completed flows/sec) is
compared across the packet-level ground truth, flowSim, and m4 — the
regime where flowSim's missing queueing/CC dynamics compound, because
errors feed back into arrival times. All three run through the same
`repro_torch.sim` closed-loop session protocol:

    run_closed_loop(get_backend("m4", params=p, cfg=c), topo, cfg, backlog, N)

m4 is the benchmark's trained model (trained_m4_torch.py): trained once
into results/m4_ckpt_torch, or loaded from `--ckpt-dir`.

  PYTHONPATH=src python examples/closed_loop_torch.py [--racks 8] [--limits 1 3 5]
  PYTHONPATH=src python examples/closed_loop_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from repro_torch.core.closedloop import make_backlog  # noqa: E402
from repro_torch.net import FatTree, NetConfig  # noqa: E402
from repro_torch.sim import get_backend, run_closed_loop  # noqa: E402
from trained_m4_torch import trained_m4  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--racks", type=int, default=8)
    ap.add_argument("--flows-per-rack", type=int, default=30)
    ap.add_argument("--limits", type=int, nargs="+", default=[1, 3, 5])
    ap.add_argument("--ckpt-dir", default=None,
                    help="m4 checkpoint of either package (default: "
                         "results/m4_ckpt_torch, trained when missing)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    topo = FatTree(num_racks=args.racks, hosts_per_rack=4, num_spines=2)
    config = NetConfig(cc="dctcp")
    params, m4cfg = trained_m4(args.ckpt_dir, device=args.device)
    backlog = make_backlog(topo, client_racks=max(args.racks // 4, 1),
                           flows_per_rack=args.flows_per_rack,
                           size_dist="WebServer", seed=7)

    backends = [get_backend("packet"), get_backend("flowsim"),
                get_backend("m4", params=params, cfg=m4cfg,
                            device=args.device)]

    print("N, thr_ns3(f/s), thr_flowsim, thr_m4, err_flowsim, err_m4")
    errs_fs, errs_m4, rows = [], [], []
    for N in args.limits:
        gt, fs, m4 = (run_closed_loop(b, topo, config, backlog, N)
                      for b in backends)
        e_fs = abs(fs.throughput - gt.throughput) / gt.throughput
        e_m4 = abs(m4.throughput - gt.throughput) / gt.throughput
        errs_fs.append(e_fs)
        errs_m4.append(e_m4)
        rows.append((N, gt.throughput, fs.throughput, m4.throughput))
        print(f"{N}, {gt.throughput:.0f}, {fs.throughput:.0f}, "
              f"{m4.throughput:.0f}, {e_fs:.1%}, {e_m4:.1%}")
    print(f"\nmean throughput error: flowSim {np.mean(errs_fs):.1%}, "
          f"m4 {np.mean(errs_m4):.1%} (paper: 28.1% -> 11.5%)")
    return rows


if __name__ == "__main__":
    main()
