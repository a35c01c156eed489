"""ASTRA-sim-style integration (paper §2.1) on the PyTorch port (the twin
of examples/simulate_collectives.py): estimate the communication time of
an LM training step by converting its collective schedule into network
flows and simulating them with flowSim and m4 (on the card unless given
`--device cpu`).

Pipeline: the port's dry-run JSON (collective bytes by kind, from the
DTensor redistributions of one traced step, `repro_torch.launch.dryrun`)
-> ring-schedule flows on a fat-tree hosting the data-parallel ranks ->
flow-level simulation -> per-collective completion time, vs. the
analytic alpha-beta lower bound. m4 is the benchmark's trained model
(trained_m4_torch.py): trained once into results/m4_ckpt_torch, or loaded
from `--ckpt-dir`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python examples/simulate_collectives_torch.py \
      --cell results/dryrun/gemma2-9b_train_4k_16x16.json --ranks 16
"""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from repro_torch.net import FatTree, Flow, NetConfig  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from trained_m4_torch import trained_m4  # noqa: E402

ALPHA_S = 2e-6             # per-step latency of the alpha-beta bound


def ring_flows(topo, ranks, bytes_per_rank, start=0.0):
    """One ring pass: rank i -> rank i+1, `bytes_per_rank` each."""
    hosts = np.linspace(0, topo.num_hosts - 1, ranks).astype(int)
    flows = []
    for i in range(ranks):
        src, dst = int(hosts[i]), int(hosts[(i + 1) % ranks])
        flows.append(Flow(fid=i, src=src, dst=dst,
                          size=max(int(bytes_per_rank), 1000),
                          t_arrival=start, path=topo.path(src, dst, i)))
    return flows


def collective_times(rec, ranks, params, m4cfg, device="cuda"):
    """Per collective kind of the dry-run record `rec`: (kind, bytes per
    device, alpha-beta s, flowSim s, m4 s), one ring pass of `ranks`
    ranks each."""
    topo = FatTree(num_racks=8, hosts_per_rack=4, num_spines=4,
                   link_gbps=100.0)  # ICI-class links
    config = NetConfig(cc="dctcp")
    flowsim = get_backend("flowsim")
    m4 = get_backend("m4", params=params, cfg=m4cfg, device=device)
    bw = topo.link_gbps * 1e9 / 8
    n = ranks
    rows = []
    for kind, nbytes in rec["collective_kinds"].items():
        # ring schedule: all-reduce moves 2(n-1)/n per rank, others (n-1)/n
        factor = 2.0 if kind == "all-reduce" else 1.0
        per_rank = factor * (n - 1) / n * nbytes
        steps = factor * (n - 1)
        chunk = nbytes / n
        # alpha-beta: steps * (alpha + chunk/bw)
        t_ab = steps * (ALPHA_S + chunk / bw)
        req = SimRequest(topo=topo, config=config,
                         flows=tuple(ring_flows(topo, n, per_rank)))
        rows.append((kind, nbytes, t_ab, np.nanmax(flowsim.run(req).fcts),
                     np.nanmax(m4.run(req).fcts)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None,
                    help="dry-run JSON (default: first train cell found)")
    ap.add_argument("--ranks", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="m4 checkpoint of either package (default: "
                         "results/m4_ckpt_torch, trained when missing)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cell = args.cell or sorted(
        glob.glob("results/dryrun/*train_4k_16x16.json"))[0]
    with open(cell) as f:
        rec = json.load(f)
    print(f"[collectives] {rec['arch']} {rec['shape']}: "
          f"{rec['collective_ops']} collective ops in the traced step")
    params, m4cfg = trained_m4(args.ckpt_dir, device=args.device)

    print("collective, bytes_dev, t_alpha_beta_us, t_flowsim_us, t_m4_us")
    rows = collective_times(rec, args.ranks, params, m4cfg, args.device)
    for kind, nbytes, t_ab, t_fs, t_m4 in rows:
        print(f"{kind}, {nbytes/1e6:.1f}MB, {t_ab*1e6:.0f}, "
              f"{t_fs*1e6:.0f}, {t_m4*1e6:.0f}")
    print("[collectives] flowSim models contention the alpha-beta bound "
          "misses; m4 adds learned queueing/CC effects on top.")
    return rows


if __name__ == "__main__":
    main()
