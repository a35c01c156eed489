"""End-to-end LM training on the PyTorch port: ~100M-parameter
decoder, a few hundred steps, checkpoints + auto-resume + straggler
tracking, through `repro_torch.launch.train` (the twin of
examples/train_lm.py). Runs on the card unless given `--device cpu`.

  PYTHONPATH=src python examples/train_lm_torch.py            # ~100M, 300 steps
  PYTHONPATH=src python examples/train_lm_torch.py --ci       # small + fast
  PYTHONPATH=src python examples/train_lm_torch.py --ci --device cpu
"""
import argparse

import torch

from repro_torch.launch.train import train
from repro_torch.models.arch import ArchCfg


def cfg_100m():
    return ArchCfg(name="repro-100m", family="dense", num_layers=10,
                   d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
                   d_ff=2560, vocab=16384, act="silu", dtype=torch.float32)


def cfg_ci():
    return ArchCfg(name="repro-ci", family="dense", num_layers=4,
                   d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                   d_ff=512, vocab=2048, act="silu", dtype=torch.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ci", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="results/lm_ckpt_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfg_ci() if args.ci else cfg_100m()
    steps = args.steps or (60 if args.ci else 300)
    print(f"[train_lm] {cfg.name}: {cfg.param_count()/1e6:.0f}M params, "
          f"{steps} steps")
    _, losses = train(
        cfg, steps=steps,
        global_batch=4 if args.ci else 8,
        seq_len=64 if args.ci else 256,
        lr=1e-3, ckpt_dir=args.ckpt_dir, ckpt_every=max(steps // 5, 10),
        resume="auto", device=args.device)
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({(1 - losses[-1]/losses[0]):.0%} reduction)")
    assert losses[-1] < losses[0], "training must reduce loss"
    return losses


if __name__ == "__main__":
    main()
