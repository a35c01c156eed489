"""LM training: config -> data -> train loop -> checkpoints, as
`repro.launch.train`.

Fault tolerance: auto-resume from the newest committed checkpoint,
step-indexed data (bit-exact restarts), straggler deadline tracking,
optional error-feedback gradient compression. Checkpoints hold
`(params, opt)` at the JAX package's paths and leaf names, so either
package resumes from the other's; both keep a leaf's saved dtype.

The step is eager PyTorch (autograd over the tree's leaves, the global-norm
clip, the compression, AdamW): JAX's `jax.jit` of it keeps no counters.
It runs where the parameters are; `train` and the CLI put them on the card
unless given `device="cpu"`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --resume auto --device cpu
"""
from __future__ import annotations

import argparse

import torch

from .. import configs
from ..data.tokens import TokenPipeline
from ..models import lm
from ..optim import (adamw_init, adamw_update, ef_compress_update,
                     linear_warmup_cosine)
from ..optim.adamw import global_norm, scale_by_norm
from ..runtime import checkpoint as ckpt
from ..runtime.resilience import StepDeadline, Timed
from ..weights import tree_leaves, tree_map, tree_map_with_path

WEIGHT_DECAY = 0.1
MAX_NORM = 1.0
# AdamW runs on a leaf this many elements at a time: elementwise, so the
# numbers are one call's. On the card a full-width leaf (zamba2's stacked
# in_proj, 1.44e9 elements) then needs no whole-leaf temporaries; on the
# CPU small chunks keep them in cache (2.8x faster than 2^26 elements)
CHUNK = {"cuda": 1 << 26, "cpu": 1 << 20}


def make_train_step(cfg, schedule, *, compress_frac=0.0):
    """step(params, opt, err, batch, step_i) -> (params, opt, err, loss,
    grad norm), JAX's pure step: new trees, nothing written into its
    arguments. `step.donated(state, batch, step_i)` takes `state =
    [params, opt, err]` and empties that list, so each old leaf and
    gradient is freed as soon as its new leaf exists (JAX's
    `donate_argnums`); the same numbers, and `train` steps that way."""
    def donated(state, batch, step_i):
        params, opt, err = state
        state.clear()
        skel = tree_map(lambda _: None, params)
        P = [x for _, x in tree_leaves(params)]
        M = [x for _, x in tree_leaves(opt["m"])]
        V = [x for _, x in tree_leaves(opt["v"])]
        E = [x for _, x in tree_leaves(err)]
        count = opt["step"]
        del params, opt, err

        loss, grads = loss_and_grads(cfg, _fill(skel, P), batch)
        G = [g for _, g in tree_leaves(grads)]
        del grads
        with torch.no_grad():
            gn = global_norm(G)
            lr = schedule(step_i)
            for i in range(len(P)):
                g = scale_by_norm(G[i], gn, MAX_NORM)
                G[i] = None
                if compress_frac > 0:
                    # error-feedback top-k: only the sparse component
                    # would cross the inter-pod link on a fleet; the
                    # residual stays local
                    g, E[i] = ef_compress_update(g, E[i], compress_frac)
                P[i], M[i], V[i] = _adamw_leaf(P[i], g, M[i], V[i], count,
                                               lr)
                del g
            new_count = count + 1
        return ([_fill(skel, P), {"m": _fill(skel, M), "v": _fill(skel, V),
                                  "step": new_count}, _fill(skel, E)],
                loss, gn)

    def step(params, opt, err, batch, step_i):
        (params, opt, err), loss, gn = donated([params, opt, err], batch,
                                               step_i)
        return params, opt, err, loss, gn

    step.donated = donated
    return step


def loss_and_grads(cfg, params, batch):
    """`lm.loss_fn` and its gradients with respect to every leaf of
    `params` (JAX's `value_and_grad`): (loss, the gradients' tree). Writes
    nothing into `params`."""
    leaves = [p.detach().requires_grad_() for _, p in tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = lm.loss_fn(_fill(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), _fill(params, grads)


def _fill(skel, leaves):
    """The tree of `skel`'s structure with `leaves` in flattening order."""
    at = dict(zip((path for path, _ in tree_leaves(skel)), leaves))
    return tree_map_with_path(lambda path, _: at[path], skel)


def _adamw_leaf(p, g, m, v, count, lr):
    """`adamw_update` of one leaf, CHUNK[device] elements at a time;
    returns (new p, new m, new v)."""
    def update(p, g, m, v):
        new_p, st = adamw_update(p, g, {"m": m, "v": v, "step": count},
                                 lr=lr, weight_decay=WEIGHT_DECAY)
        return new_p, st["m"], st["v"]

    n, chunk = p.numel(), CHUNK.get(p.device.type, CHUNK["cpu"])
    if n <= chunk:
        return update(p, g, m, v)
    flat = [x.reshape(-1) for x in (p, g, m, v)]
    out = None
    for a in range(0, n, chunk):
        part = update(*(x[a:a + chunk] for x in flat))
        if out is None:
            out = [torch.empty(n, dtype=x.dtype, device=x.device)
                   for x in part]
        for o, x in zip(out, part):
            o[a:a + chunk] = x
    return tuple(o.view(p.shape) for o in out)


def train(cfg, *, steps=100, global_batch=8, seq_len=128, lr=3e-4,
          ckpt_dir=None, ckpt_every=20, resume="no", seed=0,
          compress_frac=0.0, crash_at=None, log=print, device="cuda"):
    """crash_at: simulate a node failure after that many steps (testing).
    The weights are `lm.init_params` from a `torch.Generator` seeded with
    `seed` on `device`. Returns (params, losses)."""
    device = torch.device(device)
    params = lm.init_params(torch.Generator(device=device).manual_seed(seed),
                            cfg)
    opt = adamw_init(params)
    if compress_frac > 0:
        err = tree_map(torch.zeros_like, params)
    else:
        err = tree_map(lambda x: torch.zeros((0,), dtype=x.dtype,
                                             device=device), params)
    start = 0
    if ckpt_dir and resume == "auto" and ckpt.latest_step(ckpt_dir) is not None:
        (params, opt), start = ckpt.restore(ckpt_dir, (params, opt))
        log(f"[train] resumed from step {start}")

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq_len,
                         global_batch=global_batch, seed=seed)
    schedule = linear_warmup_cosine(lr, max(steps // 10, 1), steps)
    step_fn = make_train_step(cfg, schedule, compress_frac=compress_frac)
    deadline = StepDeadline()
    losses = []
    state = [params, opt, err]
    del params, opt, err
    for i in range(start, steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch(i).items()}
        with Timed() as t:
            state, loss, gn = step_fn.donated(
                state, batch, torch.full((), i, dtype=torch.int32,
                                         device=device))
            loss = float(loss)
        straggled = deadline.observe(t.dt)
        losses.append(loss)
        if i % 10 == 0 or straggled:
            log(f"[train] step {i}: loss={loss:.4f} gn={float(gn):.3f} "
                f"{t.dt*1e3:.0f}ms{' STRAGGLER' if straggled else ''}")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, i + 1, (state[0], state[1]))
        if crash_at is not None and i + 1 >= crash_at:
            log(f"[train] simulated failure at step {i + 1}")
            return state[0], losses
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, (state[0], state[1]))
    return state[0], losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", choices=["no", "auto"], default="no")
    ap.add_argument("--compress-frac", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.reduce_for_smoke(cfg)
    _, losses = train(cfg, steps=args.steps, global_batch=args.global_batch,
                      seq_len=args.seq_len, lr=args.lr, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, resume=args.resume,
                      compress_frac=args.compress_frac, device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
