"""Resumable, bucketed training of m4 (§3.3, §5.1) on one device.

The port of `repro.train.loop`:

- **Buckets.** The corpus is shape-bucketed (`train.batching`); each
  bucket's tensors move to the device once.
- **Two step semantics.** `step_mode="per_sim"` (default) applies one
  AdamW update per sim, in bucket order: the seed trainer's schedule.
  `step_mode="batch"` averages the losses of the bucket's sims into one
  update. (The JAX package's pmap of the batch step across devices is not
  ported.)
- **The differentiated step** runs the plain versions of the GRU pair and
  the GNN (`core.training`), never the kernels, which define no backward.
- **Resume.** `TrainState` (params + AdamW moments + step + RNG key) is
  checkpointed through `runtime.checkpoint` every `ckpt_every` epochs in
  the JAX package's format; a run re-invoked with the same `TrainConfig`
  restores the last committed epoch (rolling back past a corrupt one) and
  walks the same buckets, reproducing the uninterrupted run's parameters.
- **Schedules & history.** Warmup+cosine LR over the true update count,
  and one history entry per epoch with the JAX package's keys
  (`compile_s` and `compiles` are 0: the training step runs eagerly).
- **Telemetry.** A `train.epoch` span per epoch (when tracing is on),
  and `train.steps` / `train.step_wall_s` in the obs registry, whose
  snapshot `train_suite` reports under `obs`. (`train.compiles` and
  `train.compile_wall_s` stay absent: the training step runs eagerly, and
  only the inference loops have compiled programs to count.)
- **Evaluation.** `evaluate_m4` reports the per-flow slowdown error of
  m4 and of a baseline (flowSim) against the packet ground truth (§5.2),
  over scenario specs, with the ground truth cached by the sweep runner.
- **One call.** `train_suite` runs suite -> cached dataset -> `fit` ->
  held-out eval, as `python -m repro_torch.train` does.

Parameters, moments and batches live on the device the caller names,
"cuda" by default as for the backends; there is no fallback to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.events import EventBatch
from ..core.model import M4Config, init_m4
from ..core.training import event_scan_losses
from ..kernels import dispatch
from ..obs.registry import get_registry
from ..obs.trace import get_tracer
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..optim.schedules import linear_warmup_cosine
from ..runtime import checkpoint as ckpt
from ..runtime.guards import check_finite
from ..sim.backends import resolve_device
from ..weights import tree_digest, tree_map
from . import prng
from .batching import make_buckets


def prng_key(seed: int) -> np.ndarray:
    """The JAX package's `jax.random.PRNGKey(seed)` for a seed in
    [0, 2**32): uint32 [0, seed]. It seeds nothing in the port (the port's
    weights come from `init_m4`'s torch generator); it is kept so that a
    `TrainState` tree matches the JAX package's leaf for leaf, and it
    seeds the bucket order of `shuffle` as in the JAX package."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return np.array([0, seed], dtype=np.uint32)


@dataclass
class TrainState:
    """Everything a resumed run needs: parameters, AdamW moments (with
    the int32 update counter inside) and the run's root key `rng`."""
    params: dict
    opt: dict
    rng: np.ndarray

    @property
    def step(self) -> int:
        """Optimizer updates applied so far."""
        return int(self.opt["step"])

    def weights_hash(self) -> str:
        """`tree_digest` of the parameters: the identity the m4 backend's
        fingerprint embeds, and the JAX package's `tree_digest` of the
        same weights."""
        return tree_digest(self.params)

    def tree(self) -> dict:
        return {"params": self.params, "opt": self.opt, "rng": self.rng}


def init_state(m4cfg: M4Config, seed: int = 0,
               device="cuda") -> TrainState:
    device = resolve_device(device)
    params = init_m4(seed, m4cfg, device=device)
    return TrainState(params=params, opt=adamw_init(params),
                      rng=prng_key(seed))


def load_state(ckpt_dir: Optional[str], m4cfg: M4Config, seed: int = 0,
               device="cuda") -> Tuple[Optional[TrainState], Optional[int]]:
    """Restore the latest committed `TrainState` from `ckpt_dir` onto
    `device`. Returns (state, completed_epochs), or (None, None) when no
    committed checkpoint exists. A corrupt latest checkpoint falls back to
    the newest older one that loads; raises only when none is readable."""
    if not ckpt_dir or ckpt.latest_step(ckpt_dir) is None:
        return None, None
    tree, step, _ = ckpt.restore_latest_loadable(
        ckpt_dir, init_state(m4cfg, seed, device).tree())
    return TrainState(**tree), step


@dataclass(frozen=True)
class TrainConfig:
    """Declarative knobs of one training run (safe to log verbatim)."""
    epochs: int = 10
    lr: float = 3e-4
    warmup_frac: float = 0.05     # fraction of total updates spent warming
    min_lr_frac: float = 0.05     # cosine floor as a fraction of lr
    schedule: str = "warmcos"     # "warmcos" | "const"
    bucket_size: int = 8          # sims padded+stacked per bucket
    step_mode: str = "per_sim"    # "per_sim" (seed-faithful SGD) | "batch"
    w_sldn: float = 1.0           # per-head loss weights (0 = ablate)
    w_size: float = 1.0
    w_queue: float = 1.0
    clip_norm: float = 1.0
    weight_decay: float = 1e-4
    seed: int = 0
    shuffle: bool = True          # bucket order per epoch (seeded, stable)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1           # epochs between checkpoints
    keep_last: int = 3


def _make_schedule(tc: TrainConfig, total_updates: int):
    if tc.schedule == "const":
        return lambda step: torch.tensor(tc.lr, dtype=torch.float32,
                                         device=step.device)
    if tc.schedule == "warmcos":
        warm = max(1, int(tc.warmup_frac * total_updates))
        fn = linear_warmup_cosine(tc.lr, warm, max(total_updates, 2),
                                  min_frac=tc.min_lr_frac)
        # opt["step"] counts *applied* updates, so the i-th update sees
        # step == i; evaluate at i+1 so warmup starts at lr/warm instead
        # of a wasted lr=0 first update
        return lambda step: fn(step + 1)
    raise ValueError(f"unknown schedule {tc.schedule!r} "
                     "(want 'warmcos' or 'const')")


def _sim_loss(params, m4cfg: M4Config, tc: TrainConfig, b):
    """Weighted three-head loss of one sim, or per sim of a batch (the
    per-head means as the second value)."""
    l = event_scan_losses(params, m4cfg, b)
    tot = tc.w_sldn * l["sldn"] + tc.w_size * l["size"] \
        + tc.w_queue * l["queue"]
    return tot, l


def _value_and_grad(loss_fn, params):
    """(loss, parts, grads) of loss_fn(params) -> (loss, parts)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        tot, parts = loss_fn(leaves)
        tot.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    return tot.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_bucket_step(m4cfg: M4Config, tc: TrainConfig, schedule) -> Callable:
    """The training step for one bucket: `step(params, opt, arrays) ->
    (params, opt, outs)` where `outs` is (updates, 6): [total, sldn, size,
    queue, lr, grad_norm] per optimizer update."""
    def update(params, opt, grads):
        with torch.no_grad():
            grads, gn = clip_by_global_norm(grads, tc.clip_norm)
            lr = schedule(opt["step"])
            params, opt = adamw_update(params, grads, opt, lr=lr,
                                       weight_decay=tc.weight_decay)
        return params, opt, lr, gn

    def pack(tot, parts, lr, gn):
        return torch.stack([tot, parts["sldn"], parts["size"],
                            parts["queue"], lr, gn])

    if tc.step_mode == "per_sim":
        def step(params, opt, bb):
            outs = []
            for i in range(bb["t"].shape[0]):
                b = {k: v[i] for k, v in bb.items()}
                tot, parts, grads = _value_and_grad(
                    lambda p: _sim_loss(p, m4cfg, tc, b), params)
                params, opt, lr, gn = update(params, opt, grads)
                outs.append(pack(tot, parts, lr, gn))
            return params, opt, torch.stack(outs)
        return step

    if tc.step_mode != "batch":
        raise ValueError(f"unknown step_mode {tc.step_mode!r} "
                         "(want 'per_sim' or 'batch')")

    def batch_loss(params, bb):
        """Mean over the bucket's sims."""
        tots, parts = _sim_loss(params, m4cfg, tc, bb)
        return tots.mean(), {k: v.mean() for k, v in parts.items()}

    def step(params, opt, bb):
        tot, parts, grads = _value_and_grad(
            lambda p: batch_loss(p, bb), params)
        params, opt, lr, gn = update(params, opt, grads)
        return params, opt, pack(tot, parts, lr, gn)[None]
    return step


def _history_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "history.json")


def _write_history(ckpt_dir: str, history: List[dict]):
    """Atomic (tmp + rename) like the checkpoint itself."""
    path = _history_path(ckpt_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(history, f, indent=1)
    os.replace(tmp, path)


def _read_history(ckpt_dir: str, epochs: int) -> List[dict]:
    """Best-effort: the checkpoint is the source of truth, so a missing
    or corrupt history file costs the loss log, never the resume."""
    try:
        with open(_history_path(ckpt_dir)) as f:
            return json.load(f)[:epochs]
    except (OSError, ValueError):
        return []


def fit(batches: Sequence[EventBatch], m4cfg: M4Config,
        tc: TrainConfig = TrainConfig(), *, state: Optional[TrainState] = None,
        device="cuda", log=print) -> Tuple[TrainState, List[dict]]:
    """Train m4 on a corpus of `EventBatch`es on `device`; returns (state,
    history).

    history is one dict per epoch: {epoch, loss, sldn, size, queue, lr,
    grad_norm, wall_s, compile_s, step_s, compiles}: `loss` is the
    sim-weighted epoch mean of the combined objective, the per-head
    entries its components, `step_s` the steps' wall time including the
    device->host read of their outputs.

    With `tc.ckpt_dir` set, the run checkpoints every `ckpt_every` epochs
    and AUTO-RESUMES from the newest committed checkpoint that loads (same
    bucket walk, the uninterrupted run's outcome). A finished run restores
    and returns immediately. `state` (on any device) warm-starts a run
    whose `ckpt_dir` holds no checkpoint.

    With `tc.shuffle`, each epoch's bucket order is the JAX package's:
    `permutation(fold_in(rng, epoch), buckets)` of the state's key, by
    the *absolute* epoch, so a resumed run replays it (`train.prng`, a
    numpy twin of jax's threefry draw).
    """
    batches = list(batches)
    if not batches:
        raise ValueError("empty training corpus")
    device = resolve_device(device)
    buckets = [b.to(device) for b in make_buckets(batches, tc.bucket_size)]
    updates_per_epoch = len(batches) if tc.step_mode == "per_sim" \
        else len(buckets)
    schedule = _make_schedule(tc, tc.epochs * updates_per_epoch)
    step_fn = make_bucket_step(m4cfg, tc, schedule)

    if state is None:
        state = init_state(m4cfg, tc.seed, device)
    params = tree_map(lambda t: t.to(device), state.params)
    opt = tree_map(lambda t: t.to(device), state.opt)
    rng = state.rng
    history: List[dict] = []
    start_epoch = 0
    if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
        try:
            tree, start_epoch, skipped = ckpt.restore_latest_loadable(
                tc.ckpt_dir, {"params": params, "opt": opt, "rng": rng})
        except FileNotFoundError as exc:
            # every committed checkpoint is unreadable: worth a loud
            # warning, but a fresh start beats failing the whole run
            log(f"[train] WARNING: {exc} — starting fresh")
            tree, start_epoch, skipped = None, 0, []
        if tree is not None:
            for bad_step, why in skipped:
                log(f"[train] skipping corrupt checkpoint "
                    f"step {bad_step}: {why}")
            params, opt, rng = tree["params"], tree["opt"], tree["rng"]
            history = _read_history(tc.ckpt_dir, start_epoch)
            log(f"[train] resumed from {tc.ckpt_dir} at epoch "
                f"{start_epoch} (step {int(opt['step'])})"
                + (f" — recovered past {len(skipped)} corrupt "
                   "checkpoint(s)" if skipped else ""))

    if start_epoch < tc.epochs:
        log(f"[train] {len(batches)} sims -> {len(buckets)} bucket(s) "
            f"{sorted({b.shape for b in buckets})}, {updates_per_epoch} "
            f"update(s)/epoch x {tc.epochs} epochs [{tc.step_mode}] on "
            f"{device}")

    reg = get_registry()
    tracer = get_tracer()
    for ep in range(start_epoch, tc.epochs):
        ep_span = tracer.span("train.epoch", attrs={"epoch": ep})
        t0 = time.perf_counter()
        order = np.arange(len(buckets), dtype=np.int64)
        if tc.shuffle:
            # by *absolute* epoch, so a resumed run replays the same walk
            order = prng.permutation(prng.fold_in(rng, ep), len(buckets))
        outs_all, weights = [], []
        step_s = 0.0
        for bi in order:
            b = buckets[int(bi)]
            ts = time.perf_counter()
            # the differentiated step runs the plain versions (see above)
            dispatch.count_dispatch(device, plain=True)
            params, opt, outs = step_fn(params, opt, b.arrays)
            outs = outs.cpu().numpy()    # waits for the device
            step_s += time.perf_counter() - ts
            check_finite(f"train step outs (epoch {ep})", outs)
            outs_all.append(outs)
            # per_sim: one row per sim; batch: one bucket-mean row
            weights.append(np.full(len(outs), b.size / len(outs),
                                   np.float64))
        reg.inc("train.steps", len(order))
        reg.observe("train.step_wall_s", step_s)
        outs = np.concatenate(outs_all)
        w = np.concatenate(weights)
        mean = (outs * w[:, None]).sum(0) / w.sum()
        entry = {"epoch": ep, "loss": float(mean[0]),
                 "sldn": float(mean[1]), "size": float(mean[2]),
                 "queue": float(mean[3]), "lr": float(outs[-1, 4]),
                 "grad_norm": float(mean[5]),
                 "wall_s": round(time.perf_counter() - t0, 3),
                 "compile_s": 0.0, "step_s": round(step_s, 3),
                 "compiles": 0}
        history.append(entry)
        log(f"[train] epoch {ep}: loss={entry['loss']:.4f} "
            f"(sldn={entry['sldn']:.4f} size={entry['size']:.4f} "
            f"queue={entry['queue']:.4f}) lr={entry['lr']:.2e} "
            f"{entry['wall_s']:.1f}s")
        ep_span.end(loss=entry["loss"], compiles=0, compile_s=0.0,
                    step_s=entry["step_s"])
        if tc.ckpt_dir and ((ep + 1) % tc.ckpt_every == 0
                            or ep + 1 == tc.epochs):
            ckpt.save(tc.ckpt_dir, ep + 1,
                      {"params": params, "opt": opt, "rng": rng},
                      keep_last=tc.keep_last)
            _write_history(tc.ckpt_dir, history)

    return TrainState(params=params, opt=opt, rng=rng), history


# ---------------------------------------------------------------- evaluation
def evaluate_m4(params, m4cfg: M4Config, specs: Sequence, *,
                cache_dir: Optional[str] = None, request_seed: int = 0,
                chunk_size: int = 8, baseline: str = "flowsim",
                device="cuda") -> dict:
    """Held-out eval through the port's registry: per-flow slowdown error
    of m4 vs the packet ground truth, against the `baseline` backend (the
    paper's headline metric, §5.2). The keys are the JAX package's.

    Ground truth and the baseline go through `SweepRunner`, so a
    `cache_dir` makes repeated evals (every resume) pay the packet DES
    once; m4 runs uncached through `run_chunked` on `device`, because its
    params change between calls."""
    from ..scenarios import SweepRunner
    from ..sim import get_backend
    specs = list(specs)
    base_kw = {"device": device} if baseline == "flowsim_fast" else {}
    gt_rep = SweepRunner(get_backend("packet"), cache_dir=cache_dir,
                         chunk_size=chunk_size).run(specs,
                                                    seed=request_seed)
    base_rep = SweepRunner(get_backend(baseline, **base_kw),
                           cache_dir=cache_dir,
                           chunk_size=chunk_size).run(specs,
                                                      seed=request_seed)
    m4 = get_backend("m4", params=params, cfg=m4cfg, device=device)
    m4_res = m4.run_chunked([s.to_request(seed=request_seed) for s in specs],
                            chunk_size)

    def err(res, gt):
        return float(np.nanmean(np.abs(res.slowdowns - gt) / gt))

    rows = []
    for spec, g, b, m in zip(specs, gt_rep.entries, base_rep.entries, m4_res):
        gt = g.result.slowdowns
        rows.append({"scenario": spec.label,
                     "m4_err": err(m, gt),
                     f"{baseline}_err": err(b.result, gt)})
    m4_err = float(np.mean([r["m4_err"] for r in rows]))
    base_err = float(np.mean([r[f"{baseline}_err"] for r in rows]))
    return {"m4_err_mean": m4_err, f"{baseline}_err_mean": base_err,
            "baseline": baseline, "m4_beats_baseline": m4_err < base_err,
            "rows": rows}


# ------------------------------------------------------------- one-call API
def train_suite(suite, m4cfg: M4Config, tc: TrainConfig = TrainConfig(), *,
                data_root: str, workers: int = 0,
                max_events: Optional[int] = None,
                eval_specs: Optional[Sequence] = None,
                eval_cache_dir: Optional[str] = None,
                device="cuda", log=print) -> Tuple[TrainState, dict]:
    """Suite -> cached dataset -> fit -> (optional) held-out eval, on
    `device`.

    The one-call pipeline of the CLI (`python -m repro_torch.train`).
    Returns (TrainState, report) where `report` has the JAX package's
    keys, `obs` (the process registry's snapshot) among them, but one:
    `train.compiles` (the training step runs eagerly: nothing to count)."""
    from .data import build_dataset
    device = resolve_device(device)
    t0 = time.perf_counter()
    specs = list(suite)
    batches, data_report = build_dataset(specs, m4cfg, data_root,
                                         max_events=max_events,
                                         workers=workers, log=log)
    state, history = fit(batches, m4cfg, tc, device=device, log=log)
    report = {
        "suite": getattr(suite, "name", "corpus"),
        "num_sims": len(specs),
        "model": dataclasses.asdict(m4cfg),
        "train_config": dataclasses.asdict(tc),
        "dataset": {"key": data_report.corpus_key,
                    "hits": data_report.hits, "misses": data_report.misses,
                    "root": data_root},
        "train": {"epochs": history, "updates": state.step,
                  "compile_s": round(sum(e.get("compile_s", 0.0)
                                         for e in history), 3),
                  "step_s": round(sum(e.get("step_s", 0.0)
                                      for e in history), 3)},
        "weights_hash": state.weights_hash(),
    }
    if eval_specs:
        report["eval"] = evaluate_m4(state.params, m4cfg, eval_specs,
                                     cache_dir=eval_cache_dir,
                                     device=device)
        e = report["eval"]
        log(f"[train] held-out eval: m4 err {e['m4_err_mean']:.3f} vs "
            f"{e['baseline']} {e[e['baseline'] + '_err_mean']:.3f} "
            f"({'beats' if e['m4_beats_baseline'] else 'LOSES TO'} baseline)")
    report["wall_s"] = round(time.perf_counter() - t0, 2)
    # the process obs snapshot (train.* + any sweep/eval counters) rides
    # along in train_log.json, so `python -m repro_torch.obs --merge
    # results/train_log.json` reads it
    report["obs"] = get_registry().snapshot()
    return state, report


def write_train_log(report: dict, path: str = "results/train_log.json"):
    """Persist the `train_suite` report as JSON (the JAX package's
    `write_train_log`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return path
