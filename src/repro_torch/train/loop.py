"""Resumable, bucketed training of m4 (§3.3, §5.1).

The port of `repro.train.loop`:

- **Bucketed compilation.** The corpus is shape-bucketed
  (`train.batching`); each bucket's tensors move to the device once, and
  each bucket shape trains through ONE compiled program
  (`core.compiled.StepCache`): on a card one update (forward, backward,
  clipping and AdamW in place) is captured as a CUDA graph and replayed;
  on the CPU the same program runs eagerly. `TRACE_COUNTS` counts the
  programs under the JAX package's key names, where JAX counts its
  compiles: once per bucket-array shape per `fit` call.
- **Two step semantics.** `step_mode="per_sim"` (default) applies one
  AdamW update per sim, in bucket order: the seed trainer's schedule,
  one graph of one sim's update replayed once per sim of the bucket (a
  counter on the device picks the sim). `step_mode="batch"` averages the
  losses of the bucket's sims into one update; with more than one device
  in `core.sharding.local_devices` (and at least one sim per device) the
  bucket is sharded across them, JAX's pmap step: per-shard weighted
  sums, summed on the first device, one update, counted as
  "train_step_sharded".
- **The differentiated step** runs the plain versions of the GRU pair and
  the GNN (`core.training`), never the kernels, which define no backward.
- **Resume.** `TrainState` (params + AdamW moments + step + RNG key) is
  checkpointed through `runtime.checkpoint` every `ckpt_every` epochs in
  the JAX package's format; a run re-invoked with the same `TrainConfig`
  restores the last committed epoch (rolling back past a corrupt one) and
  walks the same buckets, reproducing the uninterrupted run's parameters.
- **Schedules & history.** Warmup+cosine LR over the true update count,
  and one history entry per epoch with the JAX package's keys: `wall_s`
  splits into `compile_s` (the step calls that built a program, the
  warm-up, capture and instantiation of its graph included) and `step_s`
  (the replays), and `compiles` counts the programs the epoch built; an
  optional held-out eval callback (`eval_fn`, every `eval_every`
  epochs).
- **Telemetry.** A `train.epoch` span per epoch (when tracing is on),
  and `train.steps`, `train.step_wall_s` and, in an epoch that built
  programs, `train.compiles` / `train.compile_wall_s` in the obs
  registry, whose snapshot `train_suite` reports under `obs`. The epochs
  run under `no_retrace` with a budget of two programs per bucket shape.
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
from collections import Counter
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import compiled, sharding
from ..core.events import EventBatch
from ..core.model import M4Config, init_m4
from ..core.training import adamw_step, event_scan_losses
from ..kernels import dispatch
from ..obs.registry import get_registry
from ..obs.trace import get_tracer
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..optim.schedules import linear_warmup_cosine
from ..runtime import checkpoint as ckpt
from ..runtime.guards import check_finite, no_retrace
from ..sim.backends import resolve_device
from ..weights import tree_digest, tree_leaves, tree_map
from . import prng
from .batching import make_buckets

# Programs of the training step, by entry point, under the JAX package's
# key names ("train_step", "train_step_legacy"): one count for each new
# compiled program (`core.compiled.StepCache`), where JAX counts a
# compile of its jitted step.
TRACE_COUNTS = Counter()


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
        # a fill on the device: a host tensor would be a copy that a
        # graph capture refuses
        return lambda step: torch.full_like(step, tc.lr,
                                            dtype=torch.float32)
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


def array_key(arrays: dict) -> tuple:
    """What JAX's jit keys a step on, of its arrays: names, shapes and
    dtypes."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in arrays.items())


def step_program(update, params, opt, arrays, *, per_sim: bool,
                 width: int) -> compiled.StepProgram:
    """The program of one step shape. `update(params, opt, b) -> (params,
    opt, row)` is one functional update (`row` a (width,) tensor);
    `per_sim` walks the arrays' leading sim axis one update per sim, a
    counter on the device picking the sim, else one update takes all of
    `arrays`. The program owns copies of the weights, the moments and
    the arrays; its body writes the new weights and moments over them and
    the update's row into its row of `outs`. A call returns (params, opt,
    outs) as new tensors."""
    leaves = lambda t: [x for _, x in tree_leaves(t)]  # noqa: E731
    p_buf = tree_map(torch.empty_like, params)
    o_buf = tree_map(torch.empty_like, opt)
    a_buf = {k: torch.empty_like(v) for k, v in arrays.items()}
    dev = arrays["t"].device
    replays = arrays["t"].shape[0] if per_sim else 1
    outs = torch.zeros(replays, width, dtype=torch.float32, device=dev)
    sim = torch.zeros(1, dtype=torch.int64, device=dev)
    state = leaves(p_buf) + leaves(o_buf)

    def load(params, opt, arrays):
        with torch.no_grad():
            for dst, src in zip(state, leaves(params) + leaves(opt)):
                dst.copy_(src)
            for k, v in arrays.items():
                a_buf[k].copy_(v)
            sim.zero_()

    def body():
        b = {k: v.index_select(0, sim)[0] for k, v in a_buf.items()} \
            if per_sim else a_buf
        new_p, new_o, row = update(p_buf, o_buf, b)
        with torch.no_grad():
            for dst, src in zip(state, leaves(new_p) + leaves(new_o)):
                dst.copy_(src)
            outs.index_copy_(0, sim, row[None])
            sim.add_(1)

    def result():
        clone = lambda t: t.detach().clone()  # noqa: E731
        return tree_map(clone, p_buf), tree_map(clone, o_buf), outs.clone()

    return compiled.StepProgram(
        load=load, body=body, result=result, replays=replays,
        buffers=state + list(a_buf.values()) + [outs, sim])


def make_bucket_step(m4cfg: M4Config, tc: TrainConfig, schedule) -> Callable:
    """The compiled training step for one bucket: `step(params, opt,
    arrays) -> (params, opt, outs)` where `outs` is (updates, 6): [total,
    sldn, size, queue, lr, grad_norm] per optimizer update. Its programs
    are cached by bucket shape in a `core.compiled.StepCache` of its own
    (JAX's jit cache of the step it returns), so distinct padded shapes,
    not distinct sims, cost programs, and the programs go with the step."""
    def update_of(loss_fn):
        def update(params, opt, b):
            lr = schedule(opt["step"])
            params, opt, tot, parts, gn = adamw_step(
                lambda p: loss_fn(p, b), params, opt, lr=lr,
                clip_norm=tc.clip_norm, weight_decay=tc.weight_decay)
            return params, opt, torch.stack([
                tot, parts["sldn"], parts["size"], parts["queue"], lr, gn])
        return update

    if tc.step_mode == "per_sim":
        update = update_of(lambda p, b: _sim_loss(p, m4cfg, tc, b))
    elif tc.step_mode == "batch":
        def batch_loss(params, bb):
            """Mean over the bucket's sims."""
            tots, parts = _sim_loss(params, m4cfg, tc, bb)
            return tots.mean(), {k: v.mean() for k, v in parts.items()}
        update = update_of(batch_loss)
    else:
        raise ValueError(f"unknown step_mode {tc.step_mode!r} "
                         "(want 'per_sim' or 'batch')")
    per_sim = tc.step_mode == "per_sim"
    cache = compiled.StepCache(TRACE_COUNTS, "train_step")

    def build(params, opt, bb):
        return step_program(update, params, opt, bb, per_sim=per_sim,
                            width=6)

    def single_device_step(params, opt, bb):
        return cache.run(array_key(bb), bb["t"].device, build,
                         params, opt, bb)
    if per_sim:
        return single_device_step
    sharded_step = _sharded_batch_step(m4cfg, tc, schedule)

    def step(params, opt, bb):
        devices = sharding.local_devices(bb["t"].device)
        # a tiny tail bucket (fewer sims than devices): one device
        if len(devices) == 1 or bb["t"].shape[0] < len(devices):
            return single_device_step(params, opt, bb)
        return sharded_step(params, opt, bb, devices)
    return step


def _sharded_batch_step(m4cfg: M4Config, tc: TrainConfig, schedule):
    """The batch step across devices, JAX's pmap step
    (`repro.train.loop.make_bucket_step`, `partial_pmap`): the bucket's
    sim axis sharded by `sharding.shard_leaves`, the pad replicas weighted
    0. Each shard's program computes, on its device, weighted sums of the
    loss, the three head losses and their gradients; the update program
    on the first device sums them across shards (the psum), divides by
    max(sum of weights, 1e-9) and applies one AdamW update, whose weights
    and moments are the single replica returned (`out_axes=None`).

    Its programs (one per shard shape and device, shared by the shards on
    one device in turn, plus the update's) are cached as the step's own;
    a call that builds any of them counts one "train_step_sharded", as
    JAX counts one pmap trace."""
    cache = compiled.StepCache(Counter(), "train_step_sharded")

    def local_sums(params, bb, w):
        tots, parts = _sim_loss(params, m4cfg, tc, bb)
        return torch.stack([(tots * w).sum(), (parts["sldn"] * w).sum(),
                            (parts["size"] * w).sum(),
                            (parts["queue"] * w).sum(), w.sum()])

    def build_update(params, opt, grads, sums):
        return _update_program(tc, schedule, params, opt, len(grads))

    def step(params, opt, bb, devices):
        dev = bb["t"].device
        B, D = bb["t"].shape[0], len(devices)
        w = torch.ones(B, dtype=torch.float32, device=dev)
        w = torch.cat([w, torch.zeros(-(-B // D) * D - B,
                                      dtype=torch.float32, device=dev)])
        bbs, ws = sharding.shard_leaves([bb, w], D)
        key = array_key(bbs)
        before = sum(cache.counts.values())
        grads, sums = [], []
        for i, shard_dev in enumerate(devices):
            shard = {k: v[i].to(shard_dev) for k, v in bbs.items()}
            g, s = cache.run(("shard",) + key, shard_dev,
                             lambda *args: _shard_program(local_sums, *args),
                             params, shard, ws[i].to(shard_dev))
            grads.append(g)
            sums.append(s)
        out = cache.run(("update", D), dev, build_update, params, opt,
                        grads, sums)
        if sum(cache.counts.values()) != before:
            TRACE_COUNTS["train_step_sharded"] += 1
        return out
    return step


def _shard_program(local_sums, params, bb, w) -> compiled.StepProgram:
    """One shard's program of the sharded batch step, on the device of
    `bb`: its body takes `local_sums(params, bb, w) -> (5,)` (the weighted
    sums of the loss and its three heads, and the weights' sum) and its
    gradients in the weights, into buffers the program owns. A call
    returns (gradients, sums) as new tensors on that device."""
    dev = bb["t"].device
    leaves = lambda t: [x for _, x in tree_leaves(t)]  # noqa: E731
    p_buf = tree_map(lambda t: torch.empty_like(t, device=dev), params)
    g_buf = tree_map(torch.empty_like, p_buf)
    a_buf = {k: torch.empty_like(v) for k, v in bb.items()}
    w_buf = torch.empty_like(w)
    s_buf = torch.zeros(5, dtype=torch.float32, device=dev)

    def load(params, bb, w):
        with torch.no_grad():
            for dst, src in zip(leaves(p_buf), leaves(params)):
                dst.copy_(src)
            for k, v in bb.items():
                a_buf[k].copy_(v)
            w_buf.copy_(w)

    def body():
        ps = tree_map(lambda p: p.detach().requires_grad_(), p_buf)
        with torch.enable_grad():
            sums = local_sums(ps, a_buf, w_buf)
            sums[0].backward()
        with torch.no_grad():
            for dst, p in zip(leaves(g_buf), leaves(ps)):
                if p.grad is None:
                    dst.zero_()
                else:
                    dst.copy_(p.grad)
            s_buf.copy_(sums.detach())

    def result():
        return tree_map(torch.clone, g_buf), s_buf.clone()

    return compiled.StepProgram(
        load=load, body=body, result=result, replays=1,
        buffers=leaves(p_buf) + leaves(g_buf) + list(a_buf.values())
        + [w_buf, s_buf])


def _update_program(tc: TrainConfig, schedule, params, opt,
                    shards: int) -> compiled.StepProgram:
    """The update program of the sharded batch step, on the weights'
    device: its body sums the shards' gradients and loss sums (the psum),
    divides them by max(sum of weights, 1e-9), clips and applies one
    AdamW update in place. A call takes (params, opt, the shards'
    gradients, their sums) and returns (params, opt, outs) as new tensors,
    outs (1, 6): [total, sldn, size, queue, lr, grad_norm]."""
    leaves = lambda t: [x for _, x in tree_leaves(t)]  # noqa: E731
    p_buf = tree_map(torch.empty_like, params)
    o_buf = tree_map(torch.empty_like, opt)
    g_buf = tree_map(lambda t: t.new_empty((shards,) + t.shape), params)
    s_buf = torch.zeros(shards, 5, dtype=torch.float32,
                        device=opt["step"].device)
    outs = torch.zeros(1, 6, dtype=torch.float32, device=opt["step"].device)
    state = leaves(p_buf) + leaves(o_buf)

    def load(params, opt, grads, sums):
        with torch.no_grad():
            for dst, src in zip(state, leaves(params) + leaves(opt)):
                dst.copy_(src)
            for i, (g, s) in enumerate(zip(grads, sums)):
                for dst, src in zip(leaves(g_buf), leaves(g)):
                    dst[i].copy_(src)
                s_buf[i].copy_(s)

    def body():
        with torch.no_grad():
            total = s_buf.sum(0)
            wsum = torch.clamp_min(total[4], 1e-9)
            grads = tree_map(lambda g: g.sum(0) / wsum, g_buf)
            grads, gn = clip_by_global_norm(grads, tc.clip_norm)
            lr = schedule(o_buf["step"])
            new_p, new_o = adamw_update(p_buf, grads, o_buf, lr=lr,
                                        weight_decay=tc.weight_decay)
            for dst, src in zip(state, leaves(new_p) + leaves(new_o)):
                dst.copy_(src)
            outs[0].copy_(torch.cat([total[:4] / wsum, lr.reshape(1),
                                     gn.reshape(1)]))

    def result():
        clone = lambda t: t.detach().clone()  # noqa: E731
        return tree_map(clone, p_buf), tree_map(clone, o_buf), outs.clone()

    return compiled.StepProgram(
        load=load, body=body, result=result, replays=1,
        buffers=state + leaves(g_buf) + [s_buf, outs])


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
        device="cuda", log=print, eval_fn: Optional[Callable] = None,
        eval_every: int = 0) -> Tuple[TrainState, List[dict]]:
    """Train m4 on a corpus of `EventBatch`es on `device`; returns (state,
    history).

    history is one dict per epoch: {epoch, loss, sldn, size, queue, lr,
    grad_norm, wall_s, compile_s, step_s, compiles[, eval]}: `loss` is the
    sim-weighted epoch mean of the combined objective, the per-head
    entries its components. `wall_s` splits into `compile_s` (bucket
    steps that built a program: cold shapes, the warm-up, capture and
    instantiation of the graph on a card included) and `step_s` (steady
    steps); both include the device->host read of the step's outputs. The
    same split streams into the obs registry (`train.compile_wall_s` /
    `train.step_wall_s`). `eval_fn(params)`, with `eval_every` > 0, runs
    after every `eval_every`-th epoch and the last, into `entry["eval"]`.

    With `tc.ckpt_dir` set, the run checkpoints every `ckpt_every` epochs
    and AUTO-RESUMES from the newest committed checkpoint that loads (same
    bucket walk, the uninterrupted run's outcome). A finished run restores
    and returns immediately. `state` (on any device) warm-starts a run
    whose `ckpt_dir` holds no checkpoint. The returned state's tensors
    are the run's own: no later call writes them.

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

    warm_start = state is not None
    if state is None:
        state = init_state(m4cfg, tc.seed, device)
    params = tree_map(lambda t: t.to(device), state.params)
    opt = tree_map(lambda t: t.to(device), state.opt)
    rng = state.rng
    history: List[dict] = []
    start_epoch = 0
    if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
        if warm_start:
            log(f"[train] NOTE: ckpt_dir {tc.ckpt_dir} has a committed "
                "checkpoint — it takes precedence over the passed `state` "
                "(use a fresh ckpt_dir to warm-start from `state`)")
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

    shapes = sorted({b.shape for b in buckets})
    if start_epoch < tc.epochs:
        log(f"[train] {len(batches)} sims -> {len(buckets)} bucket(s) "
            f"{shapes}, {updates_per_epoch} update(s)/epoch x "
            f"{tc.epochs} epochs [{tc.step_mode}] on {device}")

    # the program budget of the whole run: JAX's, one per bucket shape per
    # step path (its tiny tail buckets can take a second jit). eval_fn
    # builds in the simulator families, which this guard leaves out.
    reg = get_registry()
    tracer = get_tracer()
    with no_retrace(allowed=2 * len(shapes),
                    counters={"train.loop": TRACE_COUNTS}, label="fit"):
        for ep in range(start_epoch, tc.epochs):
            ep_span = tracer.span("train.epoch", attrs={"epoch": ep})
            t0 = time.perf_counter()
            order = np.arange(len(buckets), dtype=np.int64)
            if tc.shuffle:
                # by *absolute* epoch, so a resumed run replays the walk
                order = prng.permutation(prng.fold_in(rng, ep), len(buckets))
            outs_all, weights = [], []
            compile_s = step_s = 0.0
            ep_compiles = 0
            for bi in order:
                b = buckets[int(bi)]
                c0 = sum(TRACE_COUNTS.values())
                ts = time.perf_counter()
                # the differentiated step runs the plain versions
                dispatch.count_dispatch(device, plain=True)
                params, opt, outs = step_fn(params, opt, b.arrays)
                outs = outs.cpu().numpy()    # waits for the device
                dt = time.perf_counter() - ts
                new_programs = sum(TRACE_COUNTS.values()) - c0
                if new_programs:
                    compile_s += dt
                    ep_compiles += new_programs
                else:
                    step_s += dt
                check_finite(f"train step outs (epoch {ep})", outs)
                outs_all.append(outs)
                # per_sim: one row per sim; batch: one bucket-mean row
                weights.append(np.full(len(outs), b.size / len(outs),
                                       np.float64))
            reg.inc("train.steps", len(order))
            if ep_compiles:
                reg.inc("train.compiles", ep_compiles)
                reg.observe("train.compile_wall_s", compile_s)
            reg.observe("train.step_wall_s", step_s)
            outs = np.concatenate(outs_all)
            w = np.concatenate(weights)
            mean = (outs * w[:, None]).sum(0) / w.sum()
            entry = {"epoch": ep, "loss": float(mean[0]),
                     "sldn": float(mean[1]), "size": float(mean[2]),
                     "queue": float(mean[3]), "lr": float(outs[-1, 4]),
                     "grad_norm": float(mean[5]),
                     "wall_s": round(time.perf_counter() - t0, 3),
                     "compile_s": round(compile_s, 3),
                     "step_s": round(step_s, 3),
                     "compiles": ep_compiles}
            if eval_fn is not None and eval_every and \
                    ((ep + 1) % eval_every == 0 or ep + 1 == tc.epochs):
                entry["eval"] = eval_fn(params)
            history.append(entry)
            log(f"[train] epoch {ep}: loss={entry['loss']:.4f} "
                f"(sldn={entry['sldn']:.4f} size={entry['size']:.4f} "
                f"queue={entry['queue']:.4f}) lr={entry['lr']:.2e} "
                f"{entry['wall_s']:.1f}s"
                + (f" (compile {entry['compile_s']:.1f}s)"
                   if ep_compiles else ""))
            ep_span.end(loss=entry["loss"], compiles=ep_compiles,
                        compile_s=entry["compile_s"],
                        step_s=entry["step_s"])
            if tc.ckpt_dir and ((ep + 1) % tc.ckpt_every == 0
                                or ep + 1 == tc.epochs):
                ckpt.save(tc.ckpt_dir, ep + 1,
                          {"params": params, "opt": opt, "rng": rng},
                          keep_last=tc.keep_last)
                _write_history(tc.ckpt_dir, history)
                # test hook: a deterministic "kill" right after a
                # checkpoint commits; os._exit skips every cleanup path,
                # as a SIGKILL mid-run would
                if os.environ.get("REPRO_TRAIN_ABORT_AFTER_EPOCH") \
                        == str(ep + 1):
                    os._exit(17)

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
    keys: `train.compiles` the programs `fit` built, and `obs` the process
    registry's snapshot."""
    from .data import build_dataset
    device = resolve_device(device)
    t0 = time.perf_counter()
    specs = list(suite)
    batches, data_report = build_dataset(specs, m4cfg, data_root,
                                         max_events=max_events,
                                         workers=workers, log=log)
    c0 = sum(TRACE_COUNTS.values())
    state, history = fit(batches, m4cfg, tc, device=device, log=log)
    compiles = sum(TRACE_COUNTS.values()) - c0
    report = {
        "suite": getattr(suite, "name", "corpus"),
        "num_sims": len(specs),
        "model": dataclasses.asdict(m4cfg),
        "train_config": dataclasses.asdict(tc),
        "dataset": {"key": data_report.corpus_key,
                    "hits": data_report.hits, "misses": data_report.misses,
                    "root": data_root},
        "train": {"epochs": history, "compiles": compiles,
                  "updates": state.step,
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
