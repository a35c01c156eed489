"""Dense-supervision training losses of m4 (§3.3).

The port of `repro.core.training`: a teacher-forced pass over the ground-
truth event sequence of each simulation. Per event: temporal GRU advance
-> query remaining size & queue length (dense losses) -> GNN spatial
update -> query FCT slowdown. Combined L1 loss over the three heads.

This module owns the math (`event_scan_losses`, `combined_loss`); the
training pipeline lives in `repro_torch.train`. The legacy direct API
stays: `make_train_step` (one sim's compiled AdamW step, counted in
`repro_torch.train.TRACE_COUNTS` as "train_step_legacy") and `train_m4`
(a wrapper over `fit` with the seed trainer's schedule).

The JAX `lax.scan` becomes a Python loop over the K events, and every
function takes a leading batch axis of sims (the bucket of the batch step
mode). The event loop runs only what depends on the carried state; what
depends on the data alone (the snapshot gathers, the arrival MLP) runs
once for all K events before it, and the three query heads once for all
K events after it. The loop differentiates through the plain versions of
the GRU pair and the GNN (`plain=True`), on any device, as JAX trains on
its jnp path: the kernels define no backward.

The arenas carry a dump row (index N / L) that absorbs the reads and
writes of padded snapshot slots, as in JAX. Padded slots write the dump
row's own value back, so every duplicate index of a write carries the
same value, and the losses and gradients do not depend on which
duplicate lands.
"""
from __future__ import annotations

import torch

from ..nn import mlp
from ..optim import adamw_update, clip_by_global_norm
from ..weights import tree_map
from .model import (M4Config, predict_queue, predict_size, predict_sldn,
                    spatial_update, temporal_update)

_INDEX_FIELDS = ("flow_links", "etype", "fid", "snap_f", "snap_l", "edge_l")


def _with_batch_axis(b: dict):
    """(b with a leading sim axis, whether the caller gave one)."""
    if b["t"].dim() == 2:
        return b, True
    return {k: v.unsqueeze(0) for k, v in b.items()}, False


def event_scan_losses(params, cfg: M4Config, b: dict) -> dict:
    """Teacher-forced pass over all K events of one sim, or of B sims
    stacked on a leading axis (`repro_torch.train.batching.stack_bucket`);
    `b` holds the `EventBatch` fields as tensors on one device. Returns
    the per-head mean L1 losses {"size", "queue", "sldn"}: scalars, or
    (B,) tensors for a batch."""
    b, batched = _with_batch_axis(b)
    b = {k: v.long() if k in _INDEX_FIELDS else v for k, v in b.items()}
    B, N = b["flow_feat"].shape[:2]
    L, K = b["link_feat"].shape[1], b["t"].shape[1]
    SF, P = cfg.snap_flows, cfg.max_path
    H = params["gru1"]["wh"].shape[0]
    dev = b["t"].device
    cfg_vec = b["cfg_vec"]                               # (B, C)
    per_event_cfg = cfg_vec[:, None]                     # (B, 1, C)

    # initial link states from bandwidth (paper: init from link bandwidth);
    # both arenas carry a dump row (index N / L) for masked-slot scatters
    l_in = torch.cat([b["link_feat"],
                      cfg_vec[:, None].expand(B, L, cfg_vec.shape[-1])], -1)
    link_h = torch.cat([torch.tanh(mlp(params["link_init"], l_in)),
                        torch.zeros(B, 1, H, dtype=torch.float32,
                                    device=dev)], 1)
    flow_h = torch.zeros(B, N + 1, H, dtype=torch.float32, device=dev)
    flow_last = torch.zeros(B, N + 1, dtype=torch.float32, device=dev)
    link_last = torch.zeros(B, L + 1, dtype=torch.float32, device=dev)

    # what depends on the data alone, for all K events at once
    sf, sl = b["snap_f"], b["snap_l"]                    # (B, K, SF / SL)
    sfm, slm = b["snap_f_mask"], b["snap_l_mask"]
    sf_safe = torch.where(sf >= 0, sf, N)                # dump row for pads
    sl_safe = torch.where(sl >= 0, sl, L)
    sf_g = torch.clamp(sf_safe, max=N - 1)               # clamped gathers
    sl_g = torch.clamp(sl_safe, max=L - 1)
    bk = torch.arange(B, dtype=torch.long, device=dev)[:, None, None]
    f_feat = b["flow_feat"][bk, sf_g]                    # (B, K, SF, 3)
    l_feat = b["link_feat"][bk, sl_g]                    # (B, K, SL, 1)
    # arrival: (re)initialize slot 0 (the event flow) from its features
    fin = torch.cat([b["flow_feat"][bk[..., 0], b["fid"]],
                     per_event_cfg.expand(B, K, cfg_vec.shape[-1])], -1)
    h_new = torch.tanh(mlp(params["flow_init"], fin))    # (B, K, H)
    is_arr = (b["etype"] == 0)[..., None]                # (B, K, 1)
    edge_f = torch.arange(SF, dtype=torch.long,
                          device=dev).repeat_interleave(P)
    bi = torch.arange(B, dtype=torch.long, device=dev)[:, None]

    f_tmp, l_tmp, f_spa = [], [], []
    for k in range(K):
        t = b["t"][:, k, None]                           # (B, 1)
        sfk, slk = sf_safe[:, k], sl_safe[:, k]
        f_old, l_old = flow_h[bi, sfk], link_h[bi, slk]  # (B, SF/SL, H)
        fl_old, ll_old = flow_last[bi, sfk], link_last[bi, slk]
        arr = is_arr[:, k]
        f_h = torch.cat([torch.where(arr, h_new[:, k], f_old[:, 0])[:, None],
                         f_old[:, 1:]], 1)
        dt_f = t - fl_old
        dt_f = torch.cat([torch.where(arr, 0.0, dt_f[:, :1]), dt_f[:, 1:]], 1)
        dt_l = t - ll_old

        f_h, l_h = temporal_update(params, cfg, f_h, l_old, dt_f, dt_l,
                                   f_feat[:, k], l_feat[:, k], cfg_vec,
                                   plain=True)
        f_h2, l_h2 = spatial_update(params, cfg, f_h, l_h, edge_f,
                                    b["edge_l"][:, k], b["edge_mask"][:, k],
                                    cfg_vec, plain=True)
        f_tmp.append(f_h)
        l_tmp.append(l_h)
        f_spa.append(f_h2)

        # write back (masked scatter)
        wf, wl = sfm[:, k, :, None], slm[:, k, :, None]
        flow_h = flow_h.index_put((bi, sfk), wf * f_h2 + (1 - wf) * f_old)
        link_h = link_h.index_put((bi, slk), wl * l_h2 + (1 - wl) * l_old)
        flow_last = flow_last.index_put(
            (bi, sfk), torch.where(sfm[:, k] > 0, t, fl_old))
        link_last = link_last.index_put(
            (bi, slk), torch.where(slm[:, k] > 0, t, ll_old))

    # the queries, for all K events at once: dense ones on the temporally
    # advanced states X~(t_i), the FCT slowdown on the post-GNN states
    rem_pred = predict_size(params, torch.stack(f_tmp, 1))      # (B, K, SF)
    rem_loss = (torch.abs(rem_pred - b["gt_remaining"])
                * b["rem_mask"]).sum(-1)
    rem_cnt = b["rem_mask"].sum(-1)
    q_pred = predict_queue(params, torch.stack(l_tmp, 1))
    q_loss = (torch.abs(q_pred - b["gt_queue"]) * b["queue_mask"]).sum(-1)
    q_cnt = b["queue_mask"].sum(-1)
    sldn_pred = predict_sldn(params, torch.stack(f_spa, 1),
                             f_feat[..., 1] * 8.0, per_event_cfg)
    sldn_tgt = b["gt_sldn"][bk, sf_g]
    if cfg.dense_sldn:
        sldn_loss = (torch.abs(sldn_pred - sldn_tgt) * sfm).sum(-1)
        sldn_cnt = sfm.sum(-1)
    else:
        is_dep = (b["etype"] == 1).float()
        sldn_loss = torch.abs(sldn_pred[..., 0] - sldn_tgt[..., 0]) * is_dep
        sldn_cnt = is_dep

    out = {"size": rem_loss.sum(1) / torch.clamp(rem_cnt.sum(1), min=1),
           "queue": q_loss.sum(1) / torch.clamp(q_cnt.sum(1), min=1),
           "sldn": sldn_loss.sum(1) / torch.clamp(sldn_cnt.sum(1), min=1)}
    return out if batched else {k: v[0] for k, v in out.items()}


def combined_loss(params, cfg: M4Config, b: dict, *, w_size=1.0,
                  w_queue=1.0, w_sldn=1.0):
    l = event_scan_losses(params, cfg, b)
    total = w_sldn * l["sldn"] + w_size * l["size"] + w_queue * l["queue"]
    return total, l


def adamw_step(loss_fn, params, opt, *, lr, clip_norm, weight_decay):
    """One AdamW update of `params` (moments and step in `opt`) down the
    gradient of `loss_fn(params) -> (loss, parts)`, clipped to global norm
    `clip_norm`; `lr` a float or a float32 scalar tensor. Returns (params,
    opt, loss, parts, grad norm before clipping), all new tensors."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        tot, parts = loss_fn(leaves)
        tot.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    with torch.no_grad():
        grads, gn = clip_by_global_norm(grads, clip_norm)
        params, opt = adamw_update(params, grads, opt, lr=lr,
                                   weight_decay=weight_decay)
    return params, opt, tot.detach(), \
        {k: v.detach() for k, v in parts.items()}, gn


def make_train_step(cfg: M4Config, *, lr=3e-4, ablate_size=False,
                    ablate_queue=False):
    """One sim's compiled AdamW step (legacy direct API), clip 1.0 and
    weight decay 1e-4: `train_step(params, opt, b) -> (params, opt, tot,
    parts, grad_norm)` with `b` one sim's `EventBatch` fields as tensors
    on one device.

    Prefer `repro_torch.train.fit`: the step builds one program per sim
    shape (a CUDA graph on a card), so a shape-diverse corpus costs one
    per sim, which the bucketed pipeline pads away. Each program counts
    in `repro_torch.train.TRACE_COUNTS` ("train_step_legacy"), and the
    programs go with the step."""
    from ..train.loop import TRACE_COUNTS, array_key, step_program
    from . import compiled
    w_size = 0.0 if ablate_size else 1.0
    w_queue = 0.0 if ablate_queue else 1.0

    def update(params, opt, b):
        params, opt, tot, parts, gn = adamw_step(
            lambda p: combined_loss(p, cfg, b, w_size=w_size,
                                    w_queue=w_queue),
            params, opt, lr=lr, clip_norm=1.0, weight_decay=1e-4)
        return params, opt, torch.stack([tot, parts["size"], parts["queue"],
                                         parts["sldn"], gn])

    cache = compiled.StepCache(TRACE_COUNTS, "train_step_legacy")

    def build(params, opt, b):
        return step_program(update, params, opt, b, per_sim=False, width=5)

    def train_step(params, opt, b):
        params, opt, outs = cache.run(array_key(b), b["t"].device, build,
                                      params, opt, b)
        tot, size, queue, sldn, gn = outs[0]
        return params, opt, tot, {"size": size, "queue": queue,
                                  "sldn": sldn}, gn
    return train_step


def train_m4(batches, cfg: M4Config, *, epochs=10, lr=3e-4, seed=0,
             log=print, ablate_size=False, ablate_queue=False,
             bucket_size=8, ckpt_dir=None, device="cuda"):
    """Wrapper over `repro_torch.train.fit` with the seed trainer's
    semantics: constant LR, one AdamW update per sim per epoch
    (`step_mode="per_sim"`), no shuffle, one program per bucket shape.
    Returns (TrainState, history)."""
    from ..train import TrainConfig, fit
    tc = TrainConfig(epochs=epochs, lr=lr, schedule="const", seed=seed,
                     bucket_size=bucket_size, step_mode="per_sim",
                     shuffle=False, ckpt_dir=ckpt_dir,
                     w_size=0.0 if ablate_size else 1.0,
                     w_queue=0.0 if ablate_queue else 1.0)
    return fit(batches, cfg, tc, device=device, log=log)
