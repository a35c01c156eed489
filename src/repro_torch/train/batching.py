"""Shape-bucketing + padding of `EventBatch`es for training.

The port of `repro.train.batching`. Sims are sorted by arena footprint
(N flows, L links, K events), chunked into buckets of at most
`bucket_size`, and each bucket is padded to its max footprint and stacked
on a leading axis: the batch step mode trains on the whole bucket in one
update, the per-sim mode walks its sims one update each.

Padding follows the arena conventions the event loop already speaks
(`core.training.event_scan_losses`): padded *flow* rows carry no links
and are only ever reached through the clamped gather at N-1 under a zero
mask; padded *link* rows are on no snapshot; padded *events* are arrival
records whose snapshot indices are all -1, so every write they make lands
in the dump row (index N / L) and every loss term they contribute is
masked to zero. Per-sim losses on a padded, stacked bucket therefore
match the unpadded per-sim losses (asserted in tests).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.events import EventBatch


def pad_event_batch(b: EventBatch, n_total: int, l_total: int,
                    k_total: int) -> Dict[str, np.ndarray]:
    """Pad one sim's tensors to (n_total flows, l_total links, k_total
    events); returns a plain {field: array} dict ready for stacking."""
    n, l, k = b.footprint
    assert n_total >= n and l_total >= l and k_total >= k, \
        ((n, l, k), (n_total, l_total, k_total))
    a = b.to_arrays()

    def rows(x, total, fill):
        pad = total - x.shape[0]
        if pad == 0:
            return x
        shape = (pad,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)], 0)

    out = {
        # flow axis: padded flows have no links, zero features, sldn 1.0
        # (gathered only under a zero mask via the N-1 clamp)
        "flow_links": rows(a["flow_links"], n_total, -1),
        "flow_feat": rows(a["flow_feat"], n_total, 0),
        "gt_sldn": rows(a["gt_sldn"], n_total, 1.0),
        "ideal_fct": rows(a["ideal_fct"], n_total, 1e-9),
        "t_arrival": rows(a["t_arrival"], n_total, 0),
        "size_bytes": rows(a["size_bytes"], n_total, 0),
        # link axis: padded links sit on no path, appear in no snapshot
        "link_feat": rows(a["link_feat"], l_total, 0),
        "cfg_vec": a["cfg_vec"],
    }
    # event axis: arrival records with all-(-1) snapshots and zero masks —
    # their scatters hit the dump row, their loss terms are masked out.
    # Time continues at the last real timestamp so dt stays non-negative.
    t_pad = float(a["t"][-1]) if k else 0.0
    ev_fill = {"t": t_pad, "etype": 0, "fid": 0, "snap_f": -1,
               "snap_f_mask": 0, "snap_l": -1, "snap_l_mask": 0,
               "edge_l": 0, "edge_mask": 0, "gt_remaining": 0,
               "rem_mask": 0, "gt_queue": 0, "queue_mask": 0}
    for name, fill in ev_fill.items():
        out[name] = rows(a[name], k_total, fill)
    return out


def stack_bucket(batches: Sequence[EventBatch]) -> Dict[str, torch.Tensor]:
    """Pad every sim to the bucket's max footprint and stack each field
    on a leading sim axis -> the tensors (on the CPU) one train step
    consumes."""
    assert batches, "empty bucket"
    snap_shapes = {(b.snap_f.shape[1], b.snap_l.shape[1],
                    b.flow_links.shape[1]) for b in batches}
    assert len(snap_shapes) == 1, \
        f"bucket mixes snapshot layouts: {snap_shapes}"
    n = max(b.num_flows for b in batches)
    l = max(b.num_links for b in batches)
    k = max(b.num_events for b in batches)
    padded = [pad_event_batch(b, n, l, k) for b in batches]
    return {name: torch.from_numpy(np.stack([p[name] for p in padded]))
            for name in padded[0]}


class Bucket:
    """One stacked training unit: `arrays` (leading axis = sim) plus the
    positions of its sims in the original corpus order. `to(device)`
    moves the arrays once, before training walks the bucket."""

    def __init__(self, indices: List[int], batches: List[EventBatch]):
        self.indices = list(indices)
        self.arrays = stack_bucket(batches)
        self.size = len(indices)
        b0 = self.arrays["flow_links"]
        self.shape = (b0.shape[1], self.arrays["link_feat"].shape[1],
                      self.arrays["t"].shape[1])

    def to(self, device) -> "Bucket":
        self.arrays = {k: v.to(device) for k, v in self.arrays.items()}
        return self

    def __repr__(self):
        n, l, k = self.shape
        return f"Bucket(B={self.size}, N={n}, L={l}, K={k})"


def make_buckets(batches: Sequence[EventBatch],
                 bucket_size: int = 8) -> List[Bucket]:
    """Sort sims by (N, L, K) footprint, chunk into buckets of at most
    `bucket_size`, pad each to its own max shape.

    Footprint-sorting keeps padding waste low (near-uniform shapes share
    a bucket) and makes bucket membership deterministic — the resume
    guarantee depends on every run walking the identical step sequence.
    """
    if bucket_size < 1:
        raise ValueError(f"bucket_size must be >= 1, got {bucket_size}")
    order = sorted(range(len(batches)), key=lambda i: batches[i].footprint)
    return [Bucket(order[lo:lo + bucket_size],
                   [batches[i] for i in order[lo:lo + bucket_size]])
            for lo in range(0, len(order), bucket_size)]
