"""Simulation-state probes: ring buffers on the arena's device.

The paper's training signal is dense supervision on *intermediate*
network state — remaining flow size and per-link queue length. A
`ProbeConfig` asks the event loop to record, every `stride`-th event, a
sample of the simulator's belief about that state into preallocated ring
buffers:

- ``link_queue``      per-link predicted queue length (m4's MLP-queue head)
- ``link_active``     per-link active-flow count
- ``flow_remaining``  per-flow remaining size (m4's MLP-size head;
                      flowsim's exact residual)
- ``flow_rate``       per-flow max-min rate (flowsim's water-filling)

The port of `repro.core.probes`. JAX takes a sample under `lax.cond`
inside its scan; the port's loops run as programs of
`repro_torch.core.compiled`, whose probed steps are an event, its sample
and `stride - 1` more events, so a stride hit is decided by the program's
shape and never by a device value. `record` writes the sample into ring
slot ``hits % max_samples`` with in-place index copies, where `hits` is a
counter on the device that each sample advances (a captured graph
replays it): no `.item()` and no device-to-host copy.
``probes=None`` runs the loop exactly as unprobed: no extra tensor op and
no extra allocation.

Ring semantics: sample ``k`` (the k-th stride hit) lands in slot
``k % max_samples``; once the ring wraps, the buffer holds the *last*
``max_samples`` samples and `finalize` rolls them back into chronological
order on the host. Padded-arena events (time >= BIG/2) are dropped at
finalize, so batch-padded scenarios never leak junk samples.

The finalized series dict is the wire format of
`repro_torch.obs.timeseries` (schema ``repro.obs.timeseries/1``, shared
with the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

BIG = 1e30
SCHEMA_TS = "repro.obs.timeseries/1"

#: every channel any backend can record, in canonical order
CHANNELS = ("link_queue", "link_active", "flow_remaining", "flow_rate")
#: what each backend knows how to read out of its arenas
M4_CHANNELS = ("link_queue", "link_active", "flow_remaining")
FLOWSIM_CHANNELS = ("link_active", "flow_remaining", "flow_rate")
#: which entity axis the (S, D) sample dimension indexes
LINK_CHANNELS = ("link_queue", "link_active")
FLOW_CHANNELS = ("flow_remaining", "flow_rate")


@dataclass(frozen=True)
class ProbeConfig:
    """Probe spec: sampling stride (in events), ring capacity, and the
    channel mask. Frozen and hashable, as the JAX package's, where it is a
    static jit argument; equal configs compare and hash equal."""
    stride: int = 1
    max_samples: int = 256
    channels: Tuple[str, ...] = CHANNELS

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"probe stride must be >= 1, got {self.stride}")
        if self.max_samples < 1:
            raise ValueError(
                f"probe max_samples must be >= 1, got {self.max_samples}")
        bad = [c for c in self.channels if c not in CHANNELS]
        if bad:
            raise ValueError(f"unknown probe channels {bad}; valid: {CHANNELS}")
        # canonical order + dedupe => equal configs hash equal
        canon = tuple(c for c in CHANNELS if c in self.channels)
        object.__setattr__(self, "channels", canon)


def normalize_probes(probes: Optional[ProbeConfig],
                     supported: Tuple[str, ...] = CHANNELS
                     ) -> Optional[ProbeConfig]:
    """Intersect the requested channels with what a backend supports; an
    empty result normalizes to None (probes fully off), so entry points
    branch on one `probes is None` check."""
    if probes is None:
        return None
    chans = tuple(c for c in probes.channels if c in supported)
    if not chans:
        return None
    return replace(probes, channels=chans)


def init_buffers(probes: ProbeConfig, *, batch: int, num_flows: int,
                 num_links: int, device) -> Dict[str, torch.Tensor]:
    """Preallocated ring buffers, (B, S) and (B, S, D), on `device`. The
    `ev` slots start at -1 so never-written slots show on the host
    (`reset_buffers` restores that state in place)."""
    S = probes.max_samples
    bufs = {"t": torch.zeros(batch, S, dtype=torch.float32, device=device),
            "ev": torch.full((batch, S), -1, dtype=torch.int32,
                             device=device)}
    for ch in probes.channels:
        D = num_links if ch in LINK_CHANNELS else num_flows
        bufs[ch] = torch.zeros(batch, S, D, dtype=torch.float32, device=device)
    return bufs


def reset_buffers(bufs) -> None:
    """Back to `init_buffers`' state, in place."""
    for k, v in bufs.items():
        v.fill_(-1 if k == "ev" else 0)


def record(probes: ProbeConfig, bufs, hits: torch.Tensor, t_ev,
           values: Dict[str, Callable[[], torch.Tensor]]) -> None:
    """Write the sample of stride hit number `hits` (a 0-d int64 device
    counter, advanced here) into ring slot ``hits % max_samples``: the
    event index ``hits * stride``, the (B,) event times `t_ev`, and each
    channel's (B, D) sample from its thunk in `values`."""
    slot = (hits % probes.max_samples).reshape(1)
    B = t_ev.shape[0]
    bufs["t"].index_copy_(1, slot, t_ev[:, None])
    bufs["ev"].index_copy_(1, slot, (hits * probes.stride).to(
        torch.int32).expand(B, 1))
    for ch in probes.channels:
        bufs[ch].index_copy_(1, slot, values[ch]()[:, None])
    hits.add_(1)


def finalize(probes: ProbeConfig, bufs, *, num_flows: int, num_links: int,
             trim_flows: Optional[int] = None,
             trim_links: Optional[int] = None) -> Dict[str, object]:
    """Host-side, for one scenario's (S,) / (S, D) numpy rings: unroll the
    ring into chronological order, drop unwritten and padded-arena
    (t >= BIG/2) slots, trim channel dims to the real flow/link counts,
    and assemble the timeseries dict."""
    t = np.asarray(bufs["t"], np.float64)
    ev = np.asarray(bufs["ev"], np.int64)
    S = probes.max_samples
    # chronological unroll: ev is strictly increasing in write order, so
    # the oldest live slot is the one holding the smallest non-negative ev
    written = ev >= 0
    if written.any() and written.all():
        start = int(np.argmin(ev))
        order = (np.arange(S, dtype=np.int64) + start) % S
    else:
        order = np.argsort(np.where(written, ev, np.iinfo(np.int64).max))
    t, ev = t[order], ev[order]
    keep = (ev >= 0) & (t < BIG / 2)
    nf = num_flows if trim_flows is None else trim_flows
    nl = num_links if trim_links is None else trim_links
    channels = {}
    for ch in probes.channels:
        arr = np.asarray(bufs[ch], np.float64)[order][keep]
        channels[ch] = arr[:, :nl] if ch in LINK_CHANNELS else arr[:, :nf]
    return {
        "schema": SCHEMA_TS,
        "stride": probes.stride,
        "max_samples": probes.max_samples,
        "t": t[keep],
        "ev": ev[keep],
        "channels": channels,
        "meta": {},
    }


def buffers_numpy(bufs) -> Dict[str, np.ndarray]:
    """The (B, ...) device rings as numpy arrays on the host (one copy
    each, after the loop)."""
    return {k: v.cpu().numpy() for k, v in bufs.items()}
