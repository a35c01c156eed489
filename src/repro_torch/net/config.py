"""Scenario records: the congestion-control `NetConfig` and the `Flow`.

Copies of `repro.net.packetsim.NetConfig` and of the six scenario fields
of `repro.net.packetsim.Flow`; the packet-level simulator's runtime fields
stay with the JAX package, which alone runs that simulator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class NetConfig:
    cc: str = "dctcp"            # dctcp | dcqcn | timely
    init_window: float = 10_000  # bytes
    buffer_bytes: float = 130_000
    dctcp_k: float = 20_000      # bytes
    dcqcn_kmin: float = 20_000
    dcqcn_kmax: float = 40_000
    timely_tlow: float = 50e-6
    timely_thigh: float = 125e-6

    def feature_vec(self) -> np.ndarray:
        """9-dim config vector fed to m4 (§3.4)."""
        one_hot = {"dctcp": [1, 0, 0], "dcqcn": [0, 1, 0], "timely": [0, 0, 1]}[self.cc]
        return np.array(one_hot + [
            self.init_window / 15e3, self.buffer_bytes / 160e3,
            self.dctcp_k / 30e3, self.dcqcn_kmin / 30e3,
            self.dcqcn_kmax / 50e3, self.timely_thigh / 150e-6,
        ], dtype=np.float32)


@dataclass
class Flow:
    fid: int
    src: int
    dst: int
    size: int
    t_arrival: float
    path: List[int]
