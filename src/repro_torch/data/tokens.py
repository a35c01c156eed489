"""Deterministic, step-indexed synthetic token pipeline for LM training:
the port's copy of `repro.data.tokens` (pure numpy, so batches are bitwise
the JAX package's for every (seed, step, host_id, num_hosts)).

Restart-exactness: batch(step) is a pure function of (seed, step), so a
resume from any checkpoint consumes exactly the same data stream — no
iterator state to persist. On a real fleet each data-parallel rank slices
its shard by (host_id, num_hosts); the same function signature serves both.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self):
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def batch(self, step: int):
        """-> dict(tokens (B,S), labels (B,S)) for this host at `step`.

        Markov-ish synthetic stream (not iid uniform) so models can actually
        reduce loss: token_{t+1} = (a * token_t + noise) % vocab.
        """
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S, V = self.host_batch, self.seq_len, self.vocab
        x = np.zeros((B, S + 1), np.int64)
        x[:, 0] = rng.integers(0, V, B)
        mult = 31
        noise = rng.integers(0, max(V // 64, 2), (B, S))
        for t in range(S):
            x[:, t + 1] = (x[:, t] * mult + noise[:, t]) % V
        return {"tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32)}
