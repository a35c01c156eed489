"""Gradient compression for the pod-crossing all-reduce, as
`repro.optim.compress`.

Top-k sparsification with error feedback (Stich et al.): only the k largest-
magnitude entries of each gradient leaf cross the slow inter-pod link; the
residual is accumulated locally and added back next step, which preserves
convergence. Values+indices are what a real deployment would all-gather over
the `pod` axis — compressing the inter-pod traffic by ~d/k.

The selection is `jax.lax.top_k`'s: the k largest magnitudes in descending
order, ties to the lower index (a stable sort; `torch.topk` does not
promise that order), so the indices and values are bitwise the JAX
package's.
"""
from __future__ import annotations

import math

import torch

from ..nn.moe import top_k


def topk_compress(g, frac=0.01):
    """g: any-shape tensor -> (values, idx, shape). Keeps max(1, frac*size)."""
    flat = g.reshape(-1)
    k = max(1, int(frac * flat.numel()))
    _, idx = top_k(torch.abs(flat), k)
    return flat[idx], idx, g.shape


def topk_decompress(vals, idx, shape, dtype=None):
    flat = torch.zeros(math.prod(shape), dtype=dtype or vals.dtype,
                       device=vals.device)
    flat[idx] = vals.to(flat.dtype)
    return flat.reshape(shape)


def ef_compress_update(g, err, frac=0.01):
    """Error-feedback step: compress (g + err); return (sparse g, new err)."""
    corrected = g + err
    vals, idx, shape = topk_compress(corrected, frac)
    sparse = topk_decompress(vals, idx, shape, corrected.dtype)
    return sparse, corrected - sparse
