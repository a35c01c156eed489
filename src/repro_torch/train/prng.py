"""JAX's bucket order, reproduced in numpy.

The JAX package walks each epoch's buckets in the order
`jax.random.permutation(jax.random.fold_in(rng, epoch), n)` of its raw
uint32 key `rng` (`repro.train.loop.fit`). That draw is deterministic:
jax 0.9.0 uses threefry2x32 (20 rounds) with its default
`jax_threefry_partitionable=True`, and `permutation` sorts by rounds of
random 32-bit keys (`jax._src.random._shuffle`). This module is a uint32
twin of those functions, so the port's `fit` walks the buckets in JAX's
order:

    key = fold_in(np.array([0, seed], np.uint32), epoch)
    order = permutation(key, n)

A key is a uint32 array of shape (2,), as `jax.random.PRNGKey` gives.
"""
from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "fold_in", "split", "random_bits", "permutation"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry2x32 block cipher of (x0, x1) under `key`, elementwise
    on uint32 arrays (`jax._src.prng._threefry2x32_lowering`)."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for data in [0, 2**32): the cipher
    of the counts (0, data) (`threefry_fold_in`)."""
    if not 0 <= int(data) < 2 ** 32:
        raise ValueError(f"fold_in data must lie in [0, 2**32), got {data}")
    with np.errstate(over="ignore"):
        y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                              np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _iota_2x32(n: int):
    """The high and low words of a uint64 iota of length n."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` with partitionable threefry
    (`_threefry_split_foldlike`): (num, 2) uint32 keys."""
    hi, lo = _iota_2x32(num)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key, hi, lo)
    return np.stack([b1, b2], axis=1)


def random_bits(key, n: int) -> np.ndarray:
    """n random 32-bit words, as `jax.random.bits(key, (n,), uint32)`
    draws them with partitionable threefry
    (`_threefry_random_bits_partitionable`)."""
    hi, lo = _iota_2x32(n)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key, hi, lo)
    return b1 ^ b2


def permutation(key, n: int) -> np.ndarray:
    """`jax.random.permutation(key, n)`: `jax._src.random._shuffle` of
    arange(n), ceil(3 ln n / ln(2**32 - 1)) rounds, each a split, 32-bit
    sort keys and a stable sort. int64, like the port's bucket indices."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    key = np.asarray(key, np.uint32)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x
