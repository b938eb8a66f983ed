"""Threefry-2x32 key stream of quantized training, in numpy.

The JAX package draws its stochastic-rounding noise from a hash of the
row index and one word of a per-tree key (``lightgbm_tpu/ops/grow.py``
:409-452).  The key stream is JAX's default PRNG:

- ``PRNGKey(data_random_seed & 0x7FFFFFFF)`` once per booster
  (``lightgbm_tpu/models/gbdt.py:735-737``);
- ``fold_in(key, trees_dispatched)`` per tree (:2129-2133);
- ``split(key)`` into the gradient and hessian keys
  (``lightgbm_tpu/ops/grow.py:414-415``).

This module reproduces those three functions bit for bit on the host,
for the "partitionable" Threefry layout (the default of jax 0.5 and
later): ``split`` hashes the counters ``(0, i)`` under the key, one
per new key.  Only ``kw[0] ^ kw[-1]`` of each key reaches the device
(:func:`key_word`).
"""
from __future__ import annotations

import numpy as np

__all__ = ["threefry_2x32", "prng_key", "fold_in", "split", "key_word"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(key, x0: int, x1: int) -> tuple:
    """Threefry-2x32 with 20 rounds of the counter pair ``(x0, x1)``
    under the two-word ``key``; returns the two output words."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed below 2^32."""
    seed = int(seed)
    return np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of ``(0, data)``."""
    return np.array(threefry_2x32(key, 0, int(data) & _MASK), np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys."""
    return np.array([threefry_2x32(key, 0, i) for i in range(num)],
                    np.uint32)


def key_word(key) -> int:
    """The one word of a key the rounding hash reads: ``kw[0] ^ kw[-1]``."""
    return int(key[0]) ^ int(key[-1])
