"""Threefry-2x32 key streams of quantized training and row sampling.

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

Row sampling (bagging, GOSS, MVS) draws ``jax.random.uniform(key, (N,))``
with keys made by the same three functions
(``lightgbm_tpu/models/gbdt.py:1110-1125``,
``lightgbm_tpu/models/boosting.py:78-176``).  :func:`uniform_rows` is
that draw's plain PyTorch version: row ``i``'s bits are ``o0 ^ o1`` of
``threefry_2x32(key, 0, i)``, the partitionable layout's counter of a
flat index (``jax/_src/prng.py``), made into a float as ``uniform`` does:
the top 23 bits as the mantissa of a float in [1, 2), minus 1.  Kernel B
(``csrc/sample.cu``) computes the same bits on the card.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry_2x32", "prng_key", "fold_in", "split", "key_word",
           "uniform_rows"]

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


def _rotl_rows(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def uniform_rows(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` as (n,) float32, bit for bit.

    ``key``: a (2,) uint32 key, or its two words as an int64 tensor (a
    captured graph reads the tensor at every replay).  Threefry-2x32 of
    the counters ``(0, i)`` in int64 tensor ops masked to 32 bits, since
    PyTorch has no uint32 add on every backend."""
    if torch.is_tensor(key):
        device = key.device if device is None else device
        k0, k1 = key[0] & _MASK, key[1] & _MASK
    else:
        k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x1 = (torch.arange(n, dtype=torch.int64, device=device) + ks[1]) & _MASK
    x0 = torch.zeros_like(x1) + ks[0]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl_rows(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    # (bits >> 9) | 0x3F800000 as a float, minus 1: the mantissa * 2^-23
    return ((x0 ^ x1) >> 9).to(torch.float32) * (2.0 ** -23)
