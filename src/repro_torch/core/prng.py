"""The slice of JAX's threefry stream that the JAX package draws from.

The JAX trainer draws from `jax.random` under its default config, where
`jax_threefry_partitionable` is on.  This module gives the same bits:

  split(key, n)            `jax.random.split`: threefry2x32(k1, k2) over
                           the 64-bit counters 0..n-1 (high word, low
                           word), the two output words as the rows' pair
  random_bits32(key, shape)  32-bit `jax.random.bits`: the two output
                           words of the same counters, XORed
  permutation(key, n)      `jax.random.permutation(key, n)`: JAX's
                           `_shuffle` over arange(n), ceil(3 ln n /
                           ln(2^32 - 1)) rounds, each a `split` and a
                           stable sort by `random_bits32` of the subkey

A key is a (2,) uint32 numpy array, as `jax.random.PRNGKey` holds it with
64-bit types off and as `TrainState` checkpoints it.  The words are
computed in torch on int64 tensors masked to 32 bits, so the same code
runs on the CPU and on the card.  The sort must be stable: 32-bit sort
keys tie (about n^2 / 2^33 pairs at n rows), and JAX's sort keeps tied
rows in their order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA          # threefry's key-schedule constant
_UINT32_MAX = 2 ** 32 - 1


def initial_key(seed: int) -> np.ndarray:
    """The key `jax.random.PRNGKey(seed)` gives with 64-bit types off."""
    return np.array([0, seed & _MASK], np.uint32)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under
    `key`.  The words are int64 tensors holding uint32 values, or Python
    ints; the two output words come back in the same form."""
    k = [int(key[0]), int(key[1])]
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The high and low words of the 64-bit counters 0..n-1."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & _MASK


def _as_key(key) -> np.ndarray:
    key = np.asarray(key)
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) uint32 array, got shape "
                         f"{key.shape}")
    return key.astype(np.uint32)


def split(key, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: (n, 2) uint32 keys.  The trainer splits
    once a tree, so the few counters go through Python ints, not tensor
    ops."""
    key = _as_key(key)
    return np.array([threefry2x32(key, i >> 32, i & _MASK)
                     for i in range(n)], np.uint32).reshape(n, 2)


def random_bits32(key, shape, device: torch.device | str = "cpu"
                  ) -> torch.Tensor:
    """32-bit `jax.random.bits(key, shape)` as an int64 tensor on
    `device` holding the uint32 values."""
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape), device)
    b0, b1 = threefry2x32(_as_key(key), hi, lo)
    return (b0 ^ b1).view(shape)


def shuffle_rounds(n: int) -> int:
    """The sort rounds of JAX's `_shuffle` over n items."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))


def permutation(key, n: int, device: torch.device | str = "cpu"
                ) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: an int64 permutation of
    arange(n) on `device`."""
    key = _as_key(key)
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        sort_keys = random_bits32(sub, (n,), device)
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x
