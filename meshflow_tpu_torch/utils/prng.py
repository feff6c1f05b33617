"""Threefry-2x32 counter-based keys, bit-compatible with ``jax.random``.

RANSAC's draws must equal the JAX package's for the port to be checked
against it sample for sample, so the key tree of ``jax.random`` is
reproduced here on tensors: ``PRNGKey``, ``fold_in``, ``split`` and
``randint`` with the default threefry2x32 implementation and
``jax_threefry_partitionable`` on (its default in jax 0.9), where

* ``split(key, n)[i]  = threefry2x32(key, (0, i))``,
* ``fold_in(key, d)   = threefry2x32(key, (0, d))``,
* 32 random bits at flat index i are ``hi ^ lo`` of
  ``threefry2x32(key, (0, i))``.

A key is an int64 tensor of shape (..., 2) holding two uint32 words; all
arithmetic runs in int64 masked to 32 bits, because torch's uint32 shifts
and xor are incomplete.  Every function is batched over the leading key
dimensions, so one call derives the keys of every (pair, subframe).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(
    key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1).

    key: (..., 2) int64; x0, x1 broadcast against key[..., 0].
    """
    k0 = key[..., 0]
    k1 = key[..., 1]
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    a = (x0 + k0) & _MASK
    b = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT0 if i % 2 == 0 else _ROT1:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 32-bit seed: (2,) int64."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _as_counter(data, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(data, dtype=torch.int64, device=like.device) & _MASK


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in, batched: data broadcasts against key[..., 0]."""
    d = _as_counter(data, key)
    a, b = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """jax.random.split(key, num) for every key: (..., 2) -> (..., num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., None, :], torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit draws at flat indices 0..n-1: (..., 2) -> (..., n) int64."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., None, :], torch.zeros_like(i), i)
    return a ^ b


def randint(key: torch.Tensor, n: int, minval, maxval) -> torch.Tensor:
    """jax.random.randint(key, (n,), minval, maxval) with int32 output.

    minval/maxval broadcast against key[..., 0] (one span per key), so each
    key draws from its own range.  Returns (..., n) int64.
    """
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], n)
    lower = random_bits(keys[..., 1, :], n)
    lo = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.where(hi <= lo, torch.ones_like(hi - lo), hi - lo)
    lo, span = lo[..., None], span[..., None]
    multiplier = (65536 % span) & _MASK
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((higher % span) * multiplier + (lower % span)) & _MASK
    return lo + offset % span


def key_data(key) -> torch.Tensor:
    """A raw (..., 2) uint32 key array (numpy or tensor) as a port key."""
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64) & _MASK
    return torch.from_numpy(np.asarray(key).astype(np.int64)) & _MASK
