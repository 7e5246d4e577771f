"""Explicit threefry2x32 keys, bitwise equal to ``jax.random``'s.

The coloring's randomness (Random-X Fit tie-breaks, the per-round and
per-iteration key folds, the RAND class permutation) must reproduce the
reference's streams exactly, so this module re-implements the
``jax.random`` operations the coloring uses, as jax computes them with
``jax_threefry_partitionable=True`` (the default of the jax releases the
reference targets):

- ``key(seed)`` — the raw key words ``[0, seed & 0xFFFFFFFF]``;
- ``fold_in(key, data)`` — ``threefry2x32(key, (0, data))``;
- ``bits(key, n)`` — word ``i`` is ``lo ^ hi`` of ``threefry2x32(key,
  (0, i))``.  Each word depends only on its own counter, so the first
  ``n`` words of a longer draw are the draw of length ``n``;
- ``split(key, n)`` — key ``i`` is ``threefry2x32(key, (0, i))``, i.e.
  ``fold_in(key, i)``;
- ``permutation(key, n)`` — jax's sort-based shuffle of ``arange(n)``.

A key is an int64 tensor of shape ``(..., 2)``; leading dims are a batch
of keys (one per shard, or per lane of a batch of graphs), and every
operation maps over them.  Words are carried as int64 masked to 32 bits:
``torch.uint32`` lacks the shifts, additions and modulo the hash needs.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), elementwise.

    Every argument is an int64 tensor (or python int) of 32-bit words;
    shapes broadcast.  Returns the two output words.
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK32
    return a, b


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``'s raw words, as a (2,) int64 CPU tensor.

    The reference runs with 64-bit jax types off, where the seed enters
    as a 32-bit integer: the high word is 0 and the low word is the seed
    modulo 2**32.
    """
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def _words(k: torch.Tensor, like: torch.Tensor):
    """The two key words, placed where ``like`` lives.

    A single CPU key meeting device data becomes two python ints, so the
    hash runs on the device without a host-to-device copy.
    """
    if k.device != like.device and k.dim() == 1:
        k1, k2 = k.tolist()
        return k1, k2
    k = k.to(like.device)
    return k[..., 0], k[..., 1]


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key per element of ``data``.

    ``data`` is a python int or an integer tensor (e.g. ``arange(P)`` on
    the device, one key per shard); the key's batch dims broadcast against
    ``data``'s, and the result is their broadcast shape ``+ (2,)``.  A
    python int is placed on the key's device.
    """
    data = torch.as_tensor(
        data, dtype=torch.int64,
        device=None if isinstance(data, torch.Tensor) else k.device)
    k1, k2 = _words(k, data)
    a, b = threefry2x32(k1, k2, torch.zeros_like(data), data & MASK32)
    return torch.stack([a, b], dim=-1)


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` as int64 words in [0, 2**32).

    ``k`` of shape ``(..., 2)`` gives ``(..., n)`` on ``k``'s device.
    """
    counts = torch.arange(n, dtype=torch.int64, device=k.device)
    a, b = threefry2x32(k[..., 0, None], k[..., 1, None], 0, counts)
    return a ^ b


def as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> their int32 bit pattern."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)``: ``(..., n, 2)`` keys on ``k``'s device.

    Under partitionable threefry key ``i`` hashes the counter ``(0, i)``,
    which is exactly ``fold_in(k, i)``.
    """
    return fold_in(k[..., None, :],
                   torch.arange(n, dtype=torch.int64, device=k.device))


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: a shuffle of ``arange(n)`` (int64,
    on ``k``'s device), ``(..., n)`` for a batch of keys.

    jax's ``_shuffle``: ``ceil(3 ln(max(1, n)) / ln(2**32 - 1))`` rounds
    (one up to n = 1625, two beyond), each splitting ``k, sub = split(k)``
    and stably sorting the current order by ``bits(sub, n)`` as unsigned
    32-bit keys (held in int64, so ``torch.sort`` orders them unsigned;
    stability decides ties).
    """
    uint32max = np.iinfo(np.uint32).max
    n_rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
    x = torch.arange(n, dtype=torch.int64, device=k.device).expand(
        k.shape[:-1] + (n,))
    for _ in range(n_rounds):
        k, sub = split(k).unbind(-2)
        perm = torch.sort(bits(sub, n), stable=True).indices
        x = x.gather(-1, perm)
    return x
