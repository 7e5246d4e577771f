"""POSITIVE key-reuse fixtures: every marked line must fire."""
import torch

from repro_torch import rng


def linear_reuse(key):
    a = rng.bits(key, 4)
    b = rng.permutation(key, 4)             # FIRE: key consumed twice
    return a, b


def loop_reuse(key, n):
    out = []
    for _ in range(n):
        out.append(rng.bits(key, 8))        # FIRE: same key every iteration
    return out


def reuse_after_tracking():
    key = rng.key(0)
    x = rng.bits(key, 2)
    y = rng.permutation(key, 8)             # FIRE: replayed local key
    return x, y


def draws(sizes, key):
    """A function that takes a key and draws from it."""
    return torch.argsort(rng.permutation(key, sizes.shape[-1]))


def reuse_through_a_drawing_function(sizes, key):
    a = draws(sizes, key)
    b = draws(sizes, key)                   # FIRE: the same permutation twice
    return a, b


def reuse_after_split(key):
    k1, k2 = rng.split(key).unbind(-2)
    a = rng.bits(k1, 4)
    b = rng.bits(k1, 4)                     # FIRE: k1 again, k2 unused
    return a, b, k2
