"""NEGATIVE key-reuse fixtures: nothing here may fire."""
import numpy as np

from repro_torch import rng


def split_then_use(key):
    k1, k2 = rng.split(key).unbind(-2)
    return rng.bits(k1, 4), rng.bits(k2, 4)


def fold_per_iteration(key, n):
    out = []
    for i in range(n):
        ik = rng.fold_in(key, i)            # re-derived inside the loop
        out.append(rng.bits(ik, 8))
    return out


def rebound_key(key):
    a = rng.bits(key, 4)
    key = rng.fold_in(key, 1)               # fresh key, same name
    b = rng.permutation(key, 4)
    return a, b


def exclusive_branches(key, flag):
    if flag:
        return rng.bits(key, 4)
    else:
        return rng.permutation(key, 4)      # other arm of the same branch


def derivations_do_not_consume(key, n):
    rounds = rng.fold_in(key, 0)            # two derivations of one key
    shards = rng.fold_in(key, 1)
    return rng.bits(rounds, n), rng.bits(shards, n)


def numpy_generator_is_not_a_key(n):
    rng = np.random.default_rng(0)          # a numpy Generator named rng
    a = rng.permutation(n)
    b = rng.permutation(n)
    return a, b


def not_a_key(view, order):
    a = view[order]
    b = view[order]                         # plain tensors are not tracked
    return a + b
