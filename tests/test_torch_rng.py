"""The port's threefry keys against ``jax.random``, bit for bit.

The reference draws under ``jax_threefry_partitionable=True``; the tests
set it explicitly instead of relying on the installed default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jax_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 + 5, -7])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(rng.key(seed).numpy(),
                                  _jax_words(jax.random.key(seed)))


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 11])
@pytest.mark.parametrize("data", [0, 1, 17, 2**31 + 1])
def test_fold_in_matches_jax(seed, data):
    want = _jax_words(jax.random.fold_in(jax.random.key(seed), data))
    np.testing.assert_array_equal(rng.fold_in(rng.key(seed), data).numpy(),
                                  want)


@pytest.mark.parametrize("n", [1, 2, 37, 1000])
def test_bits_match_jax(n):
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), 3), 1)
    want = np.asarray(jax.random.bits(k, (n,), jnp.uint32)).astype(np.int64)
    kt = rng.fold_in(rng.fold_in(rng.key(7), 3), 1)
    np.testing.assert_array_equal(rng.bits(kt, n).numpy(), want)


def test_batched_shard_keys_match_per_shard_jax():
    """One key per shard, folded from a device tensor of shard ids — the
    speculative round's ``fold_in(fold_in(key, rnd), p)`` — and the first
    n words of a longer draw (the port draws only the local rows)."""
    P, n, n_slots = 5, 64, 100
    keys = rng.fold_in(rng.fold_in(rng.key(0), 2), torch.arange(P))
    got = rng.as_int32_bits(rng.bits(keys, n)).numpy()
    for p in range(P):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 2), p)
        want = np.asarray(jax.random.bits(k, (n_slots,), jnp.uint32))[:n]
        np.testing.assert_array_equal(got[p], want.view(np.int32))
