"""The RAND class permutation and the ND-RAND schedules against the
reference, bit for bit.

``rng.split``/``rng.permutation`` are held to ``jax.random`` (one- and
two-round sizes, and a key whose sort keys tie); ``permutation_rank(RAND)``
to the reference's; ``pipeline_sim`` under ND-RAND%2 and ND-RAND%2^i,
``recolor_iterations`` (fused and host loop) and ``recolor_loop_sim`` to
the reference's on the same partition and keys (views, stats with
``wire_bytes``/``n_exchanges``, histories; integer outputs, tolerance 0).
Key-less calls fold a per-call count into the seed, so they differ back
to back; explicit keys reproduce.  The reference runs live under
``jax_threefry_partitionable=True``, set explicitly.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import recolor as R_recolor
from repro_torch import rng
from repro_torch.core import recolor as T_recolor
from test_torch_threads import one_torch_thread  # noqa: F401

SCHEMES = ["sparse", "allgather"]
TIE_SEED = 1563    # split(key(1563))[1] draws a repeated word among 1024


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _port_key(k) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(k))
                            .astype(np.int64))


# -- rng.split / rng.permutation ----------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_split_matches_jax(seed, n):
    k = jax.random.fold_in(jax.random.key(seed), 2)
    want = np.asarray(jax.random.key_data(jax.random.split(k, n)))
    np.testing.assert_array_equal(rng.split(_port_key(k), n).numpy(), want)


@pytest.mark.parametrize("n", [64, 1024, 1625, 1626, 2048, 4096])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_permutation_matches_jax(seed, n):
    """1625 is the last one-round size, 1626 the first two-round one."""
    k = jax.random.fold_in(jax.random.key(seed), 5)
    want = np.asarray(jax.random.permutation(k, n))
    np.testing.assert_array_equal(rng.permutation(_port_key(k), n).numpy(),
                                  want)


def test_permutation_tie_is_broken_like_jax():
    """Two equal sort keys: the stable sort keeps their order, as jax's."""
    k = rng.key(TIE_SEED)
    draws = rng.bits(rng.split(k)[1], 1024)
    assert draws.unique().numel() < 1024
    want = np.asarray(jax.random.permutation(jax.random.key(TIE_SEED), 1024))
    np.testing.assert_array_equal(rng.permutation(k, 1024).numpy(), want)


# -- permutation_rank(RAND) ---------------------------------------------------

@pytest.mark.parametrize("mc", [64, 1024, 2048])
@pytest.mark.parametrize("seed", [0, 3, TIE_SEED])
def test_rand_rank_matches_reference(mc, seed):
    gen = np.random.default_rng(seed)
    sizes = gen.integers(0, 5, mc).astype(np.int32)
    sizes[gen.random(mc) < 0.3] = 0
    k = jax.random.key(seed)
    want = np.asarray(R_recolor.permutation_rank(jnp.asarray(sizes),
                                                 R.RAND, k))
    got = T_recolor.permutation_rank(torch.from_numpy(sizes).long(), T.RAND,
                                     _port_key(k))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rand_rank_needs_a_key():
    with pytest.raises(ValueError, match="key"):
        T_recolor.permutation_rank(torch.ones(64, dtype=torch.int64), T.RAND)


# -- the schedules through the pipeline and the recolor loops ----------------

@lru_cache(maxsize=None)
def _parts(P: int):
    g_ref = R.rmat.rmat_good(9, 8, seed=3)
    g = T.rmat.rmat_good(9, 8, seed=3)
    pr = R.partition_graph(g_ref, P)
    order = R.compute_order(pr, R.ordering.INTERNAL_FIRST)
    return pr, T.partition_graph(g, P), order, g


@lru_cache(maxsize=None)
def _seed_view(P: int, scheme: str) -> np.ndarray:
    pr, _, order, _ = _parts(P)
    with jax.threefry_partitionable(True):
        view, _ = R.color_graph_sim(
            pr, order, R.ColorConfig(selection="random_x", scheme=scheme))
    return np.asarray(view)


# Eight iterations tell the two schedules apart: ND-RAND%2 runs RAND at
# 2, 4, 6 and 8, ND-RAND%2^i at 2, 4 and 8 only.
N_SCHED_ITERS = 8
PERMS = {"nd_rand_2": ["nd", "rand"] * 4,
         "nd_rand_pow2": ["nd", "rand", "nd", "rand", "nd", "nd", "nd",
                          "rand"]}
SCHEDULES = {"nd_rand_2": dict(rand_every=2),
             "nd_rand_pow2": dict(rand_pow2=True)}


def test_schedules_differ_within_eight_iterations():
    assert PERMS["nd_rand_2"] != PERMS["nd_rand_pow2"]
    for name, sched in SCHEDULES.items():
        assert [T.schedule_for_iteration(it, **sched)
                for it in range(1, N_SCHED_ITERS + 1)] == PERMS[name]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_pipeline_nd_rand_matches_reference(schedule, scheme):
    pr, pt, order, g = _parts(4)
    make = lambda m: m.PipelineConfig(
        color=m.ColorConfig(selection="random_x", scheme=scheme),
        recolor=m.RecolorConfig(scheme=scheme), n_iters=N_SCHED_ITERS,
        seed=4, **SCHEDULES[schedule])
    vr, rr = R.pipeline_sim(pr, order, make(R))
    vt, rt = T.pipeline_sim(pt, order, make(T), device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert rt["color"] == rr["color"] and rt["history"] == rr["history"]
    assert [h["perm"] for h in rt["history"]] == PERMS[schedule]
    assert T.check_coloring(g, T.colors_from_views(pt, vt))["valid"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_recolor_iterations_match_reference(fused):
    pr, pt, _, _ = _parts(4)
    view = _seed_view(4, "sparse")
    kw = dict(rand_pow2=True, seed=5, fused=fused)
    vr, hr = R.recolor_iterations(pr, view, N_SCHED_ITERS,
                                  R.RecolorConfig(), **kw)
    vt, ht = T.recolor_iterations(pt, view, N_SCHED_ITERS,
                                  T.RecolorConfig(), device="cpu", **kw)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert ht == hr
    assert [h["perm"] for h in ht] == PERMS["nd_rand_pow2"]


def test_recolor_iterations_collect_sees_every_iteration():
    _, pt, _, _ = _parts(4)
    seen = []
    view, hist = T.recolor_iterations(
        pt, _seed_view(4, "sparse"), 3, T.RecolorConfig(), rand_every=3,
        collect=lambda v, st: seen.append((v.clone(), st["perm"])),
        device="cpu")
    assert [p for _, p in seen] == ["nd", "nd", "rand"]
    assert torch.equal(seen[-1][0], view) and len(hist) == 3


@pytest.mark.parametrize("scheme", SCHEMES)
def test_recolor_loop_sim_matches_reference(scheme):
    pr, pt, _, _ = _parts(4)
    view = _seed_view(4, scheme)
    make = lambda m: m.PipelineConfig(
        recolor=m.RecolorConfig(scheme=scheme), n_iters=6, rand_every=2,
        patience=2, seed=2)
    vr, hr, nr = R.recolor_loop_sim(pr, view, make(R),
                                    key=jax.random.key(8))
    vt, ht, nt = T.recolor_loop_sim(pt, view, make(T),
                                    key=_port_key(jax.random.key(8)),
                                    device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert (ht, nt) == (hr, nr)


# -- default keys --------------------------------------------------------------

def test_keyless_rand_calls_differ_and_explicit_keys_reproduce():
    """The reference's ``test_back_to_back_rand_iterations_differ`` on the
    port: key-less RAND calls advance a per-call count; one explicit key
    reproduces, and equals the reference with that key."""
    pr, pt, _, _ = _parts(4)
    view = _seed_view(4, "sparse")
    cfg = T.RecolorConfig()
    v1, _ = T.recolor_sim(pt, view, T.RAND, cfg, device="cpu")
    v2, _ = T.recolor_sim(pt, view, T.RAND, cfg, device="cpu")
    assert not torch.equal(v1, v2)
    k = jax.random.key(3)
    v3, s3 = T.recolor_sim(pt, view, T.RAND, cfg, key=_port_key(k),
                           device="cpu")
    v4, s4 = T.recolor_sim(pt, view, T.RAND, cfg, key=_port_key(k),
                           device="cpu")
    assert torch.equal(v3, v4) and s3 == s4
    vr, sr = R.recolor_sim(pr, view, R.RAND, R.RecolorConfig(), key=k)
    np.testing.assert_array_equal(v3.numpy(), np.asarray(vr))
    assert s3 == sr
