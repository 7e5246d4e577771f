"""Asynchronous recoloring (aRC) against the reference, bit for bit.

``arc_sim`` orders each shard's vertices by class step (ND or RAND rank of
the seed coloring) and reruns the speculative coloring from an empty view,
through the tile-parallel or the sequential path.  With an explicit key the
port's view and stats (``n_out_of_range``, ``wire_bytes`` and
``n_exchanges`` included) equal the reference's (integer outputs,
tolerance 0); key-less calls fold a per-call count into the seed, so they
differ back to back.  The reference runs live under
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
from repro_torch.core import recolor as T_recolor

MC = 256
# the reference's test_pipeline aRC config: Random-X makes the repair
# stream observable; and the sequential path, Least-Used and First Fit
SP_CFGS = {
    "parallel_random_x": dict(max_colors=MC, superstep=64,
                              selection="random_x", random_x=10),
    "sequential_least_used": dict(max_colors=MC, superstep=64,
                                  selection="least_used"),
    "sequential_first_fit": dict(max_colors=MC, superstep=32,
                                 parallel_chunk=False, exchange_every=2),
}


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _port_key(k) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(k))
                            .astype(np.int64))


@lru_cache(maxsize=None)
def _setup(P: int, scheme: str):
    """(reference partition, port partition, graph, seed view)."""
    g_ref = R.rmat.rmat_good(9, 8, seed=5)
    g = T.rmat.rmat_good(9, 8, seed=5)
    pr = R.partition_graph(g_ref, P)
    order = R.compute_order(pr, R.ordering.NATURAL)
    with jax.threefry_partitionable(True):
        view, _ = R.color_graph_sim(
            pr, order, R.ColorConfig(max_colors=MC, selection="random_x",
                                     scheme=scheme))
    return pr, T.partition_graph(g, P), g, np.asarray(view)


@pytest.mark.parametrize("sp", list(SP_CFGS))
@pytest.mark.parametrize("perm", ["nd", "rand"])
def test_arc_sim_matches_reference(perm, sp):
    pr, pt, g, view = _setup(4, "sparse")
    k = jax.random.key(11)
    vr, sr = R.arc_sim(pr, view, perm, R.RecolorConfig(max_colors=MC),
                       R.ColorConfig(scheme="sparse", **SP_CFGS[sp]), key=k)
    vt, st = T.arc_sim(pt, view, perm, T.RecolorConfig(max_colors=MC),
                       T.ColorConfig(scheme="sparse", **SP_CFGS[sp]),
                       key=_port_key(k), device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    assert T.check_coloring(g, T.colors_from_views(pt, vt))["valid"]


@pytest.mark.parametrize("sp", ["parallel_random_x", "sequential_least_used"])
def test_arc_sim_allgather_p16_matches_reference(sp):
    pr, pt, _, view = _setup(16, "allgather")
    k = jax.random.key(2)
    vr, sr = R.arc_sim(pr, view, "rand", R.RecolorConfig(max_colors=MC),
                       R.ColorConfig(scheme="allgather", **SP_CFGS[sp]),
                       key=k)
    vt, st = T.arc_sim(pt, view, "rand", T.RecolorConfig(max_colors=MC),
                       T.ColorConfig(scheme="allgather", **SP_CFGS[sp]),
                       key=_port_key(k), device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr


def test_arc_order_matches_reference():
    """Local slots by (class step, slot), -1 past each shard's vertices."""
    pr, pt, _, view = _setup(4, "sparse")
    n_local_max = pt.n_local_max
    sizes = np.bincount(view[:, :n_local_max].ravel(), minlength=MC)
    sizes[0] = 0
    k = jax.random.key(4)
    rank_r = R_recolor.permutation_rank(jnp.asarray(sizes, jnp.int32),
                                        R.RAND, k)
    want = jax.vmap(lambda v, nl: R_recolor.arc_order_spmd(
        v, nl, n_local_max, rank_r))(jnp.asarray(view),
                                     jnp.asarray(pr.n_local))
    rank_t = T_recolor.permutation_rank(torch.from_numpy(sizes), T.RAND,
                                        _port_key(k))
    got = T_recolor.arc_order(torch.from_numpy(view),
                              torch.from_numpy(np.asarray(pt.n_local)),
                              n_local_max, rank_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_keyless_arc_calls_differ_and_explicit_keys_reproduce():
    """The reference's ``test_arc_back_to_back_differs_and_explicit_key_
    reproduces`` on the port."""
    _, pt, _, view = _setup(4, "sparse")
    rcfg = T.RecolorConfig(max_colors=MC)
    scfg = T.ColorConfig(scheme="sparse", **SP_CFGS["parallel_random_x"])
    v1, _ = T.arc_sim(pt, view, "rand", rcfg, scfg, device="cpu")
    v2, _ = T.arc_sim(pt, view, "rand", rcfg, scfg, device="cpu")
    assert not torch.equal(v1, v2)
    k = _port_key(jax.random.key(9))
    v3, s3 = T.arc_sim(pt, view, "rand", rcfg, scfg, key=k, device="cpu")
    v4, s4 = T.arc_sim(pt, view, "rand", rcfg, scfg, key=k, device="cpu")
    assert torch.equal(v3, v4) and s3 == s4
