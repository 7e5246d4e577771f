"""The frontier entry points of the speculative repair
(``ops.detect_conflicts_frontier[_d2]``) against the reference's
``repro.core.speculative._detect_conflicts_frontier``, and — on the GPU —
the frontier kernels against their plain versions.

One call tests a whole round's frontier on every shard: the first
``n_steps * superstep`` positions of the visit order, position i of shard
p active iff its entry is ``>= 0`` and ``i < n_need[p]``.  The reference
runs live, per shard (``jax.vmap`` over the shard axis, its ``xla``
backend), on the same numpy inputs: the port's ``new_view`` must equal
the reference's per-shard views, its loser count the sum of the
reference's per-shard counts, its boundary flag their OR (integer and
bool outputs, tolerance 0).  Inputs are small partitions (rmat scale 8 at
P=4; ``grid3d(6, 6, 6)`` at P=2 with the one-hop halo and at P=2 and P=16
with the two-hop halo) with views seeded from numpy.  The ``cuda`` cases hold the kernels against
the plain versions on the card (``python -m pytest -m cuda
tests/test_torch_conflict_frontier.py`` on the GPU machine; the reference
cases skip there, having no jax).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import ops

S = 16          # superstep: several chunks per frontier
# distance 1 on an rmat graph (nearly every row on the boundary) and on a
# grid (a third of the rows internal), distance 2 and partial distance 2
# (the odd global ids unmarked: -1 entries in the order)
CASES = ["d1", "d1_grid", "d2", "partial_d2"]
VIEWS = ["planted", "random"]
# n_need per shard: every row, a random share (one shard at 0), or only
# the internal rows of an Internal-First order (no loser on the boundary)
NEEDS = ["all", "mixed", "internal"]
P_CASE = {"d1": 4, "d1_grid": 2, "d2": 2, "partial_d2": 2}


@lru_cache(maxsize=None)
def _part(case, P=None):
    """(graph, port partition, device arrays on the CPU) of ``case`` on
    ``P`` shards (default ``P_CASE[case]``)."""
    P = P or P_CASE[case]
    if case == "d1":
        g = T.rmat.rmat_good(8, 8, seed=1)
        pg = T.partition_graph(g, P)
    else:
        g = T.rmat.grid3d(6, 6, 6)
        pg = T.partition_graph(g, P, halo=1 if case == "d1_grid" else 2)
    return g, pg, T.to_device(pg, "cpu", sparse=False)


def _d2(case):
    return case in ("d2", "partial_d2")


def _nbrs(case, arrs):
    return (arrs["nbr"], arrs["nbr2"]) if _d2(case) else (arrs["nbr"],)


@lru_cache(maxsize=None)
def _coloring(case, P):
    """A valid coloring of the partition: the port's own speculative run."""
    _, pg, _ = _part(case, P)
    cfg = T.ColorConfig(max_colors=128, superstep=32, tile=8,
                        scheme="allgather", distance=2 if _d2(case) else 1)
    order = T.compute_order(pg, T.ordering.NATURAL)
    return T.color_graph_sim(pg, order, cfg, device="cpu")[0].numpy()


def _view(case, P, kind, gen):
    """``planted``: a valid coloring of the partition (the port's own
    speculative run) in which about a third of the local rows, and some
    ghosts, copy the color of one of their ELL neighbours; ``random``:
    colors 1…5 and 0 in every local and ghost slot.  The sentinel slot
    holds 0."""
    _, pg, arrs = _part(case, P)
    if kind == "random":
        view = gen.integers(0, 6, (pg.P, pg.n_slots)).astype(np.int32)
    else:
        view = _coloring("d2" if _d2(case) else case, P).copy()
        nbr = arrs["nbr2" if _d2(case) else "nbr"].numpy()
        sentinel = pg.n_slots - 1
        for p in range(pg.P):
            for r in np.flatnonzero(gen.random(pg.n_local_max) < 0.35):
                ids = nbr[p, r][nbr[p, r] != sentinel]
                if len(ids):
                    view[p, r] = view[p, gen.choice(ids)]
            ghosts = np.arange(pg.n_local_max, pg.n_slots - 1)
            hit = ghosts[gen.random(len(ghosts)) < 0.2]
            view[p, hit] = view[p, gen.integers(0, pg.n_local_max, len(hit))]
    view[:, -1] = 0
    return view


def _inputs(case, seed, kind, need, P=None):
    """(view, order_pad, n_need, n_steps) as numpy, for one round."""
    g, pg, arrs = _part(case, P)
    gen = np.random.default_rng(seed)
    order = np.full((pg.P, pg.n_local_max + S), -1, np.int32)
    n_need = np.zeros(pg.P, np.int64)
    internal = arrs["is_internal"].numpy()
    for p in range(pg.P):
        nl, lo = int(pg.n_local[p]), int(pg.offs[p])
        rows = gen.permutation(nl).astype(np.int32)
        if need == "internal":      # Internal-First: internal rows lead
            rows = rows[np.argsort(~internal[p, rows], kind="stable")]
            n_need[p] = int(internal[p, :nl].sum())
        elif need == "mixed":
            n_need[p] = 0 if p == 0 else gen.integers(1, nl + 1)
        else:
            n_need[p] = nl
        if case == "partial_d2":    # unmarked rows are -1 in the order
            rows = np.where((lo + rows) % 2 == 0, rows, -1)
        order[p, :nl] = rows
    n_steps = -(-int(n_need.max()) // S)
    return _view(case, P, kind, gen), order, n_need, n_steps


def _frontier(case, view, order, n_need, n_steps, P=None, backend="torch",
              device="cpu", prio=None):
    _, _, arrs = _part(case, P)
    on = lambda a: torch.as_tensor(a).to(device)
    nbrs = tuple(on(n) for n in _nbrs(case, arrs))
    fn = (ops.detect_conflicts_frontier_d2 if _d2(case)
          else ops.detect_conflicts_frontier)
    return fn(on(view), on(arrs["prio"] if prio is None else prio),
              on(arrs["is_internal"]), on(order), *nbrs, on(n_need),
              n_steps=n_steps, superstep=S, backend=backend)


# -- against the reference ---------------------------------------------------

def _reference(case, view, order, n_need, n_steps, P=None):
    """The reference's repair of every shard: (views, per-shard loser
    counts, per-shard boundary flags) as numpy."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    RS = pytest.importorskip("repro.core.speculative")
    _, pg, _ = _part(case, P)
    host = pg.arrays(sparse=False)
    keys = ["nbr", "prio", "is_internal"] + (["nbr2"] if _d2(case) else [])
    arrs = {k: jnp.asarray(host[k]) for k in keys}
    distance = 2 if _d2(case) else 1

    def one(v, a, o, n):
        return RS._detect_conflicts_frontier(v, a, o, n_steps, n, S,
                                             backend="xla",
                                             distance=distance)

    out = jax.vmap(one)(jnp.asarray(view), arrs, jnp.asarray(order),
                        jnp.asarray(n_need.astype(np.int32)))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("case", CASES)
def test_frontier_matches_reference(case, kind, need):
    view, order, n_need, n_steps = _inputs(case, 7, kind, need)
    new_view, n_conf, bnd = _frontier(case, view, order, n_need, n_steps)
    want_view, want_conf, want_bnd = _reference(case, view, order, n_need,
                                                n_steps)
    assert n_conf.dtype == torch.int64 and n_conf.dim() == 0
    assert bnd.dtype == torch.bool and bnd.dim() == 0
    np.testing.assert_array_equal(new_view.numpy(), want_view)
    assert int(n_conf) == int(want_conf.sum())
    assert bool(bnd) == bool(want_bnd.any())
    # the inputs hold what the case is about
    if kind == "planted" and need != "internal":
        assert int(n_conf) > 0 and bool(bnd)
    if need == "internal":
        assert not bool(bnd)
        if kind == "planted" and case != "d1":   # rmat: ~no internal rows
            assert int(n_conf) > 0
    if need == "mixed":
        assert n_need[0] == 0 and (new_view[0] == torch.from_numpy(
            view[0])).all()


@pytest.mark.parametrize("case", ["d2", "partial_d2"])
def test_frontier_d2_on_16_shards_matches_reference(case):
    """P=16 on the 6x6x6 grid: most rows are boundary rows and their
    two-hop rows reach into several shards."""
    view, order, n_need, n_steps = _inputs(case, 3, "planted", "mixed",
                                           P=16)
    new_view, n_conf, bnd = _frontier(case, view, order, n_need, n_steps,
                                      P=16)
    want_view, want_conf, want_bnd = _reference(case, view, order, n_need,
                                                n_steps, P=16)
    np.testing.assert_array_equal(new_view.numpy(), want_view)
    assert int(n_conf) == int(want_conf.sum()) > 0
    assert bool(bnd) == bool(want_bnd.any())


def test_frontier_leaves_its_input_view_alone():
    view, order, n_need, n_steps = _inputs("d1", 2, "planted", "all")
    before = torch.from_numpy(view.copy())
    v = torch.from_numpy(view)
    _, _, arrs = _part("d1")
    new_view, n_conf, _ = ops.detect_conflicts_frontier(
        v, arrs["prio"], arrs["is_internal"], torch.from_numpy(order),
        arrs["nbr"], torch.from_numpy(n_need), n_steps=n_steps, superstep=S)
    assert torch.equal(v, before) and int(n_conf) > 0
    assert new_view.data_ptr() != v.data_ptr()
    assert int((new_view != v).sum()) == int(n_conf)


def test_frontier_entry_points_reject_what_they_cannot_run():
    view, order, n_need, n_steps = _inputs("d1", 1, "random", "all")
    _, pg, arrs = _part("d1")
    args = lambda **kw: dict(dict(
        view=torch.from_numpy(view), prio=arrs["prio"],
        is_internal=arrs["is_internal"], order_pad=torch.from_numpy(order),
        nbr=arrs["nbr"], n_need=torch.from_numpy(n_need)), **kw)
    kw = dict(n_steps=n_steps, superstep=S)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.detect_conflicts_frontier(**args(), backend="cuda", **kw)
    with pytest.raises(ValueError, match="columns of order_pad"):
        ops.detect_conflicts_frontier(
            **args(), n_steps=order.shape[1] // S + 1, superstep=S)
    with pytest.raises(ValueError, match="bad superstep"):
        ops.detect_conflicts_frontier(**args(), n_steps=1, superstep=0)
    with pytest.raises(ValueError, match="do not match"):
        ops.detect_conflicts_frontier(**args(prio=arrs["prio"][:, :-1]),
                                      **kw)
    with pytest.raises(ValueError, match="do not match"):
        ops.detect_conflicts_frontier(
            **args(n_need=torch.from_numpy(n_need[:-1])), **kw)
    with pytest.raises(TypeError, match="int32"):
        ops.detect_conflicts_frontier(
            **args(view=torch.from_numpy(view).long()), **kw)
    assert (ops.CONFLICT_FRONTIER.launches == 0
            and ops.CONFLICT_FRONTIER_D2.launches == 0)


def test_frontier_with_no_steps_is_a_copy():
    view, order, n_need, _ = _inputs("d2", 4, "planted", "all")
    new_view, n_conf, bnd = _frontier("d2", view, order, n_need, 0)
    np.testing.assert_array_equal(new_view.numpy(), view)
    assert int(n_conf) == 0 and not bool(bnd)


# -- the frontier kernels on the card ----------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _launches():
    return ops.CONFLICT_FRONTIER.launches + ops.CONFLICT_FRONTIER_D2.launches


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype and got[2].dtype == want[2].dtype
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("case", CASES)
def test_cuda_frontier_matches_plain(cuda_device, case, kind, need):
    view, order, n_need, n_steps = _inputs(case, 7, kind, need)
    before = _launches()
    got = _frontier(case, view, order, n_need, n_steps, backend="cuda",
                    device=cuda_device)
    want = _frontier(case, view, order, n_need, n_steps, backend="torch",
                     device=cuda_device)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d2", [False, True], ids=["d1", "d2"])
def test_cuda_frontier_reads_wide_rows_to_their_first_sentinel(cuda_device,
                                                               d2):
    """ELL rows wider than one round of the kernel's id loads (300, and
    300 + 70 at distance 2), with degrees from 0 (all sentinel) to the
    full width, few colors (many conflicts) and priorities with ties."""
    gen = np.random.default_rng(21)
    P, n_local, n_ghost = 3, 60, 400
    n_slots = n_local + n_ghost + 1
    sentinel = n_slots - 1

    def ell(width):
        deg = gen.integers(0, width + 1, (P, n_local))
        deg[:, :4] = [0, 33, 257, width]
        ids = gen.integers(0, sentinel, (P, n_local, width))
        return np.where(np.arange(width) < deg[..., None], ids,
                        sentinel).astype(np.int32)

    nbrs = (ell(300), ell(70)) if d2 else (ell(300),)
    view = gen.integers(0, 40, (P, n_slots)).astype(np.int32)
    view[:, -1] = 0
    prio = gen.integers(0, 50, (P, n_slots)).astype(np.int32)
    internal = gen.random((P, n_local)) < 0.5
    order = np.full((P, n_local + S), -1, np.int32)
    for p in range(P):
        order[p, :n_local] = gen.permutation(n_local)
    order[:, 5] = -1
    n_need = np.array([n_local, 17, 0], np.int64)
    on = lambda a: torch.as_tensor(a).to(cuda_device)
    fn = (ops.detect_conflicts_frontier_d2 if d2
          else ops.detect_conflicts_frontier)
    out = {}
    for backend in ("cuda", "torch"):
        out[backend] = fn(on(view), on(prio), on(internal), on(order),
                          *(on(n) for n in nbrs), on(n_need),
                          n_steps=-(-n_local // S), superstep=S,
                          backend=backend)
    torch.cuda.synchronize()
    _assert_same(out["cuda"], out["torch"])
    assert int(out["torch"][1]) > 0
    # rows whose ELL row is all sentinel never lose
    blank = on(np.ones((P, n_local, 300), np.int32) * sentinel)
    nb = (blank, blank[..., :70]) if d2 else (blank,)
    got = fn(on(view), on(prio), on(internal), on(order), *nb, on(n_need),
             n_steps=-(-n_local // S), superstep=S, backend="cuda")
    assert torch.equal(got[0], on(view)) and int(got[1]) == 0
    assert not bool(got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d1", "d2"])
def test_cuda_frontier_edge_cases(cuda_device, case):
    """No steps: a copy, zero counts and no launch; int64 priorities
    raise on the card."""
    view, order, n_need, _ = _inputs(case, 4, "planted", "all")
    before = _launches()
    new_view, n_conf, bnd = _frontier(case, view, order, n_need, 0,
                                      backend="cuda", device=cuda_device)
    assert _launches() == before
    assert torch.equal(new_view.cpu(), torch.from_numpy(view))
    assert int(n_conf) == 0 and not bool(bnd)
    _, _, arrs = _part(case)
    with pytest.raises(TypeError, match="int32 priorities"):
        _frontier(case, view, order, n_need, 1, backend="cuda",
                  device=cuda_device, prio=arrs["prio"].long())
    assert _launches() == before
