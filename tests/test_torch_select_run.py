"""The run entry points of the selection (``ops.select_run[_d2]``,
``ops.recolor_run[_d2]``) against the per-tile composition they replace,
against the reference, and — on the GPU — the run kernels against their
plain versions.

One call of a run entry point colors a whole run of speculative tiles or
recolor chunks in order.  Its plain version (``kernels/ref.py``) must equal,
bit for bit, the loop the coloring code ran before: per tile, an ELL gather
(``take_rows``), ``ops.select_colors[_d2]`` and a scatter into the view
(copied below as ``_tile_loop`` / ``_chunk_loop``).  Inputs come from seeded
numpy on small partitions; outputs are integer views, tolerance 0.  The
``cuda`` cases hold the run kernels against the plain versions on the card
(``python -m pytest -m cuda tests/test_torch_select_run.py`` on the GPU
machine; the reference cases skip there, having no jax).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import recolor as T_recolor
from repro_torch.core.comm import take_rows
from repro_torch.kernels import ops

MC = 128
TILE = 16
SELECTIONS = [("first_fit", 0), ("staggered", 0), ("random_x", 5),
              ("random_x", 40)]
# distance-1 graph, distance-2 graph (halo 2), and partial distance 2
# (the even global ids marked; unmarked rows are -1 in the visit order)
CASES = ["d1", "d2", "partial_d2"]
# recolor chunk rows: small enough that some class spans several chunks
CHUNK = {"d1": 6, "d2": 2}


@lru_cache(maxsize=None)
def _part(case):
    """(graph, port partition, device arrays on the CPU)."""
    if case == "d1":
        g = T.rmat.rmat_good(8, 8, seed=1)
        pg = T.partition_graph(g, 4)
    else:
        g = T.rmat.grid3d(6, 6, 6)
        pg = T.partition_graph(g, 4, halo=2)
    return g, pg, T.to_device(pg, "cpu", sparse=False)


def _nbrs(case, arrs):
    return (arrs["nbr"],) if case == "d1" else (arrs["nbr"], arrs["nbr2"])


def _clamping_superstep(n_local_max: int, tile: int) -> int:
    """A superstep, not a multiple of the tile, whose last superstep's last
    tile starts past ``L - tile`` (L = n_local_max + superstep), so
    ``s0 = L - tile`` clamps."""
    for s in range(n_local_max - 1, tile, -1):
        n_steps = -(-n_local_max // s)
        n_tiles = -(-s // tile)
        if s % tile and (n_steps - 1) * s + (n_tiles - 1) * tile > (
                n_local_max + s - tile):
            return s
    raise AssertionError("no clamping superstep for this partition")


def _random_view(pg, gen, zero_share=0.5):
    """A view with random colors (some out of range, some 0) in local and
    ghost slots; the sentinel slot holds 0."""
    view = gen.integers(1, MC + 4, (pg.P, pg.n_slots)).astype(np.int32)
    view[gen.random(view.shape) < zero_share] = 0
    view[:, -1] = 0
    return torch.from_numpy(view)


def _spec_inputs(case, seed, superstep):
    g, pg, arrs = _part(case)
    gen = np.random.default_rng(seed)
    order = np.full((pg.P, pg.n_local_max + superstep), -1, np.int32)
    marked_g = np.arange(g.n) % 2 == 0
    for p in range(pg.P):
        nl, lo = int(pg.n_local[p]), int(pg.offs[p])
        rows = gen.permutation(nl).astype(np.int32)
        if case == "partial_d2":
            rows = np.where(marked_g[lo + rows], rows, -1)
        order[p, :nl] = rows
    return dict(
        view=_random_view(pg, gen), order_pad=torch.from_numpy(order),
        rand=torch.from_numpy(gen.integers(-2**31, 2**31, (
            pg.P, pg.n_local_max), dtype=np.int64).astype(np.int32)),
        offset=torch.from_numpy(gen.integers(0, MC, (pg.P, 1))
                                .astype(np.int32)))


def _tile_loop(view, order_pad, nbrs, rand, offset, *, first_step, n_steps,
               superstep, tile, selection, x):
    """The speculative superstep loop as it ran before the run kernels:
    per tile one ELL gather, ``ops.select_colors[_d2]`` and a scatter."""
    n_slots = view.shape[1]
    last = order_pad.shape[1] - tile
    for si in range(first_step, first_step + n_steps):
        for ti in range(-(-superstep // tile)):
            s0 = min(si * superstep + ti * tile, last)
            chunk = order_pad[:, s0:s0 + tile]
            v_safe = chunk.clamp(min=0)
            active = (chunk >= 0) & (take_rows(view, v_safe) == 0)
            nbr_colors = take_rows(view, take_rows(nbrs[0], v_safe))
            kw = dict(max_colors=MC, selection=selection, x=x,
                      offset=offset, backend="torch")
            if len(nbrs) == 2:
                colors = ops.select_colors_d2(
                    nbr_colors, take_rows(view, take_rows(nbrs[1], v_safe)),
                    active, take_rows(rand, v_safe), **kw)
            else:
                colors = ops.select_colors(nbr_colors, active,
                                           take_rows(rand, v_safe), **kw)
            colors = colors.clamp(max=MC - 1)
            idx = torch.where(active, v_safe, n_slots - 1)
            val = torch.where(active, colors, 0)
            view.scatter_(1, idx.long(), val.to(view.dtype))
    return view


def _chunk_loop(view, nbrs, sched, first_class, last_class, chunk):
    """The recolor chunk loop as it ran before the run kernels."""
    n_slots = view.shape[1]
    n_local_max = nbrs[0].shape[1]
    lane = torch.arange(chunk)
    chunks = sched.class_chunks.tolist()
    for t in range(first_class, last_class + 1):
        for j in range(chunks[t]):
            pos = (sched.start_local[:, t] + j * chunk).clamp(max=n_local_max)
            active = lane < (sched.local_sizes[:, t] - j * chunk)[:, None]
            rows = sched.sorted_pad.long().gather(1, pos[:, None] + lane)
            rows = torch.where(active, rows, 0)
            nbr_colors = take_rows(view, take_rows(nbrs[0], rows))
            kw = dict(max_colors=MC, selection="first_fit", backend="torch")
            if len(nbrs) == 2:
                colors = ops.select_colors_d2(
                    nbr_colors, take_rows(view, take_rows(nbrs[1], rows)),
                    active, **kw)
            else:
                colors = ops.select_colors(nbr_colors, active, **kw)
            idx = torch.where(active, rows, n_slots - 1)
            val = torch.where(active, colors, 0)
            view.scatter_(1, idx, val)
    return view


def _select_run(case, t, backend="torch", **kw):
    _, _, arrs = _part(case)
    nbrs = tuple(n.to(t["view"].device) for n in _nbrs(case, arrs))
    fn = ops.select_run if len(nbrs) == 1 else ops.select_run_d2
    return fn(t["view"], t["order_pad"], *nbrs, t["rand"], t["offset"],
              max_colors=MC, backend=backend, **kw)


@pytest.mark.parametrize("sel,x", SELECTIONS)
@pytest.mark.parametrize("case", CASES)
def test_select_run_equals_tile_loop(case, sel, x):
    """Every superstep of the order in one call, with a clamped last tile,
    equals the per-tile loop."""
    _, pg, arrs = _part(case)
    S = _clamping_superstep(pg.n_local_max, TILE)
    n_steps = -(-pg.n_local_max // S)
    t = _spec_inputs(case, 11, S)
    want = _tile_loop(t["view"].clone(), t["order_pad"], _nbrs(case, arrs),
                      t["rand"], t["offset"], first_step=0, n_steps=n_steps,
                      superstep=S, tile=TILE, selection=sel, x=x)
    got = _select_run(case, t, first_step=0, n_steps=n_steps, superstep=S,
                      tile=TILE, selection=sel, x=x)
    assert got.data_ptr() == t["view"].data_ptr()        # in place
    assert torch.equal(got, want)
    assert not torch.equal(want, _spec_inputs(case, 11, S)["view"])


@pytest.mark.parametrize("case", CASES)
def test_select_run_split_equals_one_run(case):
    """A run cut at any superstep gives the view of the whole run: the
    runs only join the tile sequence."""
    _, pg, _ = _part(case)
    S, tile = 20, 8
    n_steps = -(-pg.n_local_max // S)
    whole = _spec_inputs(case, 5, S)
    _select_run(case, whole, first_step=0, n_steps=n_steps, superstep=S,
                tile=tile, selection="random_x", x=10)
    parts = _spec_inputs(case, 5, S)
    for first in range(n_steps):
        _select_run(case, parts, first_step=first, n_steps=1, superstep=S,
                    tile=tile, selection="random_x", x=10)
    assert torch.equal(whole["view"], parts["view"])


def _schedule(case, seed_view, chunk):
    """The ND recolor schedule of ``seed_view`` (every class, the
    all-gather events) with ``chunk`` rows per chunk."""
    _, pg, arrs = _part(case)
    cfg = T.RecolorConfig(max_colors=MC, chunk=chunk, scheme="allgather",
                          distance=1 if case == "d1" else 2)
    sizes, _ = T_recolor.class_sizes(seed_view, arrs["n_local"],
                                     pg.n_local_max, MC)
    n_classes = (sizes > 0).sum()
    rank = T_recolor.permutation_rank(sizes, T.ND)
    return T_recolor.recolor_schedule(arrs, seed_view, rank, n_classes, cfg,
                                      0)


def _seed_view(case, valid: bool):
    """A valid seed coloring (the port's own speculative run), or an
    invalid one: 6 random colors, so classes hold adjacent vertices."""
    g, pg, _ = _part(case)
    if valid:
        order = T.compute_order(pg, T.ordering.NATURAL)
        cfg = T.ColorConfig(max_colors=MC, superstep=32, tile=TILE,
                            scheme="allgather",
                            distance=1 if case == "d1" else 2)
        return T.color_graph_sim(pg, order, cfg, device="cpu")[0]
    gen = np.random.default_rng(3)
    view = gen.integers(1, 7, (pg.P, pg.n_slots)).astype(np.int32)
    view[:, -1] = 0
    return torch.from_numpy(view)


@pytest.mark.parametrize("start", ["zeros", "random"])
@pytest.mark.parametrize("valid", [True, False], ids=["valid", "invalid"])
@pytest.mark.parametrize("case", ["d1", "d2"])
def test_recolor_run_equals_chunk_loop(case, valid, start):
    """All classes in one call, several of them in more than one chunk,
    equal the per-chunk loop — from an empty view (as an iteration starts)
    or from any view, and on an invalid seed, whose classes are not
    independent sets."""
    _, pg, arrs = _part(case)
    chunk = CHUNK[case]
    sched = _schedule(case, _seed_view(case, valid), chunk)
    assert sched.n_classes >= 3 and max(sched.class_chunks.tolist()) >= 2
    view0 = (torch.zeros((pg.P, pg.n_slots), dtype=torch.int32)
             if start == "zeros" else
             _random_view(pg, np.random.default_rng(8)))
    nbrs = _nbrs(case, arrs)
    want = _chunk_loop(view0.clone(), nbrs, sched, 1, sched.n_classes, chunk)
    fn = ops.recolor_run if case == "d1" else ops.recolor_run_d2
    got = fn(view0.clone(), *nbrs, sched.sorted_pad, sched.start_local,
             sched.local_sizes, sched.class_chunks, first_class=1,
             last_class=sched.n_classes, chunk=chunk, max_colors=MC)
    assert torch.equal(got, want)
    # the same classes cut into runs of two
    view = view0.clone()
    for first in range(1, sched.n_classes + 1, 2):
        fn(view, *nbrs, sched.sorted_pad, sched.start_local,
           sched.local_sizes, sched.class_chunks, first_class=first,
           last_class=min(first + 1, sched.n_classes), chunk=chunk,
           max_colors=MC)
    assert torch.equal(view, want)


def test_run_entry_points_reject_what_they_cannot_run():
    _, pg, arrs = _part("d1")
    t = _spec_inputs("d1", 1, 20)
    kw = dict(first_step=0, n_steps=1, superstep=20, tile=8, max_colors=MC)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.select_run(t["view"], t["order_pad"], arrs["nbr"], t["rand"],
                       backend="cuda", **kw)
    with pytest.raises(TypeError, match="int32"):
        ops.select_run(t["view"].long(), t["order_pad"], arrs["nbr"],
                       t["rand"], **kw)
    with pytest.raises(ValueError, match="draws"):
        ops.select_run(t["view"], t["order_pad"], arrs["nbr"], None,
                       selection="random_x", **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.select_run(t["view"], t["order_pad"], arrs["nbr"], t["rand"],
                       **dict(kw, max_colors=100))
    sched = _schedule("d1", _seed_view("d1", True), 6)
    with pytest.raises(ValueError, match="n_local_max \\+ chunk"):
        ops.recolor_run(t["view"], arrs["nbr"], sched.sorted_pad,
                        sched.start_local, sched.local_sizes,
                        sched.class_chunks, first_class=1, last_class=1,
                        chunk=7, max_colors=MC)
    assert ops.SELECT_RUN.launches == 0 and ops.SELECT_RUN_D2.launches == 0


# -- against the reference ---------------------------------------------------

@lru_cache(maxsize=None)
def _ref_parts(case):
    """(reference partition, port partition, graph) of ``case``."""
    R = pytest.importorskip("repro.core")
    if case == "d1":
        g_ref, g = R.rmat.rmat_good(8, 8, seed=1), T.rmat.rmat_good(8, 8,
                                                                   seed=1)
        return R.partition_graph(g_ref, 4), T.partition_graph(g, 4), g
    g_ref, g = R.rmat.grid3d(6, 6, 6), T.rmat.grid3d(6, 6, 6)
    return (R.partition_graph(g_ref, 4, halo=2),
            T.partition_graph(g, 4, halo=2), g)


# (case, selection, x, exchange_every, clamping superstep)
REF_COLOR = [
    ("d1", "random_x", 40, 3, True),
    ("d1", "staggered", 0, 1, True),
    ("d2", "random_x", 5, 3, False),
    ("partial_d2", "first_fit", 0, 1, True),
]


@pytest.mark.parametrize("case,sel,x,every,clamp", REF_COLOR)
def test_color_graph_sim_matches_reference(case, sel, x, every, clamp):
    """The speculative coloring, now one ``select_run`` call per run of
    supersteps, equals the reference's bit for bit (view and stats, wire
    bytes and exchanges included)."""
    jax = pytest.importorskip("jax")
    R = pytest.importorskip("repro.core")
    pr, pt, g = _ref_parts("d1" if case == "d1" else "d2")
    S = _clamping_superstep(pt.n_local_max, TILE) if clamp else 32
    kw = dict(max_colors=MC, superstep=S, tile=TILE, selection=sel,
              random_x=x, exchange_every=every, scheme="sparse",
              distance=1 if case == "d1" else 2,
              partial=case == "partial_d2")
    order = R.compute_order(pr, R.ordering.NATURAL)
    marked = None
    if case == "partial_d2":
        marked = np.zeros((pt.P, pt.n_local_max), bool)
        for p in range(pt.P):
            nl, lo = int(pt.n_local[p]), int(pt.offs[p])
            marked[p, :nl] = np.arange(lo, lo + nl) % 2 == 0
    with jax.threefry_partitionable(True):
        vr, sr = R.color_graph_sim(pr, order, R.ColorConfig(**kw),
                                   marked=marked)
    vt, st = T.color_graph_sim(pt, order, T.ColorConfig(**kw), marked=marked,
                               device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    assert st["n_exchanges"] > 0


@pytest.mark.parametrize("case", ["d1", "d2"])
def test_recolor_invalid_seed_matches_reference(case):
    """One ND iteration from an invalid seed (adjacent vertices share a
    class): the in-order chunk runs give the reference's view and stats."""
    jax = pytest.importorskip("jax")
    R = pytest.importorskip("repro.core")
    pr, pt, _ = _ref_parts(case)
    seed = _seed_view(case, valid=False)
    kw = dict(max_colors=MC, chunk=CHUNK[case], scheme="sparse",
              distance=1 if case == "d1" else 2)
    vr, sr = R.recolor_sim(pr, seed.numpy(), R.ND, R.RecolorConfig(**kw),
                           key=jax.random.key(0))
    vt, st = T.recolor_sim(pt, seed, T.ND, T.RecolorConfig(**kw),
                           device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr


# -- the run kernels on the card ---------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sel,x", SELECTIONS)
@pytest.mark.parametrize("case", CASES)
def test_cuda_select_run_matches_plain(cuda_device, case, sel, x):
    _, pg, _ = _part(case)
    S = _clamping_superstep(pg.n_local_max, TILE)
    n_steps = -(-pg.n_local_max // S)
    kw = dict(first_step=0, n_steps=n_steps, superstep=S, tile=TILE,
              selection=sel, x=x)
    on = lambda t: {k: v.to(cuda_device) for k, v in t.items()}
    got = on(_spec_inputs(case, 11, S))
    want = on(_spec_inputs(case, 11, S))
    launches = ops.SELECT_RUN.launches + ops.SELECT_RUN_D2.launches
    _select_run(case, got, backend="cuda", **kw)
    _select_run(case, want, backend="torch", **kw)
    torch.cuda.synchronize()
    assert ops.SELECT_RUN.launches + ops.SELECT_RUN_D2.launches == launches + 1
    assert torch.equal(got["view"], want["view"])


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [True, False], ids=["valid", "invalid"])
@pytest.mark.parametrize("case", ["d1", "d2"])
def test_cuda_recolor_run_matches_plain(cuda_device, case, valid):
    _, pg, arrs = _part(case)
    sched = _schedule(case, _seed_view(case, valid), CHUNK[case])
    nbrs = tuple(n.to(cuda_device) for n in _nbrs(case, arrs))
    args = [t.to(cuda_device) for t in (sched.sorted_pad, sched.start_local,
                                        sched.local_sizes,
                                        sched.class_chunks)]
    fn = ops.recolor_run if case == "d1" else ops.recolor_run_d2
    view0 = _random_view(pg, np.random.default_rng(8)).to(cuda_device)
    out = {}
    for backend in ("cuda", "torch"):
        out[backend] = fn(view0.clone(), *nbrs, *args, first_class=1,
                          last_class=sched.n_classes, chunk=CHUNK[case],
                          max_colors=MC,
                          backend=backend)
    torch.cuda.synchronize()
    assert torch.equal(out["cuda"], out["torch"])


@pytest.mark.cuda
@pytest.mark.parametrize("sel,x", [("first_fit", 0), ("random_x", 40)])
@pytest.mark.parametrize("d2", [False, True], ids=["d1", "d2"])
def test_cuda_runs_read_wide_rows_to_their_first_sentinel(cuda_device, d2,
                                                          sel, x):
    """ELL rows wider than one round of the kernel's id loads (300, and
    300 + 70 at distance 2) are read only up to their first sentinel: the
    run kernels against their plain versions on synthetic arrays whose
    degrees span 0 to the full width."""
    gen = np.random.default_rng(21)
    P, n_local, n_ghost, chunk = 3, 40, 400, 8
    n_slots = n_local + n_ghost + 1
    sentinel = n_slots - 1

    def ell(width):
        deg = gen.integers(0, width + 1, (P, n_local))
        deg[:, :3] = [0, 33, width]
        ids = gen.integers(0, sentinel, (P, n_local, width))
        return torch.from_numpy(np.where(np.arange(width) < deg[..., None],
                                         ids, sentinel).astype(np.int32))

    nbrs = (ell(300), ell(70)) if d2 else (ell(300),)
    view0 = gen.integers(1, MC + 4, (P, n_slots)).astype(np.int32)
    view0[gen.random(view0.shape) < 0.5] = 0
    view0[:, :n_local] = 0
    view0[:, -1] = 0
    S = 24
    order = np.full((P, n_local + S), -1, np.int32)
    for p in range(P):
        order[p, :n_local] = gen.permutation(n_local)
    rand = gen.integers(-2**31, 2**31, (P, n_local), dtype=np.int64)
    on = lambda a: torch.as_tensor(a).to(cuda_device)
    nbrs = tuple(on(n) for n in nbrs)
    spec = ops.select_run_d2 if d2 else ops.select_run
    got = {}
    for backend in ("cuda", "torch"):
        got[backend] = spec(on(view0), on(order), *nbrs,
                            on(rand.astype(np.int32)), None, first_step=0,
                            n_steps=-(-n_local // S), superstep=S, tile=TILE,
                            max_colors=MC, selection=sel, x=x,
                            backend=backend)
    # recolor: two classes of 20 rows, three chunks of 8 each
    sorted_pad = np.zeros((P, n_local + chunk), np.int32)
    for p in range(P):
        sorted_pad[p, :n_local] = gen.permutation(n_local)
    start = np.tile(np.array([0, 0, 20], np.int32), (P, 1))
    sizes = np.tile(np.array([0, 20, 20], np.int32), (P, 1))
    sched = [on(a) for a in (sorted_pad, start, sizes,
                             np.array([0, 3, 3], np.int32))]
    recolor = ops.recolor_run_d2 if d2 else ops.recolor_run
    for backend in ("cuda", "torch"):
        got[backend] = recolor(got[backend], *nbrs, *sched, first_class=1,
                               last_class=2, chunk=chunk, max_colors=MC,
                               backend=backend)
    torch.cuda.synchronize()
    assert torch.equal(got["cuda"], got["torch"])
