"""The sequential superstep coloring (``ColorConfig(parallel_chunk=False)``,
the paper's scalar loop, and every Least-Used run) against the reference,
and — on the GPU — the sequential kernels against their plain versions.

``ops.greedy_run[_d2]`` colors a run of supersteps one vertex at a time per
shard.  Its plain version (``kernels/ref.py:greedy_run``) is held to the
reference's ``_greedy_chunk`` run live on synthetic arrays (ELL rows wider
than 256 ids, planted saturated rows, pre-colored rows, -1 entries), and to
``ref.select_run`` at ``tile=1`` for the three tile strategies; the whole
coloring is held to ``repro.color_graph_sim`` at distance 1, 2 and partial
2.  Inputs come from seeded numpy; outputs are integer views, usage rows
and stats, tolerance 0.  The reference runs live under
``jax_threefry_partitionable=True``, set explicitly.  The ``cuda`` cases
(``python -m pytest -m cuda tests/test_torch_sequential.py`` on the GPU
machine; the reference cases skip there, having no jax) hold the kernels
to the plain versions on the same arrays.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import selection as sel
from repro_torch.kernels import ops
from test_torch_threads import one_torch_thread  # noqa: F401

MC = 64
SELECTIONS = [("first_fit", 0), ("staggered", 0), ("random_x", 5),
              ("least_used", 0)]
STAGGER = 24        # ColorConfig.stagger_estimate of the synthetic cases
S_SYN = 16          # superstep of the synthetic cases


def _synthetic(seed: int, d2: bool) -> dict:
    """Seeded arrays of 3 shards × 40 local rows, 400 ghosts: ELL rows of
    0 to 300 ids (two-hop rows 0 to 70) over local and ghost slots, ids
    first and then sentinel padding; ghost slots 40 … 101 hold colors 1 …
    62, so row 3 (those 62 ids) is saturated and row 4 (61 of them) has
    only color 62 left; a fifth of the local rows pre-colored; order
    entries with -1 holes and superstep padding; usage rows of 0 … 3."""
    gen = np.random.default_rng(seed)
    P, n_local, n_ghost = 3, 40, 400
    n_slots = n_local + n_ghost + 1
    sentinel = n_slots - 1

    def ell(width, planted):
        deg = gen.integers(0, width + 1, (P, n_local))
        ids = gen.integers(0, sentinel, (P, n_local, width))
        if planted:
            deg[:, :5] = [0, 33, width, 62, 61]
            ids[:, 3, :62] = n_local + np.arange(62)
            ids[:, 4, :61] = n_local + np.arange(61)
        return np.where(np.arange(width) < deg[..., None], ids,
                        sentinel).astype(np.int32)

    view = gen.integers(1, MC + 4, (P, n_slots)).astype(np.int32)
    view[gen.random(view.shape) < 0.5] = 0
    view[:, n_local:n_local + 62] = np.arange(1, 63)
    view[:, :n_local] = np.where(gen.random((P, n_local)) < 0.2,
                                 gen.integers(1, MC, (P, n_local)), 0)
    view[:, :5] = 0
    view[:, -1] = 0
    order = np.full((P, n_local + S_SYN), -1, np.int32)
    for p in range(P):
        order[p, :n_local] = gen.permutation(n_local)
    order[order == 10] = -1
    usage = gen.integers(0, 4, (P, MC)).astype(np.int32)
    usage[:, 0] = 0
    out = dict(view=view, order=order, usage=usage,
               nbr=ell(300, True),
               rand=gen.integers(-2**31, 2**31, (P, n_local),
                                 dtype=np.int64).astype(np.int32),
               offset=(np.arange(P) * STAGGER % MC).astype(np.int32))
    if d2:
        out["nbr2"] = ell(70, False)
    return out


def _greedy(a: dict, selection: str, x: int, backend="torch", device="cpu",
            n_steps=None):
    """``ops.greedy_run[_d2]`` over the synthetic arrays ``a``; returns
    (view, usage) on the CPU."""
    on = lambda k: torch.from_numpy(a[k].copy()).to(device)
    nbrs = (on("nbr"), on("nbr2")) if "nbr2" in a else (on("nbr"),)
    fn = ops.greedy_run_d2 if "nbr2" in a else ops.greedy_run
    n_local = a["nbr"].shape[1]
    n_steps = -(-n_local // S_SYN) if n_steps is None else n_steps
    view, usage = fn(on("view"), on("usage"), on("order"), *nbrs, on("rand"),
                     on("offset"), first_step=0, n_steps=n_steps,
                     superstep=S_SYN, max_colors=MC, selection=selection,
                     x=x, backend=backend)
    return view.cpu(), usage.cpu()


# -- the plain version against the reference's _greedy_chunk ----------------

def _ref_greedy(a: dict, selection: str, x: int):
    """The reference's ``_greedy_chunk`` shard by shard on the same arrays,
    its one-hop row as CSR (the ids before the first sentinel)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    R = pytest.importorskip("repro.core")
    from repro.core import speculative as R_spec
    sentinel = a["view"].shape[1] - 1
    d2 = "nbr2" in a
    cfg = R.ColorConfig(max_colors=MC, selection=selection, random_x=x,
                        stagger_estimate=STAGGER, distance=2 if d2 else 1,
                        parallel_chunk=False)
    n_local = a["nbr"].shape[1]
    count = -(-n_local // S_SYN) * S_SYN
    fn = jax.jit(lambda view, usage, order, rand, arrs, p:
                 R_spec._greedy_chunk(view, usage, order, rand, 0, count,
                                      arrs, p, cfg))
    views, usages = [], []
    for p in range(a["view"].shape[0]):
        rows = [r[r != sentinel] for r in a["nbr"][p]]
        arrs = dict(indptr=jnp.asarray(np.cumsum([0] + [len(r) for r in rows]),
                                       jnp.int32),
                    indices=jnp.asarray(np.concatenate(rows), jnp.int32))
        if d2:
            arrs["nbr2"] = jnp.asarray(a["nbr2"][p])
        v, u = fn(jnp.asarray(a["view"][p]), jnp.asarray(a["usage"][p]),
                  jnp.asarray(a["order"][p]),
                  jnp.asarray(a["rand"][p].view(np.uint32)), arrs,
                  jnp.int32(p))
        views.append(np.asarray(v))
        usages.append(np.asarray(u))
    return np.stack(views), np.stack(usages)


@pytest.mark.parametrize("d2", [False, True], ids=["d1", "d2"])
@pytest.mark.parametrize("selection,x", SELECTIONS)
def test_plain_greedy_run_matches_reference_greedy_chunk(selection, x, d2):
    a = _synthetic(5, d2)
    view, usage = _greedy(a, selection, x)
    want_view, want_usage = _ref_greedy(a, selection, x)
    np.testing.assert_array_equal(view.numpy(), want_view)
    np.testing.assert_array_equal(usage.numpy(), want_usage)
    # the planted rows: saturated (capped at the sentinel color) and one
    # color left
    assert (view[:, 3] == MC - 1).all() and (view[:, 4] == MC - 2).all()


@pytest.mark.parametrize("selection,x", SELECTIONS[:3])
def test_plain_greedy_run_equals_select_run_at_tile_1(selection, x):
    """One vertex per tile is the sequential loop: every tile reads the
    view as the previous one left it."""
    a = _synthetic(6, False)
    view, _ = _greedy(a, selection, x)
    on = lambda k: torch.from_numpy(a[k].copy())
    want = ops.select_run(on("view"), on("order"), on("nbr"), on("rand"),
                          on("offset"), first_step=0,
                          n_steps=-(-a["nbr"].shape[1] // S_SYN),
                          superstep=S_SYN, tile=1, max_colors=MC,
                          selection=selection, x=x, backend="torch")
    assert torch.equal(view, want)


def test_plain_greedy_run_counts_every_color_in_usage():
    a = _synthetic(7, False)
    view, usage = _greedy(a, "first_fit", 0)
    colored = (view != torch.from_numpy(a["view"]))[:, :a["nbr"].shape[1]]
    counts = torch.zeros_like(usage)
    counts.scatter_add_(1, view[:, :colored.shape[1]].long(),
                        colored.to(torch.int32))
    assert torch.equal(usage - torch.from_numpy(a["usage"]), counts)


# -- cases that stress the kernels' split of the in-order chain ---------------
#
# The CUDA kernels read everything that cannot change within a launch ahead
# of the vertex's turn (producer warps) and only the local neighbours'
# colors at it (consumer warp), from a per-slot list of local ids.  These
# arrays plant what that split has to get right; the plain version is held
# to the reference's _greedy_chunk on them here, the kernels to the plain
# version on the card below.

STRESS = [("chain", False), ("self_and_repeats", False),
          ("wide_local", False), ("wide_local", True),
          ("mostly_colored", False), ("two_hop_local", True)]


def _stress(case: str, d2: bool, seed: int = 21) -> dict:
    """Seeded arrays of 2 shards × 48 local rows, 64 ghosts, MC colors:

    - ``chain``: each vertex's row lists the vertices just before and just
      after it in the visit order (v1–v2–v3 … at consecutive positions),
      so its local neighbours come both earlier and later in the launch;
    - ``self_and_repeats``: each row lists its own vertex twice, one local
      id three times and one ghost id three times;
    - ``wide_local``: rows of 140–300 ids, nine in ten local (repeats), so
      most rows list more local ids than a slot holds
      (``ops._GREEDY_LIST``); at distance 2 split over both rows;
    - ``mostly_colored``: nine in ten local vertices colored before the run,
      so most positions are dropped;
    - ``two_hop_local``: two-hop rows of local ids only.

    Ghost slots hold colors 0 … MC + 3 (those >= MC ignored); the view's
    other local slots are 0; order entries with -1 holes and superstep
    padding; usage rows of 0 … 3."""
    gen = np.random.default_rng(seed)
    P, n_local, n_ghost = 2, 48, 64
    n_slots = n_local + n_ghost + 1
    sentinel = n_slots - 1
    local = lambda *shape: gen.integers(0, n_local, shape)
    ghost = lambda *shape: gen.integers(n_local, sentinel, shape)
    order = np.full((P, n_local + S_SYN), -1, np.int32)
    for p in range(P):
        order[p, :n_local] = gen.permutation(n_local)
    order[:, 7] = -1

    def ell(width, lo, hi, local_share):
        deg = gen.integers(lo, hi + 1, (P, n_local))
        ids = np.where(gen.random((P, n_local, width)) < local_share,
                       local(P, n_local, width), ghost(P, n_local, width))
        return deg, ids

    width = 300 if case == "wide_local" else 24
    if case == "wide_local":
        deg, ids = ell(width, 140, 300, 0.9)
    else:
        deg, ids = ell(width, 0, 12, 0.5)
    for p in range(P):
        seq = order[p, :n_local]
        for i, v in enumerate(seq):
            if v < 0:
                continue
            if case == "chain":
                before = seq[i - 1] if i > 0 and seq[i - 1] >= 0 else v
                after = seq[i + 1] if i + 1 < n_local and seq[i + 1] >= 0 \
                    else v
                ids[p, v, :2] = [before, after]
                deg[p, v] = max(deg[p, v], 2)
            elif case == "self_and_repeats":
                u, g = local(), ghost()
                ids[p, v, :8] = [v, u, g, v, u, g, u, g]
                deg[p, v] = max(deg[p, v], 8)
    nbr = np.where(np.arange(width) < deg[..., None], ids,
                   sentinel).astype(np.int32)
    view = gen.integers(0, MC + 4, (P, n_slots)).astype(np.int32)
    view[:, :n_local] = 0
    if case == "mostly_colored":
        pre = gen.random((P, n_local)) < 0.9
        view[:, :n_local] = np.where(pre, gen.integers(1, MC, (P, n_local)),
                                     0)
    view[:, -1] = 0
    usage = gen.integers(0, 4, (P, MC)).astype(np.int32)
    usage[:, 0] = 0
    out = dict(view=view, order=order, usage=usage, nbr=nbr,
               rand=gen.integers(-2**31, 2**31, (P, n_local),
                                 dtype=np.int64).astype(np.int32),
               offset=(np.arange(P) * STAGGER % MC).astype(np.int32))
    if d2:
        w2 = 70
        share = 1.0 if case == "two_hop_local" else 0.9
        lo = 60 if case == "wide_local" else 0
        deg2, ids2 = ell(w2, lo, w2, share)
        out["nbr2"] = np.where(np.arange(w2) < deg2[..., None], ids2,
                               sentinel).astype(np.int32)
    return out


def _n_local_ids(a: dict) -> np.ndarray:
    """Local ids per row (both rows at distance 2), repeats counted."""
    n_local = a["nbr"].shape[1]
    rows = [a["nbr"]] + ([a["nbr2"]] if "nbr2" in a else [])
    return sum((r < n_local).sum(-1) for r in rows)


@pytest.mark.parametrize("selection,x", SELECTIONS)
@pytest.mark.parametrize("case,d2", STRESS)
def test_plain_greedy_run_matches_reference_on_stress_rows(case, d2,
                                                           selection, x):
    a = _stress(case, d2)
    if case == "wide_local":
        assert (_n_local_ids(a) > ops._GREEDY_LIST).mean() > 0.5
    view, usage = _greedy(a, selection, x)
    want_view, want_usage = _ref_greedy(a, selection, x)
    np.testing.assert_array_equal(view.numpy(), want_view)
    np.testing.assert_array_equal(usage.numpy(), want_usage)
    n_local = a["nbr"].shape[1]
    live = (a["order"][:, :n_local] >= 0).sum()
    if case == "mostly_colored":
        assert 0 < int((view != torch.from_numpy(a["view"])).sum()) < live / 4
    else:   # every listed vertex but the -1 hole is colored
        assert int((view[:, :n_local] > 0).sum()) == live


def test_greedy_layout_follows_the_shapes():
    """The instantiation of the sequential kernels is chosen from the
    shapes alone, and its shared memory (``greedy_smem_bytes`` of
    ``greedy_run.cuh``) never passes the budget."""
    def smem(variant, ring, list_cap, n_local_max, mc):
        local = (n_local_max + 1) // 2 if variant == "shared" else 0
        return 4 * (mc + ops._GREEDY_CONTROL
                    + ring * (ops._SLOT_HEADER + mc // 32 + list_cap) + local)

    budget = ops._GREEDY_SMEM
    cases = [(16384, 1024, "shared"),      # D1 main path: 64 shards
             (2048, 1024, "shared"),       # D2 grid3d(32^3) on 16 shards
             (40, 64, "shared"),
             (1 << 20, 1024, "device"),    # one shard at scale 20
             (110000, 1024, "device"),
             (100000, 1024, "shared"),
             (16384, 56320, "device")]     # the widest bitset accepted
    for n_local_max, mc, want in cases:
        variant, ring, list_cap = ops._greedy_layout(n_local_max, mc)
        assert variant == want, (n_local_max, mc)
        assert 1 <= ring <= ops._GREEDY_RING and 0 <= list_cap
        assert smem(variant, ring, list_cap, n_local_max, mc) <= budget
        if variant == "shared":
            assert ring >= ops._GREEDY_MIN_RING
            assert list_cap == ops._GREEDY_LIST
    assert ops._greedy_layout(16384, 1024) == ("shared", 128, 128)
    # a lower budget moves the same shapes to device memory, then shrinks
    # the ring, then the id list of its one slot
    ctl = ops._GREEDY_CONTROL
    assert ops._greedy_layout(40, 64, budget=4096) == ("device", 6, 128)
    assert ops._greedy_layout(40, 64, budget=4 * (64 + ctl + 5 + 2 + 10)) == (
        "device", 1, 10)
    with pytest.raises(ValueError, match="shared memory"):
        ops._greedy_layout(40, 64, budget=4 * (64 + ctl + 5 + 1))
    with pytest.raises(ValueError, match="shared memory"):
        ops._greedy_layout(40, 57344)


# -- the row-wise strategies against the reference's scalar ones -------------

@pytest.mark.parametrize("selection,x", SELECTIONS + [("random_x", 1)])
def test_row_strategies_match_reference(selection, x):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    R_sel = pytest.importorskip("repro.core.selection")
    gen = np.random.default_rng(11)
    rows = 64
    taken = gen.random((rows, MC)) < gen.random((rows, 1))
    taken[:4, :MC - 1] = True                   # saturated rows
    taken[4, :] = True
    taken[4, 40] = False                        # one free color
    taken[:, 0] = True
    usage = gen.integers(0, 3, (rows, MC)).astype(np.int32)
    usage[5] = 0                                # nothing open: first fit
    usage[6, MC - 1] = 9                        # the sentinel is open
    rand = gen.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)
    offset = gen.integers(0, MC, rows).astype(np.int32)
    bit = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (taken.reshape(rows, -1, 32) * bit).sum(-1).astype(np.uint32)
    fn = {"first_fit": lambda w, u, r, o: R_sel.first_fit(w),
          "staggered": lambda w, u, r, o: R_sel.staggered(w, o),
          "least_used": lambda w, u, r, o: R_sel.least_used(w, u),
          "random_x": lambda w, u, r, o: R_sel.random_x(w, x, r)}[selection]
    want = np.asarray(jax.vmap(fn)(jnp.asarray(words), jnp.asarray(usage),
                                   jnp.asarray(rand), jnp.asarray(offset)))
    t = torch.from_numpy(taken)
    got = {"first_fit": lambda: sel.find_first_zero(t),
           "staggered": lambda: sel.staggered(t, torch.from_numpy(offset)),
           "least_used": lambda: sel.least_used(t, torch.from_numpy(usage)),
           "random_x": lambda: sel.random_x(
               t, x, torch.from_numpy(rand.astype(np.int64)))}[selection]()
    np.testing.assert_array_equal(got.numpy(), want)


def test_least_used_details():
    """Only open colors, ties to the smaller color, never the sentinel, and
    first fit when nothing open is free."""
    taken = torch.zeros((4, 64), dtype=torch.bool)
    taken[:, 0] = True
    usage = torch.zeros((4, 64), dtype=torch.int32)
    usage[0, [5, 9, 12]] = torch.tensor([3, 2, 2], dtype=torch.int32)
    usage[1, 63] = 1                            # only the sentinel is open
    usage[2, 7] = 4
    taken[2, 7] = True                          # the open color is taken
    usage[3, [2, 3]] = 1
    taken[3, 1] = True
    assert sel.least_used(taken, usage).tolist() == [9, 1, 1, 2]


# -- the whole coloring against the reference --------------------------------

@lru_cache(maxsize=None)
def _parts(case: str, P: int):
    """(reference partition, port partition, Internal-First order, graph)."""
    R = pytest.importorskip("repro.core")
    if case == "d1":
        g_ref, g = R.rmat.rmat_good(9, 8, seed=3), T.rmat.rmat_good(9, 8,
                                                                   seed=3)
        pr, pt = R.partition_graph(g_ref, P), T.partition_graph(g, P)
    else:
        g_ref, g = R.rmat.grid3d(6, 6, 6), T.rmat.grid3d(6, 6, 6)
        pr = R.partition_graph(g_ref, P, halo=2)
        pt = T.partition_graph(g, P, halo=2)
    return pr, pt, R.compute_order(pr, R.ordering.INTERNAL_FIRST), g


def _color_both(case, P, selection, x, scheme, partial=False, **extra):
    jax = pytest.importorskip("jax")
    R = pytest.importorskip("repro.core")
    pr, pt, order, g = _parts("d1" if case == "d1" else "d2", P)
    kw = dict(max_colors=256, superstep=32, selection=selection, random_x=x,
              scheme=scheme, parallel_chunk=False,
              distance=1 if case == "d1" else 2, partial=partial, **extra)
    marked = None
    if partial:
        marked = np.zeros((pt.P, pt.n_local_max), bool)
        for p in range(pt.P):
            nl, lo = int(pt.n_local[p]), int(pt.offs[p])
            marked[p, :nl] = np.arange(lo, lo + nl) % 2 == 0
    with jax.threefry_partitionable(True):
        vr, sr = R.color_graph_sim(pr, order, R.ColorConfig(**kw),
                                   marked=marked)
    vt, st = T.color_graph_sim(pt, order, T.ColorConfig(**kw), marked=marked,
                               device="cpu")
    return (vr, sr), (vt, st), g, pt


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("selection,x", SELECTIONS)
def test_sequential_color_graph_sim_matches_reference(selection, x, scheme):
    (vr, sr), (vt, st), g, pt = _color_both("d1", 4, selection, x, scheme)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    assert st["n_exchanges"] > 0
    assert T.check_coloring(g, T.colors_from_views(pt, vt))["valid"]


def test_sequential_p16_bounded_staleness_matches_reference():
    (vr, sr), (vt, st), _, _ = _color_both("d1", 16, "least_used", 0,
                                           "sparse", exchange_every=3)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr


@pytest.mark.parametrize("case", ["d2", "partial_d2"])
@pytest.mark.parametrize("selection", ["first_fit", "least_used"])
def test_sequential_d2_matches_reference(case, selection):
    partial = case == "partial_d2"
    (vr, sr), (vt, st), g, pt = _color_both(case, 4, selection, 0, "sparse",
                                            partial=partial)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    colors = T.colors_from_views(pt, vt)
    marked = (np.arange(g.n) % 2 == 0) if partial else None
    assert T.check_coloring(g, colors, distance=2, marked=marked)["valid"]


def test_least_used_needs_no_parallel_chunk_flag():
    """Least-Used is sequential whatever ``parallel_chunk`` says."""
    assert not T.ColorConfig(selection="least_used").use_parallel_chunk
    assert not T.ColorConfig(parallel_chunk=False).use_parallel_chunk
    assert T.ColorConfig().use_parallel_chunk
    with pytest.raises(ValueError):
        ops.select_colors(torch.zeros((2, 3), dtype=torch.int32),
                          torch.ones(2, dtype=torch.bool), max_colors=64,
                          selection="least_used")


# -- the sequential kernels on the card ---------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d2", [False, True], ids=["d1", "d2"])
@pytest.mark.parametrize("selection,x", SELECTIONS)
def test_cuda_greedy_run_matches_plain(cuda_device, selection, x, d2):
    """Rows wider than 256 ids (read to their first sentinel), saturated
    and one-color-left rows, usage rows with closed colors."""
    a = _synthetic(5, d2)
    kernel = ops.GREEDY_RUN_D2 if d2 else ops.GREEDY_RUN
    launches = kernel.launches
    got = _greedy(a, selection, x, backend="cuda", device=cuda_device)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    want = _greedy(a, selection, x, backend="torch", device=cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_greedy_run_saturated_least_used(cuda_device):
    """Least-Used where every row is saturated or nearly: the usage of the
    sentinel color grows, and the sentinel is never handed out by
    Least-Used itself."""
    a = _synthetic(9, False)
    a["nbr"][:, 5:, :62] = a["nbr"][:, 3:4, :62]      # every row saturated
    a["usage"][:, MC - 1] = 1
    got = _greedy(a, "least_used", 0, backend="cuda", device=cuda_device)
    want = _greedy(a, "least_used", 0, backend="torch", device=cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][:, MC - 1].sum()) > a["view"].shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("first,n", [(1, 1), (0, 0)])
def test_cuda_greedy_run_partial_runs(cuda_device, first, n):
    """A run that starts past the first superstep, and an empty run."""
    a = _synthetic(10, True)
    on = lambda k: torch.from_numpy(a[k].copy()).to(cuda_device)
    out = {}
    for backend in ("cuda", "torch"):
        out[backend] = ops.greedy_run_d2(
            on("view"), on("usage"), on("order"), on("nbr"), on("nbr2"),
            on("rand"), None, first_step=first, n_steps=n, superstep=S_SYN,
            max_colors=MC, selection="random_x", x=3, backend=backend)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(out["cuda"], out["torch"]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d1", "d2"])
@pytest.mark.parametrize("selection", ["first_fit", "least_used"])
def test_cuda_sequential_coloring_matches_plain(cuda_device, case,
                                                selection):
    if case == "d1":
        g = T.rmat.rmat_good(9, 8, seed=3)
        pg = T.partition_graph(g, 4)
    else:
        g = T.rmat.grid3d(6, 6, 6)
        pg = T.partition_graph(g, 4, halo=2)
    order = T.compute_order(pg, T.ordering.INTERNAL_FIRST)
    out = {}
    for backend in ("cuda", "torch"):
        cfg = T.ColorConfig(max_colors=256, superstep=32, selection=selection,
                            parallel_chunk=False, backend=backend,
                            distance=1 if case == "d1" else 2)
        out[backend] = T.color_graph_sim(pg, order, cfg, device=cuda_device)
    assert torch.equal(out["cuda"][0], out["torch"][0])
    assert out["cuda"][1] == out["torch"][1]
    colors = T.colors_from_views(pg, out["cuda"][0])
    assert T.check_coloring(g, colors, distance=1 if case == "d1"
                            else 2)["valid"]


def _budget_for(variant: str) -> int | None:
    """A shared-memory budget that makes the stress shapes take
    ``variant``: the real one, a ring of 6 slots in device memory, or one
    slot listing 10 local ids."""
    return {"shared": None, "device": 4096,
            "device_one_slot": 4 * (MC + ops._GREEDY_CONTROL + 5 + MC // 32
                                    + 10)}[variant]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["shared", "device", "device_one_slot"])
@pytest.mark.parametrize("selection,x", SELECTIONS)
@pytest.mark.parametrize("case,d2", STRESS)
def test_cuda_greedy_run_stress_rows_match_plain(cuda_device, monkeypatch,
                                                 case, d2, selection, x,
                                                 variant):
    """Both instantiations (the local colors in shared or device memory;
    the budget is lowered to force the second) on the stress rows."""
    a = _stress(case, d2)
    budget = _budget_for(variant)
    if budget is not None:
        monkeypatch.setattr(ops, "_GREEDY_SMEM", budget)
    n_local = a["nbr"].shape[1]
    form = ops._greedy_layout(n_local, MC)[0]
    assert form == ("shared" if variant == "shared" else "device")
    kernel = ops.GREEDY_RUN_D2 if d2 else ops.GREEDY_RUN
    before = kernel.variants.get(form, 0)
    got = _greedy(a, selection, x, backend="cuda", device=cuda_device)
    torch.cuda.synchronize()
    assert kernel.variants[form] == before + 1
    want = _greedy(a, selection, x, backend="torch", device=cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d2", [False, True], ids=["d1", "d2"])
@pytest.mark.parametrize("selection,x", SELECTIONS)
def test_cuda_greedy_run_device_form_matches_plain(cuda_device, monkeypatch,
                                                   selection, x, d2):
    """The device-memory instantiation on the wide synthetic rows, its
    launch count rising."""
    a = _synthetic(5, d2)
    monkeypatch.setattr(ops, "_GREEDY_SMEM", 4096)
    kernel = ops.GREEDY_RUN_D2 if d2 else ops.GREEDY_RUN
    before = kernel.variants.get("device", 0)
    got = _greedy(a, selection, x, backend="cuda", device=cuda_device)
    torch.cuda.synchronize()
    assert kernel.variants["device"] == before + 1
    want = _greedy(a, selection, x, backend="torch", device=cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
