"""The lane forms of the frontier and recolor-run entry points: a batch of
L same-shape graphs laid end to end on the shard axis (``color_many``'s
buckets).

``ops.detect_conflicts_frontier[_d2](..., lanes=L)`` counts losers and
boundary losers per lane, ``(L,)``; ``ops.recolor_run[_d2]`` reads
``class_chunks`` ``(L, n_cls)`` by the shard's lane.  On the CPU (plain
versions) each lane's result must equal the same call on that lane's
shards alone (view bitwise, counts exactly); the ``cuda`` cases hold the
kernels against the plain versions on the card (``python -m pytest -m
cuda tests/test_torch_lane_kernels.py`` on the GPU machine).  Inputs: two
rmat graphs (scale 7, P=4) and two ``grid3d`` blocks (halo 2, P=2), each
pair padded to one shape (``pad_partition``), views and orders seeded
from numpy.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch import rng
from repro_torch.core import recolor as T_recolor
from repro_torch.kernels import ops

MC = 256
S = 16            # frontier superstep
CHUNK = 8         # recolor chunk: several chunks per class
CASES = ["d1", "d2"]


@lru_cache(maxsize=None)
def _bucket(case):
    """(bucket, its (L·P, …) device arrays on the CPU)."""
    if case == "d1":
        pgs = [T.partition_graph(T.rmat.rmat_good(7, 8, seed=s), 4)
               for s in (1, 2)]
    else:
        pgs = [T.partition_graph(T.rmat.grid3d(6, 6, n), 2, halo=2)
               for n in (6, 5)]
    dims = ("n_local_max", "max_ghost", "max_boundary", "m_local_max",
            "maxd", "maxd2")
    wide = {d: max(getattr(pg, d) for pg in pgs) for d in dims}
    bucket = T.GraphBucket(indices=(0, 1), members=tuple(
        T.pad_partition(pg, **wide) for pg in pgs))
    return bucket, T.bucket_to_device(bucket, "cpu", sparse=False)


def _nbrs(case, arrs):
    return (arrs["nbr"], arrs["nbr2"]) if case == "d2" else (arrs["nbr"],)


def _lane(a, lane, P):
    return a[lane * P:(lane + 1) * P]


def _frontier_inputs(case, seed):
    """A planted view (few colors: many conflicts), the Internal-First
    order of each member, and a per-shard frontier size (one shard 0)."""
    bucket, arrs = _bucket(case)
    gen = np.random.default_rng(seed)
    LP, n_slots = arrs["prio"].shape
    view = gen.integers(0, 5, (LP, n_slots)).astype(np.int32)
    view[:, -1] = 0
    order = np.concatenate([T.compute_order(m, T.ordering.INTERNAL_FIRST)
                            for m in bucket.members])
    n_need = gen.integers(0, order.shape[1] + 1, LP)
    n_need[1] = 0
    n_steps = -(-order.shape[1] // S)
    pad = np.full((LP, n_steps * S - order.shape[1]), -1, np.int32)
    return (torch.from_numpy(view), torch.from_numpy(np.hstack([order, pad])),
            torch.from_numpy(n_need), n_steps)


def _frontier(case, arrs, view, order, n_need, n_steps, lanes, backend):
    fn = (ops.detect_conflicts_frontier_d2 if case == "d2"
          else ops.detect_conflicts_frontier)
    return fn(view, arrs["prio"], arrs["is_internal"], order,
              *_nbrs(case, arrs), n_need, n_steps=n_steps, superstep=S,
              lanes=lanes, backend=backend)


@pytest.mark.parametrize("case", CASES)
def test_frontier_lanes_equal_each_lane_alone(case):
    bucket, arrs = _bucket(case)
    P = bucket.P
    view, order, n_need, n_steps = _frontier_inputs(case, 3)
    new_view, n_conf, bnd = _frontier(case, arrs, view, order, n_need,
                                      n_steps, 2, "torch")
    assert n_conf.shape == (2,) and bnd.shape == (2,)
    assert int(n_conf.min()) > 0                  # both lanes have losers
    for lane in range(2):
        one = {k: _lane(v, lane, P) for k, v in arrs.items()}
        want = _frontier(case, one, _lane(view, lane, P),
                         _lane(order, lane, P), _lane(n_need, lane, P),
                         n_steps, None, "torch")
        assert torch.equal(_lane(new_view, lane, P), want[0])
        assert int(n_conf[lane]) == int(want[1])
        assert bool(bnd[lane]) == bool(want[2])
    # the one-lane form returns scalars, the sum and OR of the lanes
    solo = _frontier(case, arrs, view, order, n_need, n_steps, None, "torch")
    assert solo[1].dim() == 0 and int(solo[1]) == int(n_conf.sum())
    assert bool(solo[2]) == bool(bnd.any())
    with pytest.raises(ValueError):
        _frontier(case, arrs, view, order, n_need, n_steps, 3, "torch")


def _schedule(case, seed):
    """A random (invalid) seed view and its per-lane ND recolor schedule:
    lane 1 has fewer and smaller classes than lane 0."""
    bucket, arrs = _bucket(case)
    P = bucket.P
    gen = np.random.default_rng(seed)
    LP, n_slots = arrs["prio"].shape
    view = np.zeros((LP, n_slots), np.int32)
    view[:P] = gen.integers(1, 9, (P, n_slots))
    view[P:] = gen.integers(1, 4, (P, n_slots))
    view[:, -1] = 0
    view = torch.from_numpy(view)
    cfg = T.RecolorConfig(max_colors=MC, chunk=CHUNK, scheme="allgather",
                          distance=2 if case == "d2" else 1)
    sizes, _ = T_recolor.class_sizes(view, arrs["n_local"],
                                     bucket.members[0].n_local_max, MC,
                                     lanes=2)
    rank = T_recolor.permutation_rank(sizes, T.ND)
    sched = T_recolor.recolor_schedule(arrs, view, rank,
                                       (sizes > 0).sum(dim=1), cfg, 0)
    assert sched.n_classes[0] > sched.n_classes[1]
    return sched


def _recolor(case, arrs, sched, class_chunks, first, last, backend, view0):
    fn = ops.recolor_run_d2 if case == "d2" else ops.recolor_run
    return fn(view0, *_nbrs(case, arrs), sched.sorted_pad, sched.start_local,
              sched.local_sizes, class_chunks, first_class=first,
              last_class=last, chunk=CHUNK, max_colors=MC, backend=backend)


@pytest.mark.parametrize("case", CASES)
def test_recolor_run_lane_chunks_equal_each_lane_alone(case):
    bucket, arrs = _bucket(case)
    P = bucket.P
    sched = _schedule(case, 5)
    chunks = sched.class_chunks
    assert chunks.shape[0] == 2 and int(chunks.max()) >= 2
    last = sched.n_classes[0]
    zeros = lambda: torch.zeros_like(arrs["prio"], dtype=torch.int32)
    got = _recolor(case, arrs, sched, chunks, 1, last, "torch", zeros())
    for lane in range(2):
        one = {k: _lane(v, lane, P) for k, v in arrs.items()}
        one_sched = type(sched)(
            n_classes=[sched.n_classes[lane]], needed=None,
            needed_rounds=None, sorted_pad=_lane(sched.sorted_pad, lane, P),
            start_local=_lane(sched.start_local, lane, P),
            local_sizes=_lane(sched.local_sizes, lane, P),
            class_chunks=chunks[lane:lane + 1])
        want = _recolor(case, one, one_sched, chunks[lane], 1, last, "torch",
                        torch.zeros_like(one["prio"], dtype=torch.int32))
        assert torch.equal(_lane(got, lane, P), want)
    # a lane's chunks past its class sizes color nothing: the union
    # counts give the same view
    union = chunks.amax(dim=0)
    assert torch.equal(
        _recolor(case, arrs, sched, union, 1, last, "torch", zeros()), got)


# -- the lane forms on the card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _on(arrs, dev):
    return {k: v.to(dev) for k, v in arrs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_frontier_lanes_match_plain(cuda_device, case):
    _, arrs = _bucket(case)
    view, order, n_need, n_steps = _frontier_inputs(case, 4)
    on = _on(arrs, cuda_device)
    args = [t.to(cuda_device) for t in (view, order, n_need)]
    kernel = (ops.CONFLICT_FRONTIER_D2 if case == "d2"
              else ops.CONFLICT_FRONTIER)
    before = kernel.launches
    got = _frontier(case, on, *args, n_steps, 2, "cuda")
    assert kernel.launches == before + 1
    want = _frontier(case, on, *args, n_steps, 2, "torch")
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_recolor_run_lane_chunks_match_plain(cuda_device, case):
    _, arrs = _bucket(case)
    sched = _schedule(case, 6)
    on = _on(arrs, cuda_device)
    dev_sched = type(sched)(
        n_classes=sched.n_classes, needed=None, needed_rounds=None,
        **{k: getattr(sched, k).to(cuda_device) for k in (
            "sorted_pad", "start_local", "local_sizes", "class_chunks")})
    zeros = lambda: torch.zeros_like(on["prio"], dtype=torch.int32)
    last = sched.n_classes[0]
    got = _recolor(case, on, dev_sched, dev_sched.class_chunks, 1, last,
                   "cuda", zeros())
    want = _recolor(case, on, dev_sched, dev_sched.class_chunks, 1, last,
                    "torch", zeros())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("distance", [1, 2])
def test_cuda_color_many_matches_cpu(cuda_device, distance):
    """A whole batch on the card equals the plain run on the CPU, lane by
    lane, and launches each lane-batched kernel fewer times than the
    lanes' solo runs together."""
    if distance == 1:
        pgs = [T.partition_graph(T.rmat.rmat_good(8, 8, seed=s), 4)
               for s in (1, 2, 3)]
    else:
        pgs = [T.partition_graph(T.rmat.grid3d(8, 8, n), 4, halo=2)
               for n in (8, 6)]
    cfg = T.PipelineConfig(
        color=T.ColorConfig(max_colors=MC, superstep=64, tile=16,
                            selection="random_x", distance=distance),
        recolor=T.RecolorConfig(max_colors=MC, distance=distance),
        n_iters=3)
    buckets = [T.GraphBucket(indices=tuple(range(len(pgs))), members=tuple(
        T.pad_partition(pg, **{d: max(getattr(q, d) for q in pgs) for d in (
            "n_local_max", "max_ghost", "max_boundary", "m_local_max",
            "maxd", "maxd2")}) for pg in pgs))]
    names = (("select_run_d2", "conflict_frontier_d2") if distance == 2
             else ("select_run", "conflict_frontier"))
    kernels = [k for k in ops.KERNELS if k.name in names]
    for k in kernels:
        k.reset()
    got = T.color_many(pgs, cfg, buckets=buckets, device=cuda_device)
    batched = {k.name: k.launches for k in kernels}
    want = T.color_many(pgs, cfg, buckets=buckets, device="cpu")
    solo = {k.name: 0 for k in kernels}
    for j, m in enumerate(buckets[0].members):
        for k in kernels:
            k.reset()
        T.pipeline_sim(m, T.compute_order(m, T.ordering.INTERNAL_FIRST),
                       T.bucket_signature(buckets[0], cfg).cfg,
                       color_key=rng.fold_in(rng.key(0), j),
                       recolor_key=rng.fold_in(rng.key(0), j),
                       device=cuda_device)
        for k in kernels:
            solo[k.name] += k.launches
    for a, b in zip(got, want):
        assert torch.equal(a["view"].cpu(), b["view"])
        assert a["history"] == b["history"] and a["color"] == b["color"]
    for name in names:
        assert 0 < batched[name] < solo[name], (batched, solo)
