"""The recoloring loop's push exchange (``FlatExchange.push``,
``ops.exchange_push``) against the pull it replaces and the reference.

On one device ``recolor_steps`` pushes through a ``FlatExchange``; any
other exchange object pulls.  A ``FlatExchange`` seen through a wrapper
(``_Pull``) therefore runs the very same loop with the pull, so the two
paths can be held to each other: the view after every iteration, the
histories and the stats (``n_exchanges``, ``wire_bytes``) bit for bit,
and both to the reference's live run under
``jax_threefry_partitionable=True``.  ``cuda`` cases hold the kernel
against its plain version on the card (``python -m pytest -m cuda
tests/test_torch_exchange_push.py`` on the GPU).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import comm, pipeline
from repro_torch.core import recolor as T_recolor
from repro_torch.core.graph import view_from_numpy
from repro_torch.kernels import ops
from test_torch_threads import one_torch_thread  # noqa: F401

P = 4
N_ITERS = 2


class _Pull:
    """A ``FlatExchange`` behind a wrapper that forwards every attribute:
    not a ``FlatExchange``, so the recoloring loop pulls through it."""

    def __init__(self, real):
        self.real = real

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __call__(self, view, lanes=None, rounds=None):
        return self.real(view, lanes=lanes, rounds=rounds)


@contextlib.contextmanager
def _path(monkeypatch, pull: bool, module):
    """Run ``module``'s recoloring with the pull (``pull``) or the push;
    yields the count of pushes made."""
    pushes = [0]
    real_push = comm.FlatExchange.push

    def counted(self, *a, **k):
        pushes[0] += 1
        return real_push(self, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(comm.FlatExchange, "push", counted)
        if pull:
            make = module.make_exchange
            m.setattr(module, "make_exchange",
                      lambda *a, **k: _Pull(make(*a, **k)))
        yield pushes


@pytest.fixture
def reference():
    jax = pytest.importorskip("jax")
    R = pytest.importorskip("repro.core")
    with jax.threefry_partitionable(True):
        yield R


def _graph(M, distance):
    if distance == 1:
        return M.rmat.rmat_good(8, 8, seed=3), {}
    return M.rmat.grid3d(5, 5, 4), {"tile": 16}


def _iterations(M, pg, view, cfg, **kw):
    """``recolor_iterations`` with the view after every iteration."""
    views = []
    _, hist = M.recolor_iterations(
        pg, view, N_ITERS, cfg, seed=5,
        collect=lambda v, s: views.append(np.asarray(v).copy()), **kw)
    return views, hist


@pytest.mark.parametrize("wire16", [False, True])
@pytest.mark.parametrize("piggyback", [True, False])
@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("distance", [1, 2])
def test_push_iterations_equal_pull_and_reference(
        reference, monkeypatch, distance, scheme, piggyback, wire16):
    R = reference
    g_r, color = _graph(R, distance)
    g_t, _ = _graph(T, distance)
    pr = R.partition_graph(g_r, P, halo=distance)
    pt = T.partition_graph(g_t, P, halo=distance)
    order = R.compute_order(pr, R.ordering.INTERNAL_FIRST)
    seed, _ = R.color_graph_sim(pr, order, R.ColorConfig(
        scheme=scheme, distance=distance, **color))
    kw = dict(scheme=scheme, piggyback=piggyback, wire16=wire16,
              distance=distance)
    want, hist_r = _iterations(R, pr, seed, R.RecolorConfig(**kw))
    got = {}
    for pull in (False, True):
        with _path(monkeypatch, pull, T_recolor) as pushes:
            got[pull] = _iterations(T, pt, view_from_numpy(seed, "cpu"),
                                    T.RecolorConfig(**kw), device="cpu")
        assert (pushes[0] == 0) == pull
    for pull, (views, hist) in got.items():
        assert len(views) == len(want) == N_ITERS
        for v, w in zip(views, want):
            np.testing.assert_array_equal(v, w)
        assert hist == hist_r
    assert sum(h["n_exchanges"] for h in hist_r) > N_ITERS


def _lanes_cfg(M, distance, scheme):
    return M.PipelineConfig(
        color=M.ColorConfig(max_colors=512, superstep=64, scheme=scheme,
                            distance=distance,
                            **({"tile": 16, "max_rounds": 256}
                               if distance == 2 else {})),
        recolor=M.RecolorConfig(max_colors=512, scheme=scheme,
                                distance=distance),
        n_iters=6, patience=1)


def _lane_graphs(M, distance):
    if distance == 1:
        return [M.rmat.rmat_good(7, 8, seed=4), M.rmat.rmat_bad(7, 8, seed=5),
                M.rmat.rmat_good(6, 8, seed=6)]     # stop after 2, 2, 3
    return [M.rmat.grid2d(12, 12, 9), M.rmat.grid2d(10, 14, 9),
            M.rmat.grid3d(4, 4, 5)]


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("distance", [1, 2])
def test_push_lanes_with_a_frozen_lane_equal_pull_and_reference(
        reference, monkeypatch, distance, scheme):
    """Three lanes in one bucket, one frozen by the patience stop while
    another still runs: every iteration's view (``recolor_steps``'
    output, frozen lanes included), the lanes' views and histories."""
    from test_torch_many import one_bucket
    R = reference
    pr = [R.partition_graph(g, P, halo=distance)
          for g in _lane_graphs(R, distance)]
    pt = [T.partition_graph(g, P, halo=distance)
          for g in _lane_graphs(T, distance)]
    ref_out = R.color_many(pr, _lanes_cfg(R, distance, scheme),
                           buckets=one_bucket(R, pr))
    steps_real = pipeline.recolor_steps
    views = []

    def steps(*a, **k):
        out = steps_real(*a, **k)
        views.append((k.get("lanes_on"), out[0].clone(), out[1]))
        return out

    monkeypatch.setattr(pipeline, "recolor_steps", steps)
    got = {}
    for pull in (False, True):
        views.clear()
        with _path(monkeypatch, pull, pipeline) as pushes:
            res = T.color_many(pt, _lanes_cfg(T, distance, scheme),
                               buckets=one_bucket(T, pt), device="cpu")
        assert (pushes[0] == 0) == pull
        got[pull] = res, list(views)
    (push, push_views), (pull, pull_views) = got[False], got[True]
    runs = [r["n_iters_run"] for r in ref_out]
    assert len(set(runs)) > 1 and min(runs) < 6       # a lane froze early
    assert any(on is not None and not all(on) for on, _, _ in push_views)
    assert len(push_views) == len(pull_views)
    for (on_a, va, sa), (on_b, vb, sb) in zip(push_views, pull_views):
        assert on_a == on_b and torch.equal(va, vb)
        assert {k: v for k, v in sa.items() if k != "n_colors"} == {
            k: v for k, v in sb.items() if k != "n_colors"}
        assert torch.equal(sa["n_colors"], sb["n_colors"])
    for r, a, b in zip(ref_out, push, pull):
        np.testing.assert_array_equal(np.asarray(r["view"]),
                                      a["view"].numpy())
        assert torch.equal(a["view"], b["view"])
        assert a["history"] == b["history"] == r["history"]
        assert a["n_iters_run"] == b["n_iters_run"] == r["n_iters_run"]


# --------------------------------------------------------------- the kernel --

@dataclasses.dataclass
class _Case:
    """A synthetic push: S shards of two lanes, a view with colors on the
    local rows, a fan-out with one hub row (a copy on every other shard of
    its lane) and a sorted order with its class windows."""
    view: torch.Tensor
    fan_ptr: torch.Tensor
    fan_dst: torch.Tensor
    sorted_pad: torch.Tensor
    start: torch.Tensor
    sizes: torch.Tensor


def _case(seed=0, S=8, lanes=2, n_local=300, n_ghost=900, n_cls=6):
    gen = np.random.default_rng(seed)
    n_slots = n_local + n_ghost + 1
    view = np.zeros((S, n_slots), np.int32)
    view[:, :n_local] = gen.integers(1, 40000, (S, n_local))
    shards = S // lanes
    # every ghost slot has one source row, in its own lane on another shard
    srcs = {}
    for p in range(S):
        lane0 = p // shards * shards
        for gcol in range(n_ghost):
            q = lane0 + (p - lane0 + 1 + gen.integers(shards - 1)) % shards
            srcs.setdefault((q, int(gen.integers(n_local))), []).append(
                p * n_slots + n_local + gcol)
    hub = (0, 7)                                  # fan-out shards - 1
    srcs[hub] = [p * n_slots + n_local + n_ghost - 1 for p in range(1, shards)]
    for key in list(srcs):
        if key != hub:
            srcs[key] = [d for d in srcs[key] if d not in srcs[hub]]
    fan_ptr = np.zeros((S, n_local + 1), np.int32)
    dst, at = [], 0
    for p in range(S):
        for v in range(n_local):
            fan_ptr[p, v] = at
            dst += srcs.get((p, v), [])
            at = len(dst)
        fan_ptr[p, n_local] = at
    sizes = np.zeros((S, n_cls), np.int32)
    for p in range(S):
        cut = np.sort(gen.choice(np.arange(1, n_local), n_cls - 2,
                                 replace=False))
        sizes[p, 1:] = np.diff(np.concatenate([[0], cut, [n_local]]))
    sizes[1, n_cls - 2] += sizes[1, n_cls - 1]    # shard 1's last class
    sizes[1, n_cls - 1] = 0                       # is empty
    start = (np.cumsum(sizes, axis=1) - sizes).astype(np.int32)
    order = np.stack([gen.permutation(n_local) for _ in range(S)])
    order[0, order[0] == 7] = order[0, start[0, 2]]
    order[0, start[0, 2]] = 7                     # the hub sits in class 2
    sorted_pad = np.concatenate([order, np.zeros((S, 16), np.int64)],
                                axis=1).astype(np.int32)
    t = torch.from_numpy
    return _Case(t(view), t(fan_ptr), t(np.array(dst, np.int32)),
                 t(sorted_pad), t(start), t(sizes))


def _push(case, backend, lane_on=None, **kw):
    view = case.view.clone()
    return ops.exchange_push(view, case.fan_ptr, case.fan_dst,
                             case.sorted_pad, case.start, case.sizes, lane_on,
                             backend=backend, **kw)


def test_plain_push_writes_the_windows_fan_out():
    """The plain version against a loop over the window's rows."""
    case = _case()
    for first, last, wire16 in [(1, 3, False), (2, 2, True), (4, 3, False)]:
        got = _push(case, "torch", first_class=first, last_class=last,
                    wire16=wire16)
        want = case.view.clone().view(-1)
        S, n_slots = case.view.shape
        for p in range(S):
            lo = int(case.start[p, first])
            hi = int(case.start[p, last] + case.sizes[p, last])
            for i in range(lo, hi):
                v = int(case.sorted_pad[p, i])
                c = int(case.view[p, v])
                c = int(np.int32(c).astype(np.int16)) if wire16 else c
                a, b = case.fan_ptr[p, v], case.fan_ptr[p, v + 1]
                want[case.fan_dst[a:b].long()] = c
        assert torch.equal(got, want.view(S, n_slots))
    on = torch.tensor([0, 1], dtype=torch.int32)
    got = _push(case, "torch", on, first_class=1, last_class=5)
    lane0 = case.view.shape[0] // 2 * case.view.shape[1]
    assert torch.equal(got.view(-1)[:lane0], case.view.view(-1)[:lane0])
    assert not torch.equal(got, case.view)


def test_fan_out_lists_every_entry_by_its_source():
    """``FlatExchange.fan_out`` of a real exchange: each ghost entry under
    its source row, sources that are no valid local row past the last
    offset, and each lane's count of the entries listed."""
    pg = T.partition_graph(T.rmat.rmat_good(8, 8, seed=3), P)
    arrs = T.to_device(pg, "cpu", sparse=True)
    n_local = arrs["n_local"].tolist()
    for scheme in ("sparse", "allgather"):
        ex = comm.make_exchange(arrs, comm.CommConfig(scheme=scheme))
        fan_ptr, fan_dst, lane_entries = ex.fan_out()
        nlm = arrs["indptr"].shape[1] - 1
        n_slots = arrs["prio"].shape[1]
        assert fan_ptr.shape == (P, nlm + 1) and fan_ptr.dtype == torch.int32
        assert fan_ptr[0, 0] == 0 and bool((fan_ptr.diff(dim=1) >= 0).all())
        assert bool((fan_ptr[1:, 0] == fan_ptr[:-1, -1]).all())
        pairs = sorted(zip(ex.dst.tolist(), ex.src.tolist()))
        local = [(d, s) for d, s in pairs
                 if s % n_slots < n_local[s // n_slots]]
        got = []
        for p in range(P):
            for v in range(nlm):
                a, b = fan_ptr[p, v], fan_ptr[p, v + 1]
                got += [(d, p * n_slots + v) for d in fan_dst[a:b].tolist()]
        assert sorted(got) == local and len(local) > 0
        assert lane_entries.tolist() == [len(local)]


@pytest.mark.parametrize("distance", [1, 2])
def test_push_counts_what_it_writes_with_a_frozen_lane(monkeypatch,
                                                       distance):
    """``exchange.entries`` counts a lane's pushes once an iteration, from
    the fan-out's lane totals: under a profiler it equals the ghost
    entries the exchanges rewrote, counted from outside, while one of
    three lanes is frozen by the patience stop."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from test_torch_many import one_bucket
    from test_torch_tracing import _rewritten
    pt = [T.partition_graph(g, P, halo=distance)
          for g in _lane_graphs(T, distance)]
    written, frozen = [], []
    pull, push = comm.FlatExchange.__call__, comm.FlatExchange.push

    def counted_pull(self, view, lanes=None, rounds=None):
        out, n = _rewritten(self, view, lambda v: pull(
            self, v, lanes=lanes, rounds=rounds))
        written.append(n)
        return out

    def counted_push(self, view, rows, first, last, lane_on=None, **k):
        frozen.append(lane_on is not None and not bool(lane_on.all()))
        out, n = _rewritten(self, view, lambda v: push(
            self, v, rows, first, last, lane_on, **k))
        written.append(n)
        return out

    monkeypatch.setattr(comm.FlatExchange, "__call__", counted_pull)
    monkeypatch.setattr(comm.FlatExchange, "push", counted_push)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        T.color_many(pt, _lanes_cfg(T, distance, "sparse"),
                     buckets=one_bucket(T, pt), device="cpu")
    counted = tracing.counters()["exchange.entries"]
    tracing.reset()
    assert any(frozen) and counted == sum(written) > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("first,last,lanes,wire16", [
    (1, 5, None, False),        # every class, the hub among them
    (2, 2, None, True),         # the hub's class alone, through int16
    (1, 3, [0, 1], False),      # the hub's lane frozen
    (4, 3, None, False),        # an empty run of classes
    (5, 5, None, False)])       # a window that may be empty on some shards
def test_cuda_exchange_push_matches_plain(cuda_device, first, last, lanes,
                                          wire16):
    case = _case(seed=3)
    on = None if lanes is None else torch.tensor(lanes, dtype=torch.int32)
    want = _push(case, "torch", on, first_class=first, last_class=last,
                 wire16=wire16)
    dev = _Case(*(t.to(cuda_device) for t in dataclasses.astuple(case)))
    before = ops.EXCHANGE_PUSH.launches
    got = _push(dev, "cuda", None if on is None else on.to(cuda_device),
                first_class=first, last_class=last, wire16=wire16)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert ops.EXCHANGE_PUSH.launches == before + (first <= last)
    hub = case.fan_ptr[0, 8] - case.fan_ptr[0, 7]
    assert int(hub) == case.view.shape[0] // 2 - 1


@pytest.mark.cuda
def test_cuda_push_path_matches_cpu(cuda_device):
    """A whole recoloring loop on the card (push, kernel) against the CPU
    (push, plain version) and the card's pull."""
    pg = T.partition_graph(T.rmat.rmat_good(10, 8, seed=3), 8)
    cfg = T.PipelineConfig(color=T.ColorConfig(scheme="sparse"),
                           recolor=T.RecolorConfig(scheme="sparse"),
                           n_iters=3)
    order = T.compute_order(pg, T.ordering.INTERNAL_FIRST)
    v_cpu, r_cpu = T.pipeline_sim(pg, order, cfg, device="cpu")
    before = ops.EXCHANGE_PUSH.launches
    v_gpu, r_gpu = T.pipeline_sim(pg, order, cfg, device=cuda_device)
    assert ops.EXCHANGE_PUSH.launches > before
    assert torch.equal(v_gpu.cpu(), v_cpu)
    assert r_gpu["history"] == r_cpu["history"]
