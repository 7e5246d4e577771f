"""The collective audit (``repro_torch.analysis.collective_audit``) on gloo
worlds of 2 ranks and of a 2 x 2 batch x shard mesh.

(a) every rank of each process group issues the same sequence of
collectives — ``pipeline_sharded``, ``recolor_sharded``,
``color_many_sharded`` (lanes of different graphs in one bucket, finishing
at different rounds) and the service's mesh route, under both exchange
schemes — and every point-to-point send meets its peer's receive; (b)
``scheme="auto"`` records the sequence of the scheme it resolves to; (c)
a family of three signatures run twice builds one program-cache entry per
signature.  The comparisons themselves are held on synthetic records
that diverge.
"""
import pytest
import torch.distributed as dist

import test_torch_world as W
from repro_torch.analysis import collective_audit as CA

GRAPHS = CA.GRAPHS


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = W.World(2, tmp_path_factory.mktemp("audit2"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("audit4"))
    yield w
    w.close()


def run_case(world, spec, case):
    outs = world.run(CA.rank_case, case, spec)
    calls = {r: o["calls"] for r, o in enumerate(outs)}
    assert CA.sequence_failures(calls) == []
    return outs


@pytest.mark.parametrize("scheme", ["sparse", "allgather", "auto"])
def test_pipeline_same_sequence(world2, scheme):
    outs = run_case(world2, CA.WORLD2, dict(kind="pipeline", graph=CA.GRAPH,
                                            scheme=scheme))
    names = {c[0] for c in outs[0]["calls"]}
    want = {"all_reduce", "all_gather"} | (
        {"batch_isend_irecv"} if outs[0]["resolved"] == "sparse" else set())
    assert names == want


def test_auto_records_the_resolved_scheme(world2):
    auto = world2.run(CA.rank_case, dict(kind="pipeline", graph=CA.GRAPH,
                                         scheme="auto"), CA.WORLD2)
    resolved = auto[0]["resolved"]
    assert {o["resolved"] for o in auto} == {resolved}
    fixed = world2.run(CA.rank_case, dict(kind="pipeline", graph=CA.GRAPH,
                                          scheme=resolved), CA.WORLD2)
    assert [o["calls"] for o in auto] == [o["calls"] for o in fixed]


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
def test_recolor_same_sequence(world2, scheme):
    outs = run_case(world2, CA.WORLD2, dict(kind="recolor", graph=CA.GRAPH,
                                            scheme=scheme))
    assert any(c[0] == "all_reduce" for c in outs[0]["calls"])


@pytest.mark.parametrize("mesh", ["2", "2x2"])
@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
def test_many_lanes_of_different_graphs(world2, world4, mesh, scheme):
    world, spec = ((world2, CA.WORLD2) if mesh == "2"
                   else (world4, CA.WORLD2X2))
    outs = run_case(world, spec, dict(kind="many", graphs=GRAPHS,
                                      scheme=scheme, one_bucket=True))
    # one bucket of three graphs whose lanes finish at different rounds
    assert outs[0]["buckets"] == 1
    assert len(set(outs[0]["rounds"])) > 1
    assert len(set(outs[0]["iters"])) > 1
    if mesh == "2x2":   # the batch rows meet on the batch group too
        groups = {c[1] for c in outs[0]["calls"]}
        assert (0, 1) in groups or (0, 2) in groups
        assert len(groups) >= 2


def test_service_mesh_route_same_sequence(world4):
    outs = run_case(world4, CA.WORLD2X2, dict(
        kind="serve", graphs=GRAPHS[:2], arrivals=[0, 1, 0],
        serve=dict(lanes=2, chunk_iters=1, solo_warm=False)))
    assert {o["results"] for o in outs} == {3}
    assert {(o["shed"], o["failed"]) for o in outs} == {(0, 0)}
    assert any(c[0] == "broadcast" for c in outs[0]["calls"])  # the clock


def test_one_build_per_signature(world2):
    outs = run_case(world2, CA.WORLD2, dict(kind="cache", graphs=GRAPHS,
                                            scheme="sparse"))
    for o in outs:
        assert o["n_sigs"] >= 3
        assert o["stats"]["traces"] == o["stats"]["misses"] == o["n_sigs"]
        assert o["stats"]["hits"] == o["n_sigs"]


# ------------------------------------------------ the comparisons themselves --

W2 = (0, 1)
AR = ("all_reduce", W2, ("torch.int64", (1, 2), "RedOpType.MAX"))
AG = ("all_gather", W2, ("torch.int32", (1, 8), 2))


def p2p(*moves):
    return ("batch_isend_irecv", W2, tuple(moves))


def test_sequence_checker_flags_divergence():
    ok = {0: [AR, p2p(("send", 1, "torch.int32", 4),
                      ("recv", 1, "torch.int32", 3)), AG],
          1: [AR, p2p(("send", 0, "torch.int32", 3),
                      ("recv", 0, "torch.int32", 4)), AG]}
    assert CA.sequence_failures(ok) == []
    extra = {0: ok[0], 1: [AR] + ok[1]}                 # one more reduction
    assert CA.sequence_failures(extra)
    shape = dict(ok)                                    # another shape
    shape[1] = [("all_reduce", W2, ("torch.int64", (2, 2),
                                    "RedOpType.MAX"))] + ok[1][1:]
    assert CA.sequence_failures(shape)
    size = {0: ok[0], 1: [AR, p2p(("send", 0, "torch.int32", 3),
                                  ("recv", 0, "torch.int32", 5)), AG]}
    bad = CA.sequence_failures(size)
    assert len(bad) == 1 and "no matching receive" in bad[0]


def test_recorder_restores_torch_distributed():
    saved = {n: getattr(dist, n) for n in CA.WRAPPED}
    with CA.CollectiveRecorder() as rec:
        assert all(getattr(dist, n) is not saved[n] for n in CA.WRAPPED)
    assert all(getattr(dist, n) is saved[n] for n in CA.WRAPPED)
    assert rec.calls == []
