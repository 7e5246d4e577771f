"""The port's mesh layer and its ``*_sharded`` entry points on 8 gloo ranks.

In-process: the ``MeshSpec`` layouts, the ``shard_axis_of`` axis-name
contract (``MeshSpec`` stands in for a mesh: it has axis names and sizes
and needs no world), the signatures' ``axes`` and the lane-target padding,
as ``tests/test_mesh2d.py`` holds them for the reference.

On the world (one shard per rank, ``tests/test_torch_world.py``): every rank's
``color_graph_sharded`` + ``recolor_sharded`` and ``pipeline_sharded``
(both exchange schemes, ``wire16``, Random-X with ``exchange_every=3``)
against the reference's ``*_sim`` run live here on the same numpy inputs:
views, stats (``wire_bytes`` and ``n_exchanges`` included) and histories
equal bit for bit (integer outputs, tolerance 0), under
``jax_threefry_partitionable=True``, set explicitly.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
import test_torch_world as W
from repro_torch.core.comm import (AXIS, BATCH_AXIS, batch_axis_of,
                                   batch_axis_size, shard_axis_of)
from repro_torch.core.pipeline import _lane_target
from repro_torch.launch.mesh import MeshSpec, engine_lanes, init_world

P = 8
WORKERS = ((P,), (AXIS,))
RMAT = ("rmat_good", (7, 8), 3)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(P, tmp_path_factory.mktemp("world8"))
    yield w
    w.close()


def _key_data(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


# ------------------------------------------------------------ mesh layer --

class TestMeshSpec:
    def test_layouts(self):
        assert MeshSpec.worker(8) == MeshSpec((8,), (AXIS,))
        assert MeshSpec.coloring(4, 2) == MeshSpec((2, 4), (BATCH_AXIS, AXIS))
        assert MeshSpec.coloring(4) == MeshSpec((1, 4), (BATCH_AXIS, AXIS))
        assert MeshSpec.production().axes == ("data", "model")
        assert MeshSpec.production(multi_pod=True).shape == (2, 16, 16)
        assert MeshSpec.local().shape == (1, 1)
        assert MeshSpec.coloring(4, 2).n_devices == 8

    def test_shape_axes_must_agree(self):
        with pytest.raises(ValueError):
            MeshSpec((2, 4), ("workers",))

    def test_build_needs_a_world_and_a_gpu(self):
        """No world: ``build`` raises; the default backend is NCCL, which
        without a GPU raises rather than falling back to the CPU."""
        with pytest.raises(RuntimeError, match="init_world"):
            MeshSpec.worker(1).build("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="gloo"):
                init_world(init_method="file:///nonexistent/store")

    def test_degenerate_meshes(self):
        local = MeshSpec.local()
        assert shard_axis_of(local) == "model"      # all-size-1 fallback
        assert batch_axis_of(local) is None
        assert batch_axis_size(local) == 1
        one = MeshSpec.coloring(1, 1)
        assert shard_axis_of(one) == AXIS
        assert batch_axis_size(one) == 1


class TestShardAxisContract:
    def test_workers_always_wins(self):
        m = MeshSpec((2, 4), (BATCH_AXIS, AXIS))
        assert shard_axis_of(m) == AXIS
        assert batch_axis_of(m) == BATCH_AXIS
        assert batch_axis_size(m) == 2

    def test_single_non_batch_axis(self):
        assert shard_axis_of(MeshSpec((8,), ("shards",))) == "shards"
        assert shard_axis_of(MeshSpec((2, 8), (BATCH_AXIS, "s"))) == "s"

    def test_single_sized_axis(self):
        assert shard_axis_of(MeshSpec((1, 8), ("data", "model"))) == "model"
        assert shard_axis_of(MeshSpec((8, 1), ("data", "model"))) == "data"

    def test_all_size_one_smoke_mesh(self):
        assert shard_axis_of(MeshSpec((1, 1), ("data", "model"))) == "model"

    def test_ambiguous_mesh_raises(self):
        with pytest.raises(ValueError, match="MeshSpec"):
            shard_axis_of(MeshSpec((2, 4), ("data", "model")))


class TestSignatureAxes:
    @staticmethod
    def _cfg():
        return T.PipelineConfig(
            color=T.ColorConfig(max_colors=32, scheme="allgather"),
            recolor=T.RecolorConfig(max_colors=32, scheme="allgather"))

    def test_sim_signature_pins_the_shard_axis(self):
        pg = T.partition_graph(T.rmat.grid2d(8, 8, 5), 4)
        sig = T.plan_signature(pg, self._cfg())
        assert sig.axes == ((AXIS, 4),) and sig.kind == "pipe_sim"
        assert f"axes={AXIS}=4" in sig.describe()

    def test_mesh_signature_pins_the_mesh_geometry(self):
        pg = T.partition_graph(T.rmat.grid2d(8, 8, 5), 1)
        sig = T.plan_signature(pg, self._cfg(), mesh=MeshSpec.coloring(1, 1))
        assert sig.axes == ((BATCH_AXIS, 1), (AXIS, 1))
        assert sig.kind == "pipe_sharded"
        # a different geometry is a different program identity
        assert sig != T.plan_signature(pg, self._cfg())

    def test_bucket_signature_on_a_mesh(self):
        pgs = [T.partition_graph(T.rmat.grid2d(8, 8, 5), 2) for _ in range(3)]
        bucket = T.bucket_graphs(pgs)[0]
        sig = T.bucket_signature(bucket, self._cfg(),
                                 mesh=MeshSpec.coloring(2, 2))
        assert sig.kind == "many_sharded" and sig.batch == 4
        assert dict((k, s) for k, s, _ in sig.dims)["nbr"][:2] == (2, 4)


class TestLaneTarget:
    def test_pow2_padding(self):
        assert _lane_target(3, True) == 4
        assert _lane_target(4, True) == 4
        assert _lane_target(5, True) == 8
        assert _lane_target(3, False) == 3

    def test_batch_axis_divisibility(self):
        assert _lane_target(1, True, 2) == 2
        assert _lane_target(3, True, 4) == 4
        assert _lane_target(3, False, 2) == 4
        assert _lane_target(4, True, 2) == 4

    def test_engine_lanes(self):
        assert engine_lanes(None, 3) == 3
        assert engine_lanes(MeshSpec.worker(4), 3) == 3
        assert engine_lanes(MeshSpec.coloring(2, 2), 3) == 4
        assert engine_lanes(MeshSpec.coloring(2, 2), 0) == 2


# ----------------------------------------- sharded entry points (world) --

def test_no_cpu_fallback(world):
    """A mesh built for CUDA on ranks without a GPU raises, and so does a
    mesh of more ranks than the world has."""
    for cuda, size in world.run(W.build_errors, WORKERS):
        assert "CUDA is not available" in cuda
        assert f"needs {P + 1} ranks" in size


def test_mesh_collectives(world):
    """``MeshComm``'s reductions, gathers (int16 as bytes) and ring
    permutation over the shard group, per lane of each rank's rows."""
    rows = [[[p, -p], [10 * p, 1]] for p in range(P)]
    for got in world.run(W.collectives, WORKERS):
        p = got["p"]
        assert got["psum"] == np.sum(rows, axis=0).tolist()
        assert got["pmax"] == np.max(rows, axis=0).tolist()
        assert got["pmin"] == np.min(rows, axis=0).tolist()
        assert got["any"] == (np.array(rows) > 5 * P).any(axis=0).tolist()
        assert got["gather"] == rows
        assert got["ppermute"] == rows[(p - 1) % P]
        assert got["index"] == [p, p]
        assert got["lanes"] == (p == 1)    # a 1D mesh: no batch group


def test_color_and_recolor_sharded_match_reference(world):
    """The reference's ``test_sharded_coloring_equals_sim`` case:
    ``grid2d(32, 32, 9)`` on 8 shards, Smallest-Last order, then one ND
    iteration with key 5."""
    g_spec = ("grid2d", (32, 32, 9), None)
    pr = R.partition_graph(R.rmat.grid2d(32, 32, 9), P)
    order = R.compute_order(pr, R.ordering.SMALLEST_LAST)
    color, recolor = dict(max_colors=64, superstep=64), dict(max_colors=64)
    v1, s1 = R.color_graph_sim(pr, order, R.ColorConfig(**color))
    key = jax.random.key(5)
    v2, s2 = R.recolor_sim(pr, v1, "nd", R.RecolorConfig(**recolor), key=key)
    for w1, t1, w2, t2 in world.run(W.color_then_recolor, WORKERS, g_spec, P,
                                    order, color, recolor, "nd",
                                    _key_data(key)):
        np.testing.assert_array_equal(w1, np.asarray(v1))
        np.testing.assert_array_equal(w2, np.asarray(v2))
        assert (t1, t2) == (s1, s2)


def _pipeline_case(world, g_spec, halo, color, recolor, pipe):
    pr = R.partition_graph(getattr(R.rmat, g_spec[0])(
        *g_spec[1], **({} if g_spec[2] is None else dict(seed=g_spec[2]))),
        P, halo=halo)
    order = R.compute_order(pr, R.ordering.INTERNAL_FIRST)
    vr, rr = R.pipeline_sim(pr, order, R.PipelineConfig(
        color=R.ColorConfig(**color), recolor=R.RecolorConfig(**recolor),
        **pipe))
    for view, res in world.run(W.pipeline, WORKERS, g_spec, P, halo, order,
                               color, recolor, pipe):
        np.testing.assert_array_equal(view, np.asarray(vr))
        assert res == rr
    return rr


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
def test_pipeline_sharded_matches_reference(world, scheme):
    rr = _pipeline_case(
        world, RMAT, 1,
        dict(max_colors=64, superstep=64, scheme=scheme, selection="random_x"),
        dict(max_colors=64, scheme=scheme), dict(n_iters=3, patience=1))
    assert rr["color"]["wire_bytes"] > 0


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
def test_wire16_matches_reference(world, scheme):
    """int16 payloads on the wire: the same colors, half the bytes."""
    kw = dict(scheme=scheme, wire16=True)
    rr = _pipeline_case(world, RMAT, 1, dict(max_colors=64, superstep=64, **kw),
                        dict(max_colors=64, **kw), dict(n_iters=2))
    assert all(h["wire_bytes"] % 2 == 0 for h in rr["history"])


def test_random_x_exchange_every_matches_reference(world):
    """Random-X draws fold each rank's shard coordinate; exchanges every
    third superstep of 16 vertices (bounded staleness)."""
    pr = R.partition_graph(R.rmat.rmat_good(7, 8, seed=3), P)
    order = R.compute_order(pr, R.ordering.INTERNAL_FIRST)
    color = dict(max_colors=64, superstep=16, tile=8, selection="random_x",
                 exchange_every=3, scheme="sparse")
    vr, sr = R.color_graph_sim(pr, order, R.ColorConfig(**color))
    for view, stats in world.run(W.color, WORKERS, RMAT, P, order, color):
        np.testing.assert_array_equal(view, np.asarray(vr))
        assert stats == sr
    assert sr["n_exchanges"] > 0
