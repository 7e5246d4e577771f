"""``ColoringService(mesh=...)`` on a ``(2, 2)`` coloring mesh of gloo ranks.

Every rank runs the same ``FakeClock`` script; every rank must resolve
every request as the one-device (``mesh=None``) port service does: the
same shed and failed ids, and per request the same colors, color stats,
history and route.  Three routes: engine lanes (the lanes split over the
batch axis, a lane count of 1 rounded up to it), flush waves
(``color_many_sharded``) and warm solo dispatches (``pipeline_sharded``).
The one-device service is held to the reference by
``tests/test_torch_serve_parity.py``.
"""
import numpy as np
import pytest

import test_torch_world as W
from repro_torch.core.comm import AXIS, BATCH_AXIS

MESH = ((2, 2), (BATCH_AXIS, AXIS))
P = 2
GRAPHS = [("rmat_er", (6, 8), 1), ("rmat_good", (6, 4), 2),
          ("rmat_er", (6, 8), 3)]
CFG = dict(max_colors=64, n_iters=4)
ARRIVALS = [(t, i) for t, i in enumerate([0, 1, 2, 0, 2, 1])]
SCRIPTS = {
    # a lane count of 1 rounds up to the batch axis on the mesh
    "lanes1": (dict(lanes=1, chunk_iters=1, solo_warm=False), False),
    "lanes4": (dict(lanes=4, chunk_iters=2, solo_warm=False), False),
    "flush": (dict(mode="flush", solo_warm=False), False),
    "solo": (dict(lanes=2, chunk_iters=1), True),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_mesh_service_resolves_as_one_device(world, script):
    serve_kw, prewarm = SCRIPTS[script]
    shed, failed, ref, _ = W.serve(None, P, GRAPHS, ARRIVALS, CFG, serve_kw,
                                   prewarm)
    assert not shed and not failed and len(ref) == len(ARRIVALS)
    route = {"flush": "batch", "solo": "solo"}.get(script, "engine")
    assert {r["route"] for r in ref.values()} == {route}
    for got in world.run(W.serve, MESH, P, GRAPHS, ARRIVALS, CFG, serve_kw,
                         prewarm):
        assert got[:2] == (shed, failed)
        assert got[2].keys() == ref.keys()
        for j, r in ref.items():
            g = got[2][j]
            np.testing.assert_array_equal(g.pop("colors"), r["colors"])
            assert g == {k: v for k, v in r.items() if k != "colors"}
