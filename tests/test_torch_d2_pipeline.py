"""The port's distance-2 color→recolor pipeline against the reference's,
bit for bit.

Same halo-2 partition, same keys, at the reference's ``tests/test_d2.py``
sizes (``tests/test_torch_d2_parts.py``): views, stats (``wire_bytes`` and
``n_exchanges`` included) and per-iteration histories must be equal
(integer outputs, tolerance 0).  The reference runs live under
``jax_threefry_partitionable=True``, set explicitly.  The recoloring half
is ``tests/test_torch_d2_recolor.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from test_torch_d2_parts import marked_blocks, parts, pipeline_cfgs
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("gname,P", [("grid2d", 16), ("grid3d", 4),
                                     ("grid3d", 16), ("rmat_good", 2)])
def test_pipeline_d2_matches_reference(gname, P, scheme):
    pr, pt, order, g = parts(gname, P)
    cfg_r, cfg_t = pipeline_cfgs(scheme)
    vr, rr = R.pipeline_sim(pr, order, cfg_r)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert rt["color"] == rr["color"]
    assert rt["history"] == rr["history"]
    assert rt["n_iters_run"] == rr["n_iters_run"] == 3
    chk = T.check_coloring(g, T.colors_from_views(pt, vt), distance=2)
    assert chk["valid"], chk


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("gname", ["grid2d", "rmat_good"])
def test_partial_pipeline_d2_matches_reference(gname, scheme):
    """Partial D2 through the whole pipeline: recoloring keeps the
    unmarked vertices at 0 (class 0 is skipped) and the subset valid."""
    pr, pt, order, g = parts(gname, 4)
    marked_g, marked = marked_blocks(g, pt)
    cfg_r, cfg_t = pipeline_cfgs(scheme, partial=True)
    vr, rr = R.pipeline_sim(pr, order, cfg_r, marked=marked)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, marked=marked, device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert rt["color"] == rr["color"] and rt["history"] == rr["history"]
    colors = T.colors_from_views(pt, vt)
    assert (colors[~marked_g] == 0).all()
    chk = T.check_coloring(g, colors, distance=2, marked=marked_g)
    assert chk["valid"], chk


def test_pipeline_d2_adaptive_stop_matches_reference():
    pr, pt, order, _ = parts("grid3d", 4)
    cfg_r, cfg_t = pipeline_cfgs("sparse", sel="first_fit", n_iters=6)
    cfg_r = dataclasses.replace(cfg_r, patience=1)
    cfg_t = dataclasses.replace(cfg_t, patience=1)
    vr, rr = R.pipeline_sim(pr, order, cfg_r)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, device="cpu")
    assert rt["n_iters_run"] == rr["n_iters_run"] < 6
    assert rt["history"] == rr["history"]
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
