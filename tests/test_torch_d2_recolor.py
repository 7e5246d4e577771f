"""The port's distance-2 recoloring against the reference's, bit for bit.

Same halo-2 partition, same seed coloring, same keys, at the reference's
``tests/test_d2.py`` sizes (``tests/test_torch_d2_parts.py``): views and stats
(``wire_bytes`` and ``n_exchanges`` included) must be equal (integer
outputs, tolerance 0).  The reference runs live under
``jax_threefry_partitionable=True``, set explicitly.  The pipeline half is
``tests/test_torch_d2_pipeline.py``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.graph import arrays_from_numpy, view_from_numpy
from test_torch_d2_parts import parts, pipeline_cfgs, seed_view
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("piggyback", [True, False], ids=["piggy", "every"])
@pytest.mark.parametrize("perm", [R.RV, R.NI, R.ND])
def test_recolor_d2_matches_reference(perm, piggyback, scheme):
    """One D2 RC iteration on the reference's own partition and seed
    coloring, carried into the port by ``arrays_from_numpy``, and through
    the port's own partition by ``recolor_sim``."""
    pr, pt, _, g = parts("rmat_good", 4)
    seed = seed_view("rmat_good", 4)
    rcfg = dict(max_colors=512, distance=2, piggyback=piggyback,
                scheme=scheme)
    vr, sr = R.recolor_sim(pr, seed, perm, R.RecolorConfig(**rcfg),
                           key=jax.random.key(0))
    arrs = arrays_from_numpy(pr.arrays(sparse=scheme == "sparse"), "cpu")
    vt, st = T.recolor_shards(arrs, view_from_numpy(seed, "cpu"), perm,
                              T.RecolorConfig(**rcfg))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    vd, sd = T.recolor_sim(pt, view_from_numpy(seed, "cpu"), perm,
                           T.RecolorConfig(**rcfg), device="cpu")
    assert torch.equal(vd, vt) and sd == st
    chk = T.check_coloring(g, T.colors_from_views(pt, vt), distance=2)
    assert chk["valid"], chk
    assert st["n_colors_distinct"] <= st["n_colors_before"]


def test_recolor_d2_needs_the_two_hop_halo():
    _, pt, order, _ = parts("grid2d", 2, halo=1)
    view = torch.zeros((2, pt.n_slots), dtype=torch.int32)
    with pytest.raises(ValueError, match="halo=2"):
        T.recolor_sim(pt, view, T.ND,
                      T.RecolorConfig(max_colors=512, distance=2),
                      device="cpu")
    _, cfg_t = pipeline_cfgs("sparse")
    with pytest.raises(ValueError, match="halo=2"):
        T.pipeline_sim(pt, order, cfg_t, device="cpu")


@pytest.mark.parametrize("color_d,recolor_d", [(2, 1), (1, 2)])
def test_pipeline_stages_must_agree_on_distance(color_d, recolor_d):
    with pytest.raises(ValueError, match="agree on distance"):
        T.PipelineConfig(color=T.ColorConfig(distance=color_d),
                         recolor=T.RecolorConfig(distance=recolor_d))
