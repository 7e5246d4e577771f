"""The port's memory projection and coloring dry run, against the reference.

``repro_torch.roofline.coloring_memory_projection`` keeps the reference's
signature and keys: its per-array bytes equal the reference's wherever
the two device layouts agree, and every difference is listed here and
asserted (``gvid`` stays on the host, ``n_local`` is on the port's
device, the int64 promotion widens ``prio`` alone).  With a partition's
own fractions it names every ``to_device`` tensor's bytes exactly.  The
dry-run record's plan fields equal the reference partition's numbers,
live at a small size and against the reference's committed
``rmat_er(18)`` record at P=256.
"""
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro.roofline as RR
import repro_torch.core as T
from repro_torch import roofline as TR
from repro_torch.launch import dryrun

REPO_ROOT = Path(__file__).resolve().parent.parent
SAME = ("nbr", "nbr2", "indices", "edge_src", "indptr", "prio", "boundary",
        "ghost_tables", "degree_flags", "views")
PROJECTIONS = {
    "rmat20-P64": ((2**20, 64, 678), {}),
    "d2-grid": ((64**3, 16, 26), dict(maxd2=98, ghost_frac=0.3,
                                     boundary_frac=0.4)),
    "batched": ((2**17, 16, 512), dict(batch=8)),
    "promoted": ((2**31 + 5, 4096, 32), dict(ghost_frac=0.25)),
}


@pytest.mark.parametrize("name", sorted(PROJECTIONS))
def test_projection_agrees_with_the_reference(name):
    args, kw = PROJECTIONS[name]
    ref = RR.coloring_memory_projection(*args, **kw)
    got = TR.coloring_memory_projection(*args, **kw)
    assert got.keys() == ref.keys()
    rb, gb = ref["per_shard_bytes"], got["per_shard_bytes"]
    for k in SAME:
        assert gb[k] == rb[k], k
    # the differences, each one
    assert set(gb) - set(rb) == {"n_local"} and set(rb) <= set(gb)
    assert gb["gvid"] == 0 and rb["gvid"] == rb["prio"]
    assert gb["n_local"] == 4
    assert got["total_per_shard"] == ref["total_per_shard"] - rb["gvid"] + 4
    assert got["promoted_extra_bytes"] * 2 == ref["promoted_extra_bytes"]
    for k in ("n_global", "P", "n_local_max", "maxd", "maxd2", "batch",
              "id_dtype", "ell_dtype", "promoted"):
        assert got[k] == ref[k], k
    assert got["promoted"] == (name == "promoted")
    assert got["hbm_fraction"] == got["total_per_shard"] / TR.HBM_BYTES


PARTITIONS = {
    "d1-P4": (("rmat_er", (9, 8), 1), 4, 1),
    "d1-P8-good": (("rmat_good", (10, 8), 2), 8, 1),
    "d2-P4": (("grid3d", (8, 8, 8), None), 4, 2),
    "d1-P1": (("rmat_er", (8, 8), 3), 1, 1),
    "d1-P3": (("rmat_er", (8, 8), 3), 3, 1),
}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_projection_names_every_device_array(name, sparse):
    (gen, args, seed), P, halo = PARTITIONS[name]
    g = getattr(T.rmat, gen)(*args, **({} if seed is None else
                                       dict(seed=seed)))
    pg = T.partition_graph(g, P, halo=halo)
    arrs = T.to_device(pg, "cpu", sparse=sparse)
    proj = TR.projection_of(pg, batch=2, sparse=sparse)
    got = TR.device_bytes(arrs)
    named = {k for keys in TR.DEVICE_ARRAYS.values() for k in keys}
    assert set(arrs) <= named               # every tensor is counted
    per = proj["per_shard_bytes"]
    assert {k: per[k] for k in got} == got
    assert per["views"] == 2 * pg.n_slots * 4
    assert sum(got.values()) * P == sum(t.numel() * t.element_size()
                                        for t in arrs.values())


def _ref_record(scale: int, P: int) -> dict:
    g = R.rmat.rmat_er(scale, 8, seed=1)
    pg = R.partition_graph(g, P)
    plan = pg.comm_plan
    from repro.core.comm import allgather_bytes_per_exchange
    return dict(
        graph=dict(n=g.n, m=g.m, P=P, n_local_max=pg.n_local_max,
                   max_boundary=pg.max_boundary, max_ghost=pg.max_ghost,
                   max_send=plan.max_send),
        sparse=dict(n_rounds=len(plan.shifts),
                    modeled_bytes_per_exchange=plan.bytes_per_exchange(),
                    padded_bytes_per_exchange=plan.bytes_per_exchange(
                        padded=True),
                    allgather_modeled_bytes_per_exchange=(
                        allgather_bytes_per_exchange(P, pg.max_boundary)),
                    scheme_decision=R.resolve_scheme("auto", pg)),
        wire16=dict(modeled_bytes_per_exchange=plan.bytes_per_exchange(2),
                    padded_bytes_per_exchange=plan.bytes_per_exchange(
                        2, padded=True),
                    allgather_modeled_bytes_per_exchange=(
                        allgather_bytes_per_exchange(P, pg.max_boundary,
                                                     2))))


@pytest.mark.parametrize("scale,P", [(10, 8), (10, 16)])
def test_dryrun_record_plan_fields_match_the_reference(scale, P):
    rec = dryrun.coloring_record(scale, P)
    ref = _ref_record(scale, P)
    assert rec["graph"] == ref["graph"]
    assert {k: rec["sparse"][k] for k in ref["sparse"]} == ref["sparse"]
    assert rec["wire16"] == ref["wire16"]
    assert rec["mesh2d"]["axes"] == [["batch", 2], ["workers", P]]
    proj = rec["projection"]["sparse"]
    assert proj["P"] == P and proj["n_local_max"] == ref["graph"][
        "n_local_max"]


def test_dryrun_matches_the_committed_rmat18_record(tmp_path):
    """The production cell (P=256), against the reference's record."""
    ref = json.loads((REPO_ROOT / "experiments" / "dryrun" /
                      "coloring__rmat18__pod16x16.json").read_text())
    assert dryrun.main(["--coloring", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "coloring__rmat18__pod16x16.json")
                     .read_text())
    assert rec["graph"] == ref["graph"]
    for k in ("n_rounds", "modeled_bytes_per_exchange",
              "padded_bytes_per_exchange",
              "allgather_modeled_bytes_per_exchange", "scheme_decision"):
        assert rec["sparse"][k] == ref["sparse"][k], k
    # the signature's plan fields (the committed record predates ``axes``)
    fields = lambda s: {kv.split("=")[0]: kv.split("=", 1)[1]
                        for kv in s.split(" rungs=")[0].split()}
    sig, rsig = rec["sparse"]["plan_signature"], ref["sparse"][
        "plan_signature"]
    assert sig.split(" rungs=")[1] == rsig.split(" rungs=")[1]
    assert {k: v for k, v in fields(sig).items() if k != "axes"} == fields(
        rsig)
    assert rec["mesh2d"]["axes"] == [["batch", 2], ["workers", 256]]
    p = rec["projection"]["sparse"]["per_shard_bytes"]
    assert p["send_slot"] == ref["sparse"]["n_rounds"] * ref["graph"][
        "max_send"] * 4
    # a second call reads the record back
    assert dryrun.dryrun_coloring(multi_pod=False, out_dir=tmp_path) == rec
    assert np.isclose(rec["projection"]["allgather"]["hbm_fraction"],
                      rec["projection"]["allgather"]["total_per_shard"]
                      / TR.H100_80GB_HBM_BYTES)


def test_model_flops_is_the_reference_count():
    """``model_flops`` (6·N·D to train, 2·N·D to infer, N the active
    parameters) equals the reference's for every architecture and shape."""
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import get_arch as r_get_arch
    from repro_torch.configs import SHAPES, get_arch, list_archs
    for name in list_archs():
        for key in SHAPES:
            assert TR.model_flops(get_arch(name), SHAPES[key]) == \
                RR.model_flops(r_get_arch(name), R_SHAPES[key]), (name, key)
    qwen = get_arch("qwen3-0.6b")
    from repro_torch.configs import ShapeConfig
    assert TR.model_flops(qwen, ShapeConfig("t", "train", 1024, 8)) == \
        6.0 * qwen.n_params() * 8 * 1024
