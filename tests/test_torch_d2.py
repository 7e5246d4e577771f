"""The port's distance-2 kernel entry points against the reference's, bit
for bit, and the hand-written D2 CUDA kernels against their plain versions.

``repro_torch.kernels.ops.select_colors_d2`` / ``detect_conflicts_d2``
(plain PyTorch backend on the CPU) are held against ``repro.kernels.ops``
under ``backend="xla"`` and ``"pallas"`` (the TPU kernels in interpret
mode) on the same numpy-seeded inputs; outputs are integers, tolerance 0.
The ``cuda`` cases hold the CUDA kernels against the plain versions and
run only where a GPU is present (``python -m pytest -m cuda
tests/test_torch_d2.py`` on the GPU machine, where jax is absent and the
reference cases skip).
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops

SELECTIONS = [(ops.FIRST_FIT, 0), (ops.RANDOM_X, 10), (ops.STAGGERED, 0)]
# (rows..., MAXD, MAXD2): a tile, a batched (B, V, D) tile
SHAPES = {"tile": ((300,), 21, 40), "batched": ((3, 97), 13, 29)}


def _tiles(seed, rows, maxd, maxd2, mc):
    """Random one-hop and two-hop tiles with out-of-range colors."""
    gen = np.random.default_rng(seed)
    return dict(
        nbr=gen.integers(-2, mc + 8, rows + (maxd,)).astype(np.int32),
        nbr2=gen.integers(-2, mc + 8, rows + (maxd2,)).astype(np.int32),
        active=gen.random(rows) < 0.85,
        rand=gen.integers(0, 2**32, rows, dtype=np.uint32),
        offset=gen.integers(0, mc, rows).astype(np.int32),
        prio=gen.integers(0, 10_000, rows + (maxd,)).astype(np.int32),
        prio2=gen.integers(0, 10_000, rows + (maxd2,)).astype(np.int32),
        my_prio=gen.integers(0, 10_000, rows).astype(np.int32),
        my_color=gen.integers(0, mc, rows).astype(np.int32))


def _saturation_tiles(mc=64):
    """Rows whose taken colors are split between the one-hop tile (the
    lower half) and the two-hop tile (the upper half): every legal color
    taken, only color 5 free, only color mc-2 free."""
    full = np.arange(1, mc - 1, dtype=np.int32)
    rows = np.stack([full, np.where(full == 5, 0, full),
                     np.where(full == mc - 2, 0, full)])
    half = rows.shape[1] // 2
    return dict(nbr=rows[:, :half].copy(), nbr2=rows[:, half:].copy(),
                active=np.ones(3, bool),
                rand=np.array([0, 7, 2**32 - 1], np.uint32),
                offset=np.full(3, 40, np.int32))


def _port_select(t, mc, sel, x, backend="torch", device="cpu"):
    to = lambda a: torch.from_numpy(a).to(device)
    return ops.select_colors_d2(
        to(t["nbr"]), to(t["nbr2"]), to(t["active"]),
        to(t["rand"].view(np.int32)), max_colors=mc, selection=sel, x=x,
        offset=to(t["offset"]), backend=backend)


def _port_conflicts(t, backend="torch", device="cpu"):
    args = [torch.from_numpy(t[k]).to(device)
            for k in ("my_color", "my_prio", "nbr", "prio", "nbr2", "prio2",
                      "active")]
    return ops.detect_conflicts_d2(*args, backend=backend)


@pytest.fixture(scope="module")
def ref_ops():
    """The reference's kernel entry points (they need jax)."""
    pytest.importorskip("jax")
    from repro.kernels import ops as reference
    return reference


def _ref_select(ref_ops, t, mc, sel, x, backend):
    return np.asarray(ref_ops.select_colors_d2(
        t["nbr"], t["nbr2"], t["active"], t["rand"], max_colors=mc,
        selection=sel, x=x, offset=t["offset"], backend=backend))


@pytest.mark.parametrize("sel,x", SELECTIONS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_select_d2_matches_reference(ref_ops, sel, x, shape):
    mc = 128
    t = _tiles(5, *SHAPES[shape], mc)
    got = _port_select(t, mc, sel, x).numpy()
    assert got.shape == SHAPES[shape][0]
    for backend in ("xla", "pallas"):
        np.testing.assert_array_equal(got, _ref_select(ref_ops, t, mc, sel, x,
                                                       backend))


@pytest.mark.parametrize("sel,x", SELECTIONS)
def test_select_d2_saturation_rows_match_reference(ref_ops, sel, x):
    """Color 32W-1 is the saturation sentinel, whichever tile takes the
    colors: a full row gets it, a row with one legal color left takes it."""
    mc = 64
    t = _saturation_tiles(mc)
    got = _port_select(t, mc, sel, x).numpy()
    np.testing.assert_array_equal(got, [mc - 1, 5, mc - 2])
    for backend in ("xla", "pallas"):
        np.testing.assert_array_equal(got, _ref_select(ref_ops, t, mc, sel, x,
                                                       backend))


def test_select_d2_sees_the_two_hop_tile():
    """A color taken only in the two-hop tile is not free; the same tile
    through the distance-1 entry point would take it."""
    nbr = torch.tensor([[1, 2, 0]], dtype=torch.int32)
    nbr2 = torch.tensor([[3, 5]], dtype=torch.int32)
    act = torch.ones(1, dtype=torch.bool)
    d2 = ops.select_colors_d2(nbr, nbr2, act, max_colors=64)
    d1 = ops.select_colors(nbr, act, max_colors=64)
    assert d2.tolist() == [4] and d1.tolist() == [3]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_detect_conflicts_d2_matches_reference(ref_ops, shape):
    t = _tiles(3, *SHAPES[shape], 64)
    got = _port_conflicts(t).numpy()
    assert got.any() and got.dtype == bool and got.shape == SHAPES[shape][0]
    # the two-hop tile decides some rows: the distance-1 test misses them
    d1 = ops.detect_conflicts(
        *(torch.from_numpy(t[k]) for k in ("my_color", "my_prio", "nbr",
                                           "prio", "active")),
        backend="torch").numpy()
    assert (got & ~d1).any() and not (d1 & ~got).any()
    for backend in ("xla", "pallas"):
        want = ref_ops.detect_conflicts_d2(
            t["my_color"], t["my_prio"], t["nbr"], t["prio"], t["nbr2"],
            t["prio2"], t["active"], backend=backend)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_d2_entry_points_reject_what_they_cannot_run():
    nbr = torch.zeros((4, 3), dtype=torch.int32)
    nbr2 = torch.zeros((4, 5), dtype=torch.int32)
    act = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.select_colors_d2(nbr, nbr2, act, max_colors=64, backend="cuda")
    with pytest.raises(ValueError, match="differ in their rows"):
        ops.select_colors_d2(nbr, nbr2[:3], act, max_colors=64)
    with pytest.raises(TypeError, match="int32"):
        ops.select_colors_d2(nbr, nbr2.long(), act, max_colors=64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.detect_conflicts_d2(nbr[:, 0], nbr[:, 0], nbr, nbr, nbr2, nbr2,
                                act, backend="cuda")
    assert ops.COLOR_SELECT_D2.launches == 0 and ops.CONFLICT_D2.launches == 0


def test_each_kernel_has_its_own_name_symbol_and_source():
    names = [k.name for k in ops.KERNELS]
    assert names == ["color_select", "conflict", "color_select_d2",
                     "conflict_d2", "select_run", "select_run_d2",
                     "conflict_frontier", "conflict_frontier_d2",
                     "greedy_run", "greedy_run_d2", "exchange_push"]
    assert len({k.symbol for k in ops.KERNELS}) == 11
    assert set(names) == set(build.SOURCES)
    for k in ops.KERNELS:
        src = (build.CSRC / build.SOURCES[k.name]).read_text()
        assert re.search(r"__global__ void (__launch_bounds__\([^)]*\)\s*)?"
                         rf"{k.name}_kernel\(", src)
        assert f'extern "C" int {k.symbol}(' in src
    # the profiler tells the kernels apart by these names
    for a in names:
        for b in names:
            assert (a + "_kernel" in b + "_kernel") == (a == b)


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header must rebuild every library, even
    though no ``.cu`` source changed."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = tmp_path / "select_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    assert all(after[n].name.startswith(n + "-") for n in build.SOURCES)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# the grid3d 27-point stencil's main-path shapes: P·tile speculative tiles,
# P·chunk recolor chunks (MAXD=26, MAXD2=98, max_colors=1024)
CUDA_SHAPES = dict(SHAPES, spec_tile=((256,), 26, 98),
                   recolor_chunk=((4096,), 26, 98))


@pytest.mark.cuda
@pytest.mark.parametrize("sel,x", SELECTIONS)
@pytest.mark.parametrize("shape", list(CUDA_SHAPES))
def test_cuda_select_d2_matches_plain(cuda_device, sel, x, shape):
    mc = 1024 if CUDA_SHAPES[shape][2] > 50 else 128
    t = _tiles(11, *CUDA_SHAPES[shape], mc)
    before = ops.COLOR_SELECT_D2.launches
    got = _port_select(t, mc, sel, x, "cuda", cuda_device)
    assert ops.COLOR_SELECT_D2.launches == before + 1
    want = _port_select(t, mc, sel, x, "torch", cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sel,x", SELECTIONS)
def test_cuda_select_d2_saturation_rows(cuda_device, sel, x):
    got = _port_select(_saturation_tiles(64), 64, sel, x, "cuda", cuda_device)
    assert got.tolist() == [63, 5, 62]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["tile", "batched", "conflict_chunk"])
def test_cuda_conflict_d2_matches_plain(cuda_device, shape):
    shapes = dict(SHAPES, conflict_chunk=((8192,), 26, 98))
    t = _tiles(13, *shapes[shape], 64)
    before = ops.CONFLICT_D2.launches
    got = _port_conflicts(t, "cuda", cuda_device)
    assert ops.CONFLICT_D2.launches == before + 1
    assert torch.equal(got, _port_conflicts(t, "torch", cuda_device))
    args = [torch.from_numpy(t[k]).to(cuda_device)
            for k in ("my_color", "my_prio", "nbr", "prio", "nbr2", "prio2",
                      "active")]
    args[5] = args[5].long()
    with pytest.raises(TypeError, match="int32 priorities"):
        ops.detect_conflicts_d2(*args, backend="cuda")
