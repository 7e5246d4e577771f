"""The port's kernel entry points against the reference's, bit for bit.

``repro_torch.kernels.ops`` (plain PyTorch backend on the CPU) is held
against ``repro.kernels.ops`` under ``backend="xla"`` and ``"pallas"`` (the
TPU kernels in interpret mode) on the same numpy-seeded inputs.  The
``cuda`` cases hold the hand-written kernels against the plain versions and
run only where a GPU is present (``python -m pytest -m cuda
tests/test_torch_kernels.py`` on the GPU machine, where the reference and
jax are absent and their cases skip).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

SELECTIONS = [(ops.FIRST_FIT, 0), (ops.RANDOM_X, 10), (ops.STAGGERED, 0)]


def _tile(seed, shape, mc):
    gen = np.random.default_rng(seed)
    return dict(
        nbr=gen.integers(-2, mc + 8, shape).astype(np.int32),
        active=gen.random(shape[:-1]) < 0.85,
        rand=gen.integers(0, 2**32, shape[:-1], dtype=np.uint32),
        offset=gen.integers(0, mc, shape[:-1]).astype(np.int32),
        prio=gen.integers(0, 10_000, shape).astype(np.int32),
        my_prio=gen.integers(0, 10_000, shape[:-1]).astype(np.int32),
        my_color=gen.integers(0, mc, shape[:-1]).astype(np.int32))


def _port_select(t, mc, sel, x, backend="torch", device="cpu"):
    to = lambda a: torch.from_numpy(a).to(device)
    return ops.select_colors(
        to(t["nbr"]), to(t["active"]), to(t["rand"].view(np.int32)),
        max_colors=mc, selection=sel, x=x, offset=to(t["offset"]),
        backend=backend)


@pytest.fixture(scope="module")
def ref_ops():
    """The reference's kernel entry points (they need jax)."""
    pytest.importorskip("jax")
    from repro.kernels import ops as reference
    return reference


def _ref_select(ref_ops, t, mc, sel, x, backend):
    return np.asarray(ref_ops.select_colors(
        t["nbr"], t["active"], t["rand"], max_colors=mc, selection=sel, x=x,
        offset=t["offset"], backend=backend))


@pytest.mark.parametrize("sel,x", SELECTIONS)
@pytest.mark.parametrize("shape", [(300, 21), (3, 97, 13)],
                         ids=["tile", "batched"])
def test_select_matches_reference(ref_ops, sel, x, shape):
    mc = 128
    t = _tile(5, shape, mc)
    got = _port_select(t, mc, sel, x).numpy()
    assert got.shape == shape[:-1]
    for backend in ("xla", "pallas"):
        np.testing.assert_array_equal(got, _ref_select(ref_ops, t, mc, sel, x,
                                                       backend))


@pytest.mark.parametrize("sel,x", SELECTIONS)
def test_saturation_rows_match_reference(ref_ops, sel, x):
    """Color 32W-1 is the saturation sentinel: a row whose neighbours take
    every legal color gets it; a row with one legal color left takes it."""
    mc = 64
    full = np.arange(1, mc - 1, dtype=np.int32)
    rows = np.stack([full, np.where(full == 5, 0, full),
                     np.where(full == mc - 2, 0, full)])
    t = dict(nbr=rows, active=np.ones(3, bool),
             rand=np.array([0, 7, 2**32 - 1], np.uint32),
             offset=np.full(3, 40, np.int32))
    got = _port_select(t, mc, sel, x).numpy()
    np.testing.assert_array_equal(got, [mc - 1, 5, mc - 2])
    for backend in ("xla", "pallas"):
        np.testing.assert_array_equal(got, _ref_select(ref_ops, t, mc, sel, x,
                                                       backend))


@pytest.mark.parametrize("shape", [(300, 17), (3, 97, 13)],
                         ids=["tile", "batched"])
def test_detect_conflicts_matches_reference(ref_ops, shape):
    t = _tile(3, shape, 64)
    got = ops.detect_conflicts(
        torch.from_numpy(t["my_color"]), torch.from_numpy(t["my_prio"]),
        torch.from_numpy(t["nbr"]), torch.from_numpy(t["prio"]),
        torch.from_numpy(t["active"]), backend="torch").numpy()
    assert got.any() and got.dtype == bool
    for backend in ("xla", "pallas"):
        want = ref_ops.detect_conflicts(t["my_color"], t["my_prio"], t["nbr"],
                                        t["prio"], t["active"],
                                        backend=backend)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_backend_switch_rejects_what_it_cannot_run():
    nbr = torch.zeros((4, 3), dtype=torch.int32)
    act = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.select_colors(nbr, act, max_colors=64, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.select_colors(nbr, act, max_colors=64, backend="pallas")
    with pytest.raises(ValueError, match="unknown selection"):
        ops.select_colors(nbr, act, max_colors=64, selection="least_used")
    with pytest.raises(TypeError, match="int32"):
        ops.select_colors(nbr.long(), act, max_colors=64)
    assert ops.COLOR_SELECT.launches == 0 and ops.CONFLICT.launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sel,x", SELECTIONS)
@pytest.mark.parametrize("shape", [(300, 21), (3, 97, 13), (8192, 678)],
                         ids=["tile", "batched", "main_path"])
def test_cuda_select_matches_plain(cuda_device, sel, x, shape):
    mc = 1024 if shape[-1] > 100 else 128
    t = _tile(11, shape, mc)
    before = ops.COLOR_SELECT.launches
    got = _port_select(t, mc, sel, x, "cuda", cuda_device)
    assert ops.COLOR_SELECT.launches == before + 1
    want = _port_select(t, mc, sel, x, "torch", cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 17), (32768, 678)],
                         ids=["tile", "main_path"])
def test_cuda_conflict_matches_plain(cuda_device, shape):
    t = _tile(13, shape, 64)
    args = [torch.from_numpy(t[k]).to(cuda_device)
            for k in ("my_color", "my_prio", "nbr", "prio", "active")]
    got = ops.detect_conflicts(*args, backend="cuda")
    assert torch.equal(got, ops.detect_conflicts(*args, backend="torch"))
    with pytest.raises(TypeError, match="int32 priorities"):
        ops.detect_conflicts(args[0], args[1].long(), args[2],
                             args[3].long(), args[4], backend="cuda")
