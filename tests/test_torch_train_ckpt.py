"""The port's checkpoints (``repro_torch.train.checkpoint``): the
reference's cases (``tests/test_train.py`` ``TestCheckpoint``), the
on-disk format in both directions against the reference's, an async
snapshot that a later in-place update cannot reach, and the elastic
restore (the reference's ``tests/test_sharded_subprocess.py`` case:
saved on rank 0 of a 2-rank gloo world, restored in a 4-rank one).
"""
import json
import tempfile
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import test_torch_world as W
from repro.train import checkpoint as RC
from repro_torch.models.layers import tree_map
from repro_torch.train import checkpoint as ckpt
from test_torch_threads import one_torch_thread  # noqa: F401


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"params": {"a": torch.from_numpy(
        r.normal(size=(4, 4)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(r.integers(0, 9, 7))}},
        "opt": {"count": torch.tensor(3, dtype=torch.int32)}}


class TestCheckpoint:
    """The reference's checkpoint cases on the port."""

    def test_roundtrip(self):
        with tempfile.TemporaryDirectory() as td:
            tree = _tree()
            ckpt.save(td, 7, tree)
            step, back = ckpt.restore(td)
            assert step == 7
            assert torch.equal(back["params"]["a"], tree["params"]["a"])
            assert torch.equal(back["params"]["nested"]["b"],
                               tree["params"]["nested"]["b"])
            assert back["opt"]["count"].dtype == torch.int32
            assert back["opt"]["count"].shape == ()

    def test_corruption_falls_back_to_older(self):
        with tempfile.TemporaryDirectory() as td:
            ckpt.save(td, 1, _tree(1))
            ckpt.save(td, 2, _tree(2))
            victim = Path(td) / "step_00000002" / "params.a.npy"
            data = bytearray(victim.read_bytes())
            data[-1] ^= 0xFF
            victim.write_bytes(bytes(data))
            assert ckpt.latest_step(td) == 1
            with pytest.raises(IOError, match="failed verification"):
                ckpt.restore(td, 2)

    def test_gc_keeps_last_n(self):
        with tempfile.TemporaryDirectory() as td:
            for s in range(5):
                ckpt.save(td, s, _tree(s), keep=2)
            dirs = sorted(p.name for p in Path(td).iterdir())
            assert dirs == ["step_00000003", "step_00000004"]

    def test_async_save(self):
        with tempfile.TemporaryDirectory() as td:
            t = ckpt.save_async(td, 11, _tree())
            t.join()
            assert ckpt.latest_step(td) == 11
            assert t.seconds is not None and t.seconds >= 0


def _mixed(seed=0):
    """float32, bfloat16 (a stacked (L, d) gain) and an int32 count, as
    numpy with ml_dtypes' bfloat16 (the reference's leaves)."""
    r = np.random.default_rng(seed)
    return {"params": {"embed": r.normal(size=(6, 4)).astype(np.float32),
                       "run0": {"norm1": {"gamma": r.normal(size=(2, 4))
                                          .astype(ml_dtypes.bfloat16)}}},
            "opt": {"count": np.int32(5),
                    "m": {"embed": r.normal(size=(6, 4)).astype(
                        ml_dtypes.bfloat16)}}}


def _port(tree):
    def one(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return tree_map(one, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_the_reference_directory_restores_with_the_same_bytes(tmp_path):
    tree = _mixed()
    RC.save(tmp_path, 3, {k: {kk: (jnp.asarray(vv) if not isinstance(vv, dict)
                                   else vv) for kk, vv in v.items()}
                          for k, v in tree.items()})
    step, back = ckpt.restore(tmp_path)
    assert step == 3
    want, got = _flat(tree), _flat(back)
    assert want.keys() == got.keys()
    for k, a in want.items():
        t = got[k]
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16, k
            assert t.view(torch.int16).numpy().tobytes() == a.tobytes(), k
        else:
            assert str(t.dtype).removeprefix("torch.") == a.dtype.name, k
            assert t.numpy().tobytes() == a.tobytes(), k
        assert tuple(t.shape) == a.shape, k


def test_the_port_directory_is_the_reference_format(tmp_path):
    tree = _mixed()
    RC.save(tmp_path / "ref", 3, tree)
    ckpt.save(tmp_path / "port", 3, _port(tree))
    rd, pd = tmp_path / "ref" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    assert sorted(p.name for p in rd.iterdir()) == sorted(
        p.name for p in pd.iterdir())
    rm = json.loads((rd / "manifest.json").read_text())
    pm = json.loads((pd / "manifest.json").read_text())
    assert rm.keys() == pm.keys() and rm["format"] == pm["format"]
    assert rm["keys"] == pm["keys"]          # shapes, dtypes, crc32s
    assert pm["keys"]["params.run0.norm1.gamma"]["dtype"] == "bfloat16"
    for p in rd.glob("*.npy"):               # byte for byte, headers too
        assert p.read_bytes() == (pd / p.name).read_bytes(), p.name
    # and the reference reads the port's directory as its own
    _, mine = RC.restore(tmp_path / "ref")
    _, theirs = RC.restore(tmp_path / "port")
    for k, a in _flat(mine).items():
        b = _flat(theirs)[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_async_snapshot_survives_a_later_update(tmp_path):
    tree = _tree()
    want = tree["params"]["a"].clone()
    t = ckpt.save_async(tmp_path, 1, tree)
    tree["params"]["a"].add_(1.0)            # the train loop moves on
    tree["opt"]["count"].add_(1)
    t.join()
    _, back = ckpt.restore(tmp_path)
    assert torch.equal(back["params"]["a"], want)
    assert int(back["opt"]["count"]) == 3


def test_nbytes_counts_every_leaf():
    tree = _port(_mixed())
    assert ckpt.nbytes(tree) == 6 * 4 * 4 + 2 * 4 * 2 + 4 + 6 * 4 * 2


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ws = {n: W.World(n, tmp_path_factory.mktemp(f"ckpt{n}")) for n in (2, 4)}
    yield ws
    for w in ws.values():
        w.close()


def test_elastic_restore_from_two_ranks_to_four(worlds, tmp_path):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    tree = {"params": {"w": x, "b": np.arange(3, dtype=np.int64)},
            "opt": {"count": np.int32(5)}}
    assert worlds[2].run(W.ckpt_save, str(tmp_path), tree, 5) == [2, 2]
    outs = worlds[4].run(W.ckpt_restore, str(tmp_path),
                         {"params": {"w": ("data",), "b": (None,)}})
    for step, back, devices, shapes in outs:
        assert step == 5 and devices == ["cpu"]
        assert shapes["params"]["w"] == (2, 8)     # this rank's rows
        assert shapes["params"]["b"] == (3,)
        np.testing.assert_array_equal(back["params"]["w"], x)
        np.testing.assert_array_equal(back["params"]["b"],
                                      tree["params"]["b"])
        assert back["opt"]["count"].dtype == np.int32
        assert int(back["opt"]["count"]) == 5
