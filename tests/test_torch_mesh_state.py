"""The LM on a mesh of gloo ranks, beyond the train step
(``tests/test_torch_mesh_train.py``): sharded serving against one rank,
checkpoints byte for byte across mesh shapes and restored onto others,
the peak memory of a sharded save, and the sharded ``Trainer``'s replay
after an injected failure.
Serving is held within the bounds of ``tests/test_torch_lm_serve.py``:
logits within 1e-5 of the largest logit, greedy tokens equal.
"""
import json
from pathlib import Path

import numpy as np
import pytest

import test_torch_world as W
import torch_mesh_cases as C
from repro_torch.models.layers import flatten
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import rel_err


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    w = W.World(8, tmp_path_factory.mktemp("state8"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    w = W.World(1, tmp_path_factory.mktemp("state1"))
    yield w
    w.close()


def test_dense_serving_on_2x2_matches_one_rank(tmp_path_factory):
    w4 = W.World(4, tmp_path_factory.mktemp("serve4"))
    try:
        outs = w4.run(C.serve, (2, 2), ("data", "model"), "qwen3-0.6b", 4, 16,
                      6, 0)
    finally:
        w4.close()
    tokens, logits = C.serve((), (), "qwen3-0.6b", 4, 16, 6, 0)
    for t, lg in outs:
        np.testing.assert_array_equal(t, tokens)
        assert rel_err(lg, logits) <= 1e-5


def _files(path: Path) -> dict:
    (step_dir,) = [p for p in path.iterdir() if p.name.startswith("step_")]
    out = {p.name: p.read_bytes() for p in step_dir.iterdir()
           if p.suffix == ".npy"}
    man = json.loads((step_dir / "manifest.json").read_text())
    out["manifest.keys"] = man["keys"]
    return out


def test_checkpoint_files_and_restore_across_mesh_shapes(world8, world1,
                                                         tmp_path):
    name = "qwen3-0.6b"
    a, b = tmp_path / "mesh", tmp_path / "one"
    assert world8.run(C.ckpt_save, (2, 4), ("data", "model"), name, str(a),
                      0, 3) == [True] * 8
    C.ckpt_save((), (), name, str(b), 0, 3)
    fa, fb = _files(a), _files(b)
    assert fa.keys() == fb.keys() and len(fa) > 10
    for k in fb:
        assert fa[k] == fb[k], k                    # byte for byte
    _, one = C.ckpt_load(str(b))
    for outs, shape in ((world8.run(C.ckpt_restore, (4, 2), ("data", "model"),
                                    name, str(a)), (4, 2)),
                        (world1.run(C.ckpt_restore, (1, 1), ("data", "model"),
                                    name, str(a)), (1, 1))):
        for step, tree, shapes in outs:
            assert step == 3
            got = flatten(tree)
            for k, v in flatten(one).items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            if shape == (4, 2):     # the embedding over model, d over data
                assert flatten(shapes)["params/embed"] == (256, 32)


def test_sharded_save_gathers_one_leaf_at_a_time(world8, tmp_path):
    """A save on ``(2, 4)`` gathers its leaves one at a time: a rank that
    does not write holds, beyond its shards, the buffers of one leaf's
    gather (measured: 3 times the largest whole leaf, as a dim gathered
    past the first is laid out again), far less than the whole tree
    (15 times that leaf); rank 0 holds the host copies it writes
    besides."""
    outs = world8.run(C.ckpt_save_peak, (2, 4), ("data", "model"),
                      "qwen3-0.6b", str(tmp_path), 0)
    for rank, peak, leaf, whole in outs:
        assert whole > 10 * leaf, (leaf, whole)
        bound = 4 * leaf + (whole if rank == 0 else 0)
        assert peak <= bound, (rank, peak, leaf, whole)


def test_sharded_trainer_replays_bitwise(world8, tmp_path):
    """A failure at step 6 restores step 4's checkpoint: steps 5 and 6 run
    again, bitwise their first pass, and the end is bitwise a run without
    the failure."""
    outs = world8.run(C.trainer, (2, 4), ("data", "model"), "qwen3-0.6b",
                      str(tmp_path / "a"), 8, (6,), 4)
    clean = world8.run(C.trainer, (2, 4), ("data", "model"), "qwen3-0.6b",
                       str(tmp_path / "b"), 8, (), 4)
    losses, restarts, params = outs[0]
    assert restarts == 1 and len(losses) == 10
    assert losses[4:6] == losses[6:8]              # steps 5, 6 replayed
    assert losses[:6] + losses[8:] == clean[0][0]
    for k, v in flatten(clean[0][2]).items():
        np.testing.assert_array_equal(flatten(params)[k], v, err_msg=k)


def test_the_training_example_runs_on_a_mesh(tmp_path_factory):
    """``examples/torch_train_lm.py`` with ``mesh=`` on a ``(2, 2)`` gloo
    world: the ranks agree, the loss falls, the failure is survived."""
    w4 = W.World(4, tmp_path_factory.mktemp("example4"))
    try:
        outs = w4.run(C.example_train, (2, 2), ("data", "model"),
                      str(tmp_path_factory.mktemp("ex_ckpt")), 20)
    finally:
        w4.close()
    losses, restarts, embed = outs[0]
    assert all(o[0] == losses for o in outs)
    assert restarts == 1 and losses[-1] < losses[0]
    assert embed == (256, 64)          # (512, 128) over model, then data
