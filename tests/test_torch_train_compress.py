"""The port's int8 error-feedback gradient compression
(``repro_torch.train.compression``) against the reference's, the
reference's cases (``tests/test_train.py`` ``TestCompression``), and the
all-reduce on gloo worlds of 2 and 4 ranks (``tests/test_torch_world.py``).

- ``quantize_int8`` / ``dequantize_int8`` / ``wire_bytes``: bitwise the
  reference's (round half to even on both sides; the ties are planted);
- on a world, every rank gets the same mean: on 2 ranks bitwise the
  float32 sum of the ranks' dequantized values over the world's size; on
  4, within the bound of a reordered float32 sum of it (gloo's ring adds
  each chunk starting at another rank); each rank's error is its local
  residual, bitwise; and the mean is within 1e-6 of the reference's
  ``compressed_psum_tree`` under ``vmap`` over the same ranks' values
  (XLA's sum of the ranks may add in another order: an ulp);
- the compressed data-parallel train step (the reference's
  ``tests/test_sharded_subprocess.py`` case) on 4 ranks: the loss of a
  linear model falls below 1e-2 in 60 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_world as W
from repro.train import compression as RCm
from repro_torch.train import compression as C
from test_torch_threads import one_torch_thread  # noqa: F401


def _x(seed=0, shape=(64, 64), scale=3.0):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    return x


def test_quantize_is_bitwise_the_reference_with_ties():
    x = _x()
    # plant exact ties: values at k + 1/2 steps of the scale
    s = np.float32(np.abs(x).max()) / np.float32(127.0)
    x[0, :8] = (np.arange(8, dtype=np.float32) - 3.5) * s
    rq, rs = RCm.quantize_int8(jnp.asarray(x))
    pq, ps = C.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert ps.numpy().tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(
        C.dequantize_int8(pq, ps).numpy(),
        np.asarray(RCm.dequantize_int8(rq, rs)))
    tree = {"a": np.zeros((1000,)), "b": {"c": np.zeros((10, 10))}}
    assert C.wire_bytes({"a": torch.zeros(1000), "b": {"c": torch.zeros(
        (10, 10))}}) == RCm.wire_bytes(tree)


def test_single_process_psum_is_the_local_round_trip():
    """Without a world, the group is this process: the mean is the
    dequantized value and the error the residual."""
    g, e = torch.from_numpy(_x(1)), torch.from_numpy(_x(2, scale=0.01))
    out, err = C.compressed_psum(g, e)
    q, s = C.quantize_int8(g + e)
    assert torch.equal(out, C.dequantize_int8(q, s))
    assert torch.equal(err, g + e - C.dequantize_int8(q, s))


class TestCompression:
    """The reference's compression cases on the port."""

    def test_quantize_bounds(self, rng):
        x = torch.from_numpy(rng.normal(0, 3, (64, 64)).astype(np.float32))
        q, s = C.quantize_int8(x)
        err = (C.dequantize_int8(q, s) - x).abs()
        assert float(err.max()) <= float(s) * 0.5 + 1e-6

    def test_ef_allreduce_preserves_mean_over_time(self, rng):
        """Error feedback: the accumulated compressed values of one rank
        converge to its gradient (the world of one process)."""
        g = torch.from_numpy(rng.normal(0, 1, (32,)).astype(np.float32))
        err = torch.zeros(32)
        acc = torch.zeros(32)
        T = 50
        for _ in range(T):
            out, err = C.compressed_psum_tree({"g": g}, {"g": err})
            out, err = out["g"], err["g"]
            acc = acc + out
        np.testing.assert_allclose((acc / T).numpy(), g.numpy(), atol=2e-3)

    def test_wire_savings(self):
        full, comp = C.wire_bytes({"a": torch.zeros(1000),
                                   "b": torch.zeros((10, 10))})
        assert full == 4 * 1100
        assert comp < full / 3.9


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ws = {n: W.World(n, tmp_path_factory.mktemp(f"comp{n}")) for n in (2, 4)}
    yield ws
    for w in ws.values():
        w.close()


def _grads(n: int, seed: int):
    r = np.random.default_rng(seed)
    g = [{"w": r.normal(0, 1, (16, 8)).astype(np.float32),
          "n": {"b": r.normal(0, 5, (8,)).astype(np.float32)}}
         for _ in range(n)]
    e = [{"w": r.normal(0, 1e-2, (16, 8)).astype(np.float32),
          "n": {"b": r.normal(0, 1e-2, (8,)).astype(np.float32)}}
         for _ in range(n)]
    return g, e


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_tree_on_a_world(worlds, n):
    g, e = _grads(n, n)
    outs = worlds[n].run(W.compressed_tree, g, e)
    deq, res = [], []
    for r in range(n):
        loc = {}
        for k, (gg, ee) in (("w", (g[r]["w"], e[r]["w"])),
                            ("b", (g[r]["n"]["b"], e[r]["n"]["b"]))):
            x = torch.from_numpy(gg) + torch.from_numpy(ee)
            q, s = C.quantize_int8(x)
            d = C.dequantize_int8(q, s)
            loc[k] = (d.numpy(), (x - d).numpy())
        deq.append({k: v[0] for k, v in loc.items()})
        res.append({k: v[1] for k, v in loc.items()})
    for k in ("w", "b"):
        total = deq[0][k]
        for r in range(1, n):
            total = total + deq[r][k]
        want = total / np.float32(n)
        # gloo's ring adds 4 ranks' chunks in another order than 0, 1, 2, 3:
        # at most the reordering bound n·eps·Σ|d| / n apart, and equal on
        # every rank
        bound = n * np.finfo(np.float32).eps * sum(
            np.abs(d[k]) for d in deq) / n
        first = outs[0][0]["w"] if k == "w" else outs[0][0]["n"]["b"]
        for r, (out, err) in enumerate(outs):
            got = out["w"] if k == "w" else out["n"]["b"]
            np.testing.assert_array_equal(got, first, err_msg=f"{k} ranks")
            if n == 2:
                np.testing.assert_array_equal(got, want, err_msg=f"{k} mean")
            else:
                assert (np.abs(got - want) <= bound).all(), f"{k} mean"
            np.testing.assert_array_equal(
                err["w"] if k == "w" else err["n"]["b"], res[r][k],
                err_msg=f"{k} error rank {r}")
    # the reference, vmapped over the same ranks
    stack = lambda trees: jax.tree.map(lambda *a: jnp.asarray(np.stack(a)),  # noqa: E731
                                       *trees)
    rout, rerr = jax.vmap(lambda gg, ee: RCm.compressed_psum_tree(gg, ee, "dp"),
                          axis_name="dp")(stack(g), stack(e))
    for r, (out, err) in enumerate(outs):
        np.testing.assert_allclose(out["w"], np.asarray(rout["w"][r]),
                                   rtol=0, atol=1e-6 * np.abs(out["w"]).max())
        np.testing.assert_array_equal(err["w"], np.asarray(rerr["w"][r]))


def test_compressed_dp_train_step_on_four_ranks(worlds):
    outs = worlds[4].run(W.compressed_dp_train, 60, 64, 1)
    assert all(o == outs[0] for o in outs)     # the loss is the world's mean
    assert outs[0][-1] < 1e-2, outs[0][-5:]
    assert outs[0][-1] < outs[0][0]
