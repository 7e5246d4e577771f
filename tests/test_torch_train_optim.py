"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's on the same numpy trees, and the port's forms of the
reference's optimizer cases (``tests/test_train.py`` ``TestOptimizer``).

Tolerances, measured over the cases below (float32 on both sides).  The
first step is bitwise the reference's in every leaf of params, m and v,
and the gradient norm is bitwise at every step.  From the second step on
m and v differ by an ulp (XLA's fused elementwise loop rounds
``b1·m + (1 − b1)·g`` otherwise than torch's separate ops), and after the
warmup the learning rate by an ulp (``torch.cos`` against XLA's ``cos``).
Held within ``REL`` = 1e-6 of each leaf's largest |value| over five steps
(measured at most 5.0e-8 on the parameters); a bfloat16 m / v leaf within
one bfloat16 step (2^-8) of its largest |value|, since float32 values an
ulp apart can round to neighbouring bfloat16 values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as RO
from repro_torch.models.layers import tree_map
from repro_torch.train import optimizer as PO
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import close_trees, numpy_tree

REL = 1e-6
BF16_STEP = 2.0 ** -8


def _tree(seed: int, scale: float = 1.0) -> dict:
    """Leaves of the LM's kinds: a matrix, a stacked ``(L, d)`` norm gain,
    a stacked ``(L, d, f)`` weight, a vector, in an unsorted dict order."""
    r = np.random.default_rng(seed)
    return {"w": (scale * r.normal(size=(6, 5))).astype(np.float32),
            "run0": {"norm1": {"gamma": (1 + scale * r.normal(size=(3, 8))
                                         ).astype(np.float32)},
                     "ffn": {"w_up": (scale * r.normal(size=(3, 8, 4))
                                      ).astype(np.float32)}},
            "b": (scale * r.normal(size=(7,))).astype(np.float32)}


def as_torch(tree):
    return tree_map(torch.from_numpy, tree)


CASES = {
    # clip inactive (grads of norm ~ 0.1, clip 1), f32 state
    "no_clip": (dict(peak_lr=1e-2, warmup_steps=2, total_steps=20), 0.01),
    # clip active (grad norm ~ 10), f32 state
    "clip": (dict(peak_lr=1e-2, warmup_steps=2, total_steps=20,
                  grad_clip=1.0), 1.0),
    # bf16 m / v, clip active
    "bf16_state": (dict(peak_lr=1e-2, warmup_steps=2, total_steps=20,
                        state_dtype="bfloat16"), 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_match_the_reference(case):
    kw, gscale = CASES[case]
    rcfg, pcfg = RO.OptConfig(**kw), PO.OptConfig(**kw)
    params = _tree(0)
    rp, pp = jax.tree.map(jnp.asarray, params), as_torch(params)
    rs, ps = RO.init_opt_state(rp, rcfg), PO.init_opt_state(pp, pcfg)
    upd = jax.jit(lambda p, g, s: RO.adamw_update(p, g, s, rcfg))
    worst = 0.0
    for step in range(5):
        g = _tree(100 + step, gscale)
        rp, rs, rinfo = upd(rp, jax.tree.map(jnp.asarray, g), rs)
        pp, ps, pinfo = PO.adamw_update(
            pp, as_torch(g), ps,
            pcfg)
        if step == 0:   # the first step is bitwise
            for name, got, want in (("params", pp, rp), ("m", ps["m"], rs["m"]),
                                    ("v", ps["v"], rs["v"])):
                for a, b in zip(PO.leaves(got), jax.tree.leaves(want)):
                    np.testing.assert_array_equal(
                        a.float().numpy(), np.asarray(b).astype(np.float32),
                        err_msg=f"{case} {name} step 0")
        worst = max(worst, close_trees(pp, rp, REL, f"{case} params {step}"))
        tol = BF16_STEP if kw.get("state_dtype") == "bfloat16" else REL
        for k in ("m", "v"):
            close_trees(ps[k], rs[k], tol, f"{case} {k} {step}")
        assert int(ps["count"]) == int(rs["count"]) == step + 1
        assert ps["count"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pinfo[k]), float(rinfo[k]),
                                       rtol=REL, err_msg=f"{case} {k}")
        if kw.get("state_dtype") == "bfloat16":
            assert ps["m"]["w"].dtype == torch.bfloat16
    print(f"{case}: worst parameter error {worst:.2e}")


def test_clip_is_active_and_stacked_gains_decay():
    """A clip of 1 really clips, and a stacked (L, d) norm gain (two
    dims) is decayed while a vector is not, as in the reference."""
    cfg = PO.OptConfig(peak_lr=1e-2, warmup_steps=0, weight_decay=1.0,
                       grad_clip=1.0)
    p = {"gamma": torch.ones((3, 4)), "b": torch.ones((4,))}
    g = {"gamma": torch.zeros((3, 4)), "b": torch.zeros((4,))}
    new, _, _ = PO.adamw_update(p, g, PO.init_opt_state(p, cfg), cfg)
    assert float(new["gamma"][0, 0]) < 1.0 and float(new["b"][0]) == 1.0
    g = {"gamma": torch.full((3, 4), 10.0), "b": torch.full((4,), 10.0)}
    _, _, info = PO.adamw_update(p, g, PO.init_opt_state(p, cfg), cfg)
    assert float(info["grad_norm"]) == pytest.approx(40.0)


def test_lr_at_matches_the_reference_at_every_step():
    cfg = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50)
    r = np.asarray(jax.vmap(lambda s: RO.lr_at(s, RO.OptConfig(**cfg)))(
        jnp.arange(60, dtype=jnp.int32)))
    p = PO.lr_at(torch.arange(60, dtype=torch.int32), PO.OptConfig(**cfg))
    np.testing.assert_allclose(p.numpy(), r, rtol=REL)


def test_global_norm_sums_in_sorted_key_order():
    tree = _tree(3, 5.0)
    want = float(RO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = PO.global_norm(as_torch(tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=REL)
    assert [t.shape for t in PO.leaves(tree)] == [
        t.shape for t in jax.tree.leaves(tree)]


def test_opt_state_defs_match_the_reference():
    from repro.models.layers import ParamDef as RParamDef
    from repro_torch.models.layers import ParamDef
    rdefs = {"w": RParamDef((4, 2), ("fsdp", "tp")),
             "n": {"g": RParamDef((3,), (None,), init="ones")}}
    pdefs = {"w": ParamDef((4, 2), ("fsdp", "tp")),
             "n": {"g": ParamDef((3,), (None,), init="ones")}}
    for dt in ("float32", "bfloat16"):
        r = RO.opt_state_defs(rdefs, RO.OptConfig(state_dtype=dt))
        p = PO.opt_state_defs(pdefs, PO.OptConfig(state_dtype=dt))
        flat_r = jax.tree.leaves(r, is_leaf=lambda t: isinstance(t, RParamDef))
        flat_p = PO.leaves(p)
        assert [(d.shape, d.dims, d.init, d.dtype) for d in flat_p] == [
            (d.shape, d.dims, d.init, d.dtype) for d in flat_r]


def test_update_leaves_its_inputs_as_they_were():
    cfg = PO.OptConfig(peak_lr=1e-2, warmup_steps=0)
    p = {"w": torch.ones((3, 3))}
    g = {"w": torch.full((3, 3), 0.5)}
    st = PO.init_opt_state(p, cfg)
    before = numpy_tree({"p": p, "s": st})
    PO.adamw_update(p, g, st, cfg)
    after = numpy_tree({"p": p, "s": st})
    np.testing.assert_array_equal(after["p"]["w"], before["p"]["w"])
    np.testing.assert_array_equal(after["s"]["m"]["w"], before["s"]["m"]["w"])
    assert int(st["count"]) == 0


class TestOptimizer:
    """The reference's ``tests/test_train.py`` optimizer cases on the
    port."""

    def test_adamw_matches_numpy_reference(self):
        cfg = PO.OptConfig(peak_lr=1e-2, warmup_steps=0, total_steps=1000,
                           weight_decay=0.0, grad_clip=1e9)
        p = {"w": torch.ones((3, 3))}
        g = {"w": torch.full((3, 3), 0.5)}
        st = PO.init_opt_state(p, cfg)
        new_p, st, info = PO.adamw_update(p, g, st, cfg)
        m = 0.1 * 0.5
        v = 0.05 * 0.25
        lr = float(PO.lr_at(torch.tensor(1, dtype=torch.int32), cfg))
        step = lr * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + cfg.eps)
        np.testing.assert_allclose(new_p["w"].numpy(), 1.0 - step, rtol=1e-5)

    def test_grad_clip(self):
        cfg = PO.OptConfig(grad_clip=1.0, warmup_steps=0)
        p = {"w": torch.zeros((4,))}
        g = {"w": torch.full((4,), 100.0)}
        _, _, info = PO.adamw_update(p, g, PO.init_opt_state(p, cfg), cfg)
        assert float(info["grad_norm"]) == pytest.approx(200.0)

    def test_lr_schedule(self):
        cfg = PO.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=110,
                           min_lr_frac=0.1)
        lr = lambda s: float(PO.lr_at(torch.tensor(s, dtype=torch.int32),  # noqa: E731
                                      cfg))
        assert lr(5) == pytest.approx(0.5)
        assert lr(10) == pytest.approx(1.0, rel=1e-3)
        assert lr(110) == pytest.approx(0.1, rel=1e-3)

    def test_weight_decay_only_on_matrices(self):
        cfg = PO.OptConfig(peak_lr=1e-2, warmup_steps=0, weight_decay=1.0,
                           grad_clip=1e9)
        p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
        g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
        new_p, _, _ = PO.adamw_update(p, g, PO.init_opt_state(p, cfg), cfg)
        assert float(new_p["w"][0, 0]) < 1.0
        assert float(new_p["b"][0]) == 1.0
