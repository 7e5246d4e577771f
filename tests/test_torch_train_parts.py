"""Shared pieces of the port's training parity tests
(``tests/test_torch_train*.py``, ``tests/test_torch_trainer.py``): the
reference's smoke configs and parameters carried across, batches of the
reference's ``host_batch`` in both packages, and the comparisons with
their tolerances.

Tolerances (float32 on both sides; the order of summation inside matmuls
and reductions differs between XLA's CPU kernels and torch's):

- ``LOSS_TOL``: the loss and each metric within 1e-5 of their own
  magnitude (measured at most 2.1e-7 over the ten architectures);
- ``GRAD_TOL``: each gradient leaf within 1e-4 of its own largest |g|
  (measured at most 9.7e-6, rwkv6's chunked scan; jamba's mamba 5.2e-6);
- ``STEP_TOL``: after one training step, each parameter leaf within 1e-5
  of its own largest |p| (measured at most 2.7e-6, where a small carried v
  magnifies the gradient's error) and each m / v leaf within ``GRAD_TOL``
  of its own largest value, as the gradients it is made of (measured at
  most 6.2e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import NO_SHARDING as R_NO_SHARDING
from repro.configs import get_arch as r_get_arch
from repro.configs import smoke_of as r_smoke_of
from repro.data import pipeline as RD
from repro.launch.mesh import make_local_mesh
from repro.models import model as RM
from repro.models.layers import ParamDef as RParamDef
from repro.train.trainer import init_params_sharded
from repro_torch.configs import get_arch, smoke_of
from repro_torch.models import params_from_numpy

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5


def configs(name: str):
    """(reference smoke config, port smoke config)."""
    return r_smoke_of(r_get_arch(name)), smoke_of(get_arch(name))


def ref_params(rcfg, seed: int = 0) -> dict:
    """The reference initialiser's parameters (one key per path), numpy."""
    mesh = make_local_mesh()
    pdefs = RM.param_defs(rcfg)
    specs = jax.tree.map(lambda d: R_NO_SHARDING.spec(d.dims, d.shape), pdefs,
                         is_leaf=lambda t: isinstance(t, RParamDef))
    return jax.tree.map(np.asarray, init_params_sharded(pdefs, mesh, specs,
                                                        seed))


def batch(rcfg, B: int, S: int, step: int = 0) -> dict:
    """The reference's ``host_batch`` of (B, S) for ``rcfg`` (numpy)."""
    dc = RD.DataConfig(vocab_size=rcfg.vocab_size, seq_len=S, global_batch=B)
    return RD.host_batch(dc, step, rcfg)


def as_port(b: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in b.items()}


def as_ref(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_tree(tree: dict, device="cpu") -> dict:
    """A numpy tree (params, or an optimizer state) as the port's."""
    return params_from_numpy(tree, device)


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().float().numpy() \
            if tree.dtype == torch.bfloat16 else tree.detach().cpu().numpy()
    return np.asarray(tree)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    return float(np.abs(got - want).max()) / scale if want.size else 0.0


def close(got, want, tol: float, what: str) -> float:
    err = rel_err(numpy_tree(got), np.asarray(want))
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"
    return err


def close_trees(got: dict, want: dict, tol: float, what: str) -> float:
    """Every leaf within ``tol`` of its own largest |value|; integer leaves
    equal.  Returns the largest relative error."""
    got, want = numpy_tree(got), jax.tree.map(np.asarray, want)
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    worst = 0.0
    for k in want:
        if isinstance(want[k], dict):
            worst = max(worst, close_trees(got[k], want[k], tol,
                                           f"{what}/{k}"))
        elif want[k].dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}/{k}")
        else:
            worst = max(worst, close(got[k], want[k], tol, f"{what}/{k}"))
    return worst


def equal_trees(a: dict, b: dict, what: str) -> None:
    """Bitwise equal trees of tensors."""
    assert a.keys() == b.keys(), (what, a.keys(), b.keys())
    for k in a:
        if isinstance(a[k], dict):
            equal_trees(a[k], b[k], f"{what}/{k}")
        else:
            assert a[k].dtype == b[k].dtype, (what, k)
            assert torch.equal(a[k], b[k]), f"{what}/{k} differs"


def check_loss_and_grads(name: str, B: int = 2, S: int = 64) -> str:
    """``loss_fn`` and its gradient in the port against
    ``jax.value_and_grad`` of the reference's, on the reference's
    parameters and a ``host_batch`` with the architecture's stubs."""
    from repro_torch.configs import NO_SHARDING
    from repro_torch.models import loss_fn
    from repro_torch.train.optimizer import value_and_grad
    rcfg, cfg = configs(name)
    rp = ref_params(rcfg)
    b = batch(rcfg, B, S)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, bb: RM.loss_fn(p, bb, rcfg, R_NO_SHARDING),
        has_aux=True))(rp, as_ref(b))
    pl, pm, pg = value_and_grad(
        lambda p, bb: loss_fn(p, bb, cfg, NO_SHARDING), port_tree(rp),
        as_port(b))
    assert pl.dtype == torch.float32 and pl.shape == ()
    le = close(pl, rl, LOSS_TOL, f"{name} loss")
    assert pm.keys() == rm.keys()
    me = max(close(torch.as_tensor(pm[k]).detach(), rm[k], LOSS_TOL,
                   f"{name} {k}") for k in rm)
    ge = close_trees(pg, rg, GRAD_TOL, f"{name} grads")
    for k, v in zip(sorted(pg), sorted(rg)):
        assert k == v
    return f"{name}: loss {le:.1e}, metrics {me:.1e}, grads {ge:.1e}"
