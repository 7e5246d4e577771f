"""Mamba's selective scan in the port (``models.ssm.mamba_scan``: a
log-depth scan inside chunks whose length ``SCAN_CHUNK_BYTES`` sets, with
its own backward) against the reference's ``mamba_apply`` run live, and
against the port's plain version ``_mamba_scan_steps`` (the reference's
``lax.scan`` written step by step).

- ``mamba_apply`` at smoke width (jamba, d 128, di 256, d_state 16) at
  S = 1 (decode), 67 (prime: the reference's divisor search gives it
  chunks of 1), 260 and 384: ``y``, the conv state and ``h`` within
  ``FWD_TOL`` of the reference's largest value; the gradient of every
  leaf and of ``x``, ``conv_state`` and ``h_state`` under seeded
  cotangents of all three outputs, against ``jax.vjp`` of the reference,
  each within ``GRAD_TOL`` of its largest value.  Each tolerance is twice
  the largest gap measured over the four lengths, rounded up: 5.92e-7
  (``y`` at S=260) and 1.627e-6 (``w_bc``'s gradient at S=260).  Both
  stay within ``tests/test_torch_train_parts.py``'s ``LOSS_TOL`` /
  ``GRAD_TOL`` (1e-5 / 1e-4).
- The scan against ``_mamba_scan_steps`` in float64, forward and every
  input's gradient within ``F64_TOL`` (1e-12) of each one's largest
  value, with the chunk forced to 16 and 7 (several chunks, a ragged
  tail) and left to the budget; one step bitwise the plain step.
- On ``meta`` at S=4096, B 2, di 512: forward and backward of one
  ``mamba_apply`` dispatch fewer than 4·S aten ops (the per-step loop
  dispatched about 40·S), no tensor as large as one (B, S, di, ds)
  float32 tensor, and the scan's own working set (its live bytes above
  its inputs, forward and backward) stays below one such tensor.  The
  rest of ``mamba_apply`` saves (B, S, di) activations of its own (the
  conv's (B, S, di, 4) stack among them) that pass that size on their
  own at this width, so the peak is read on the scan.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import ssm as RSSM
from repro_torch.configs import NO_SHARDING as NS
from repro_torch.configs import get_arch, smoke_of
from repro_torch.launch.dryrun import StepMeter
from repro_torch.models import ssm as PSSM
from repro_torch.models.layers import flatten
from test_torch_lm_layers import RNS, T, both, cfgs, close, normal
from test_torch_threads import one_torch_thread  # noqa: F401

FWD_TOL, GRAD_TOL, F64_TOL = 1.2e-6, 3.3e-6, 1e-12


def setup(seed: int = 1):
    """Jamba's smoke Mamba block, its zero-initialised leaves drawn
    (so ``log_a``, ``dt_bias`` and ``conv_b`` are not at zero)."""
    rcfg, cfg = cfgs("jamba_v0_1_52b")
    defs = RSSM.mamba_defs(rcfg, "float32")
    defs = {k: dataclasses.replace(d, init="normal", scale=0.5)
            if d.init == "zeros" else d for k, d in defs.items()}
    rp, pp = both(defs, seed=seed)
    return rcfg, cfg, rp, pp


def inputs(cfg, B: int, S: int, seed: int):
    r = np.random.default_rng(seed)
    di = cfg.expand * cfg.d_model
    return (normal(r, (B, S, cfg.d_model), 0.5),
            normal(r, (B, cfg.d_conv - 1, di)),
            normal(r, (B, di, cfg.d_state)),
            r)


@pytest.mark.parametrize("S", [1, 67, 260, 384])
def test_mamba_apply_matches_the_reference(S):
    rcfg, cfg, rp, pp = setup()
    x, conv, h, r = inputs(cfg, 2, S, S)
    ry, (rconv, rh) = RSSM.mamba_apply(rp, x, conv, h, rcfg, RNS)
    py, (pconv, ph) = PSSM.mamba_apply(pp, T(x), T(conv), T(h), cfg, NS)
    close(py, ry, f"S={S} y", FWD_TOL)
    close(pconv, rconv, f"S={S} conv state", FWD_TOL)
    close(ph, rh, f"S={S} h state", FWD_TOL)


@pytest.mark.parametrize("S", [1, 67, 260, 384])
def test_mamba_apply_gradients_match_the_reference(S):
    rcfg, cfg, rp, pp = setup()
    x, conv, h, r = inputs(cfg, 2, S, 100 + S)
    gy = normal(r, (2, S, cfg.d_model))
    gconv, gh = normal(r, conv.shape), normal(r, h.shape)

    def ref(p, x, conv, h):
        return RSSM.mamba_apply(p, x, conv, h, rcfg, RNS)
    _, vjp = jax.vjp(ref, rp, x, conv, h)
    rg_p, rg_x, rg_conv, rg_h = vjp((gy, (gconv, gh)))

    pp = {k: v.requires_grad_() for k, v in pp.items()}
    tx, tconv, th = (T(a).requires_grad_() for a in (x, conv, h))
    py, (pconv, ph) = PSSM.mamba_apply(pp, tx, tconv, th, cfg, NS)
    loss = (py * T(gy)).sum() + (pconv * T(gconv)).sum() + (ph * T(gh)).sum()
    loss.backward()
    for k in sorted(pp):
        close(pp[k].grad, rg_p[k], f"S={S} d{k}", GRAD_TOL)
    close(tx.grad, rg_x, f"S={S} dx", GRAD_TOL)
    close(tconv.grad, rg_conv, f"S={S} dconv_state", GRAD_TOL)
    close(th.grad, rg_h, f"S={S} dh_state", GRAD_TOL)


def scan_inputs(B: int, S: int, di: int, ds: int, seed: int,
                dtype=torch.float64):
    """Seeded scan inputs: dt a softplus, A = -exp(normal), so some
    decays are near 1 and some near 0."""
    r = np.random.default_rng(seed)
    t = [np.log1p(np.exp(r.normal(size=(B, S, di)))),
         r.normal(size=(B, S, di)), r.normal(size=(B, S, ds)),
         r.normal(size=(B, S, ds)), -np.exp(r.normal(size=(di, ds))),
         r.normal(size=(B, di, ds))]
    return [torch.tensor(a, dtype=dtype).requires_grad_() for a in t], r


def rel(got, want) -> float:
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


@pytest.mark.parametrize("S,chunk", [(67, 16), (67, 7), (64, 16),
                                     (130, None), (2, 1)])
def test_scan_matches_the_plain_steps_in_float64(S, chunk):
    ins, r = scan_inputs(2, S, 8, 4, S)
    gy = torch.tensor(r.normal(size=(2, S, 8)))
    gh = torch.tensor(r.normal(size=(2, 8, 4)))
    want_y, want_h = PSSM._mamba_scan_steps(*ins)
    want_g = torch.autograd.grad((want_y * gy).sum() + (want_h * gh).sum(),
                                 ins)
    y, h = PSSM.mamba_scan(*ins, chunk=chunk)
    if chunk is not None:
        assert y.grad_fn.name() == "_MambaScanBackward"
    g = torch.autograd.grad((y * gy).sum() + (h * gh).sum(), ins)
    assert rel(y, want_y) <= F64_TOL and rel(h, want_h) <= F64_TOL
    for name, a, b in zip(("dt", "u", "B", "C", "A", "h0"), g, want_g):
        assert rel(a, b) <= F64_TOL, (name, rel(a, b))


def test_one_step_is_the_plain_step_bitwise():
    ins, _ = scan_inputs(3, 1, 16, 4, 5, torch.float32)
    y, h = PSSM.mamba_scan(*ins)
    want_y, want_h = PSSM._mamba_scan_steps(*ins)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert y.grad_fn.name() != "_MambaScanBackward"


def test_chunk_follows_the_byte_budget():
    per_step = 2 * 512 * 16 * 4
    assert PSSM.scan_chunk(2, 4096, 512, 16) == \
        PSSM.SCAN_CHUNK_BYTES // per_step
    assert PSSM.scan_chunk(2, 67, 512, 16) == 67
    assert PSSM.scan_chunk(64, 4096, 8192, 16) == 1
    assert PSSM.SCAN_CHUNK_BYTES // per_step < 4096


class OpMeter(StepMeter):
    """``StepMeter`` that also counts dispatched aten ops and keeps the
    largest storage it saw."""

    def __init__(self):
        super().__init__()
        self.ops = self.largest = 0

    def track(self, t):
        nb = super().track(t)
        self.largest = max(self.largest, nb)
        return nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return super().__torch_dispatch__(func, types, args, kwargs)


META_B, META_S, META_DI, META_DS = 2, 4096, 512, 16
WHOLE = META_B * META_S * META_DI * META_DS * 4     # one (B, S, di, ds) f32


def test_mamba_apply_on_meta_dispatches_fewer_than_4s_ops():
    cfg = dataclasses.replace(smoke_of(get_arch("jamba-v0.1-52b")),
                              d_model=META_DI // 2)
    assert cfg.expand * cfg.d_model == META_DI and cfg.d_state == META_DS

    def meta(shape):
        return torch.empty(shape, device="meta", requires_grad=True)
    p = {k: meta(d.shape) for k, d in
         flatten(PSSM.mamba_defs(cfg, "float32")).items()}
    x = meta((META_B, META_S, cfg.d_model))
    conv = meta((META_B, cfg.d_conv - 1, META_DI))
    h = meta((META_B, META_DI, META_DS))
    m = OpMeter()
    for t in (x, conv, h, *p.values()):
        m.track(t)
    m.largest = 0
    with m:
        y, (c2, h2) = PSSM.mamba_apply(p, x, conv, h, cfg, NS)
        torch.autograd.backward([y, h2],
                                [torch.empty_like(y), torch.empty_like(h2)])
    assert m.ops < 4 * META_S, m.ops
    assert m.largest < WHOLE, m.largest


def test_scan_on_meta_never_holds_a_whole_state_sequence():
    B, S, di, ds = META_B, META_S, META_DI, META_DS
    ins = [torch.empty(s, device="meta", requires_grad=True) for s in (
        (B, S, di), (B, S, di), (B, S, ds), (B, S, ds), (di, ds),
        (B, di, ds))]
    m = OpMeter()
    for t in ins:
        m.track(t)
    base, m.largest = m.live, 0
    with m:
        y, h = PSSM.mamba_scan(*ins)
        fwd = m.peak - base
        torch.autograd.backward([y, h], [torch.empty_like(y),
                                         torch.empty_like(h)])
    assert S // PSSM.scan_chunk(B, S, di, ds) >= 2
    assert fwd < WHOLE and m.peak - base < WHOLE, (fwd, m.peak - base)
    assert m.largest <= PSSM.SCAN_CHUNK_BYTES
