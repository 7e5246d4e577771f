"""The three SPMD rules, in torch terms, driven by ``uniformity.py``.

- **divergent-collective** — a collective-bearing call (a ``comm``
  reduction or gather, a ``torch.distributed`` call, an exchange, a
  function whose body communicates) under a Python ``if``, conditional
  expression, short-circuit ``and``/``or`` or ``match`` whose test is not
  shard-uniform; or a ``continue``/``return`` under such a test that
  skips the collectives after it.  A rank that skips an ``all_reduce`` its
  peers issue hangs them (NCCL) or pairs the wrong calls.
- **nonuniform-loop** — a ``for``/``while`` loop (or comprehension) whose
  bound, condition or ``break``/``return`` tests are not shard-uniform
  and whose body bears a collective: the ranks run different numbers of
  exchanges.
- **host-sync** — a host read of a tensor's value (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int/bool/float(t)``) in
  ``kernels/``: the wrappers launch and never read back.  Static reads
  (``t.shape[0]``, a Python flag) never fire.  In ``core/`` the host
  reads are the loops' control by design; the two rules above judge them.
  ``kernels/ref.py`` is out of the rule's scope: it holds the plain
  versions, which the wrappers run for tensors on the CPU (and the chip
  checks as the kernels' oracle), never on the card's main path.

What the reference's rules say that has no torch meaning:

- "python loop over a non-static bound unrolls per trace and defeats the
  program cache" (the reference's ``nonuniform-loop`` on ``_spmd`` code):
  the port traces nothing; its loops are host Python by design and its
  program cache holds per-signature state, not compiled programs.
- "``lax.cond``/``switch``/``while_loop``/``fori_loop`` predicates": the
  port has no ``lax``; Python ``if``/``while``/``for`` are judged instead.
- "host sync inside fused device code, blessed exit
  ``comm.stats_to_host``": the port has no fused program to break; the
  rule keeps its meaning only for the kernel wrappers.
"""
from __future__ import annotations

import re

from .findings import Finding

KERNELS = re.compile(r"(^|/)kernels/")
PLAIN_TWINS = re.compile(r"(^|/)kernels/ref\.py$")


def check_host_sync(ctx) -> list[Finding]:
    path = ctx.path.replace("\\", "/")
    if ctx.analysis is None or not KERNELS.search(path) or \
            PLAIN_TWINS.search(path):
        return []
    return sorted({Finding(
        ctx.path, r.line, "host-sync",
        f"host read '{r.detail}' of a tensor's value in a kernel wrapper "
        f"(wrappers launch and never read back)")
        for r in ctx.analysis.reports if r.kind == "host-sync"})


def check_divergent_collective(ctx) -> list[Finding]:
    if ctx.analysis is None:
        return []
    return sorted({Finding(
        ctx.path, r.line, "divergent-collective",
        "collective under a branch whose test is not shard-uniform (reduce "
        "the value it reads with comm.pmax/psum first, or assert the "
        "contract with comm.shard_uniform)")
        for r in ctx.analysis.reports
        if r.kind == "if" and r.bearing and not r.pred.uniform})


def check_nonuniform_loop(ctx) -> list[Finding]:
    if ctx.analysis is None:
        return []
    return sorted({Finding(
        ctx.path, r.line, "nonuniform-loop",
        "loop whose body communicates runs a trip count that is not "
        "shard-uniform (reduce its bound and exit tests over the shard "
        "group so every rank runs the same collectives)")
        for r in ctx.analysis.reports
        if r.kind == "loop" and r.bearing and not r.pred.uniform})
