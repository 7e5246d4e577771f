"""key-reuse: one ``repro_torch.rng`` key consumed twice without a
``fold_in``/``split`` in between.

The port keeps RAND, Random-X and the service bitwise equal to the
reference by drawing every stream from explicit threefry keys
(``src/repro_torch/rng.py``).  A replayed key makes "independent" draws
identical — validity tests still pass, the colors quietly get worse, and
the parity with the reference is lost.  Two patterns fire, as in the
reference's rule:

1. **linear reuse** — within one function, a key-typed name is consumed a
   second time without being re-derived or re-bound since its first
   consumption;
2. **loop reuse** — a consumption inside a ``for``/``while`` of a key
   that is never re-derived inside the loop (the fix is ``ik =
   rng.fold_in(key, i)`` per iteration).

What consumes a key:

- the samplers ``rng.bits(key, n)`` and ``rng.permutation(key, n)`` (the
  receiver is the ``repro_torch.rng`` module, however imported: a numpy
  ``Generator`` that happens to be named ``rng`` is not it);
- every ``repro_torch`` function that takes a key and draws from it
  (``color_lanes``, ``permutation_rank``, ``pipeline_sim``, …): a
  parameter draws when it, or a value derived from it (``fold_in``,
  ``split``, indexing, plain assignment), reaches a sampler or a drawing
  parameter of another such function — across modules of the package.

``fold_in``/``split`` derive fresh keys and never consume; ``rng.key``
makes one.  Only names proven key-typed are tracked (made by ``key``,
``fold_in`` or ``split``, or parameters named like keys), so ordinary
tensors passed to two functions never fire.
"""
from __future__ import annotations

import ast
import re

from .findings import Finding

SAMPLERS = {"bits", "permutation"}
DERIVERS = {"split", "fold_in"}
MAKERS = {"key"}
RNG_MODULE = "repro_torch.rng"
KEYLIKE_PARAM = re.compile(r"(^|_)(key|keys|rng|prngkey)s?($|\d)", re.I)


class _Draws:
    """Which parameters of the package's functions draw from their key:
    ``params(info, fn) -> set of parameter names``, a fixpoint over the
    call graph (recursion starts at "draws nothing")."""

    def __init__(self):
        self._memo: dict[int, set] = {}
        self._busy: set[int] = set()

    def rng_kind(self, info, call: ast.Call) -> str | None:
        """"sampler"/"deriver"/"maker" for a call into ``rng``."""
        f = call.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name not in SAMPLERS | DERIVERS | MAKERS or not _from_rng(info, f):
            return None
        return ("sampler" if name in SAMPLERS else
                "deriver" if name in DERIVERS else "maker")

    def callee(self, info, call: ast.Call):
        """``(info, FunctionDef)`` of a package function the call reaches,
        outside ``rng`` itself."""
        got = info.resolve_attr(call.func)
        if got is None or got[0] != "func" or got[1].name == RNG_MODULE:
            return None
        return got[1], got[2]

    def drawn_args(self, info, call: ast.Call) -> list[ast.expr]:
        """The argument expressions a call consumes as keys."""
        kind = self.rng_kind(info, call)
        if kind == "sampler":
            return list(call.args[:1]) + [k.value for k in call.keywords
                                          if k.arg in ("k", "key")]
        if kind is not None:
            return []
        got = self.callee(info, call)
        if got is None:
            return []
        cinfo, fn = got
        draws = self.params(cinfo, fn)
        if not draws:
            return []
        names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        out = [a for n, a in zip(names, call.args) if n in draws]
        return out + [k.value for k in call.keywords if k.arg in draws]

    def params(self, info, fn) -> set:
        key = id(fn)
        if key in self._memo:
            return self._memo[key]
        if key in self._busy:
            return set()
        self._busy.add(key)
        try:
            out = self._params(info, fn)
        finally:
            self._busy.discard(key)
        self._memo[key] = out
        return out

    def _params(self, info, fn) -> set:
        params = [a.arg for a in (fn.args.posonlyargs + fn.args.args
                                  + fn.args.kwonlyargs)]
        # names derived from each parameter (plain data flow, in order)
        taint = {p: {p} for p in params}
        for _ in range(2):
            for n in ast.walk(fn):
                if isinstance(n, (ast.Assign, ast.AnnAssign)) and \
                        n.value is not None:
                    used = _names(n.value)
                    tgts = n.targets if isinstance(n, ast.Assign) else [
                        n.target]
                    new = {m.id for t in tgts for m in ast.walk(t)
                           if isinstance(m, ast.Name)}
                    for p in params:
                        if used & taint[p]:
                            taint[p] |= new
        out = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                for a in self.drawn_args(info, n):
                    used = _names(a)
                    out |= {p for p in params if used & taint[p]}
        return out


def _from_rng(info, f: ast.expr) -> bool:
    """Is the called name an attribute of, or imported from, the
    ``repro_torch.rng`` module (read off the import table, so it holds
    where the module's file is not at hand)?"""
    rng_names = {("module", RNG_MODULE),
                 ("symbol", RNG_MODULE.rsplit(".", 1)[0], "rng")}
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return info.imports.get(f.value.id) in rng_names
    if isinstance(f, ast.Name):
        if info.name == RNG_MODULE:
            return f.id in info.funcs      # inside rng itself
        imp = info.imports.get(f.id)
        return imp is not None and imp[:2] == ("symbol", RNG_MODULE)
    return False


def _names(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _FuncScan:
    """Linear consumed-state scan of one function body."""

    def __init__(self, path: str, info, draws: _Draws,
                 findings: list[Finding]):
        self.path = path
        self.info = info
        self.draws = draws
        self.findings = findings
        # name -> line of first consumption (None = tracked, not consumed)
        self.state: dict[str, int | None] = {}

    def _key_args(self, call: ast.Call) -> list[str]:
        return [a.id for a in self.draws.drawn_args(self.info, call)
                if isinstance(a, ast.Name)]

    def _fresh(self, value: ast.expr) -> bool:
        """Is ``value`` a made or derived key (``rng.split(k).unbind(-2)``
        included)?"""
        while isinstance(value, ast.Call):
            if self.draws.rng_kind(self.info, value) in ("maker", "deriver"):
                return True
            f = value.func
            value = f.value if isinstance(f, ast.Attribute) else None
        return False

    def handle_call(self, call: ast.Call) -> None:
        for name in self._key_args(call):
            if name not in self.state:
                continue
            first = self.state[name]
            if first is not None:
                self.findings.append(Finding(
                    self.path, call.lineno, "key-reuse",
                    f"key '{name}' consumed again without fold_in/split "
                    f"(first consumed on line {first})"))
            else:
                self.state[name] = call.lineno

    def handle_assign(self, targets: list[ast.expr],
                      value: ast.expr) -> None:
        fresh = self._fresh(value)
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    if fresh:
                        self.state[n.id] = None
                    else:
                        self.state.pop(n.id, None)

    def scan(self, stmts: list[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue                  # nested defs scanned separately
            if isinstance(st, ast.If):
                # consumption on exclusive arms is not a replay
                self._visit_expr(st.test)
                pre = dict(self.state)
                self.scan(st.body)
                s1 = self.state
                self.state = dict(pre)
                self.scan(st.orelse)
                s2 = self.state
                merged = {}
                for n in set(s1) | set(s2):
                    a, b = s1.get(n, pre.get(n)), s2.get(n, pre.get(n))
                    merged[n] = a if a is not None else b
                self.state = merged
            elif isinstance(st, (ast.For, ast.While)):
                self._scan_loop(st)
            elif isinstance(st, ast.Try):
                for body in [st.body] + [h.body for h in st.handlers] + [
                        st.orelse, st.finalbody]:
                    self.scan(body)
            elif isinstance(st, ast.Assign):
                self._visit_expr(st.value)
                self.handle_assign(st.targets, st.value)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._visit_expr(st.value)
                self.handle_assign([st.target], st.value)
            elif isinstance(st, ast.With):
                self.scan(st.body)
            else:
                for n in ast.iter_child_nodes(st):
                    if isinstance(n, ast.expr):
                        self._visit_expr(n)

    def _visit_expr(self, expr: ast.expr) -> None:
        # an IfExp's arms are exclusive: a key consumed in both is drawn once
        if isinstance(expr, ast.IfExp):
            self._visit_expr(expr.test)
            pre = dict(self.state)
            self._visit_expr(expr.body)
            s1, self.state = self.state, dict(pre)
            self._visit_expr(expr.orelse)
            for n, a in s1.items():
                if self.state.get(n) is None:
                    self.state[n] = a
            return
        for n in ast.iter_child_nodes(expr):
            if isinstance(n, ast.expr) and not isinstance(n, ast.Lambda):
                self._visit_expr(n)
        if isinstance(expr, ast.Call):
            self.handle_call(expr)

    def _scan_loop(self, st: ast.For | ast.While) -> None:
        rebound: set[str] = set()
        if isinstance(st, ast.For):
            rebound |= _names(st.target)
        for n in ast.walk(st):
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in tgts:
                    rebound |= _names(t)
        for n in ast.walk(st):
            if isinstance(n, ast.Call):
                for name in self._key_args(n):
                    if name in self.state and name not in rebound:
                        self.findings.append(Finding(
                            self.path, n.lineno, "key-reuse",
                            f"key '{name}' consumed inside a loop without "
                            f"a per-iteration fold_in/split"))
        self.scan(st.body)
        self.scan(st.orelse)


def check_key_reuse(ctx) -> list[Finding]:
    findings: list[Finding] = []
    draws = _Draws()
    for fn in [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Module))]:
        scan = _FuncScan(ctx.path, ctx.info, draws, findings)
        if not isinstance(fn, ast.Module):
            for a in (list(fn.args.posonlyargs) + list(fn.args.args)
                      + list(fn.args.kwonlyargs)):
                if KEYLIKE_PARAM.search(a.arg):
                    scan.state[a.arg] = None
        scan.scan(fn.body)
    return sorted(set(findings))
