"""id-overflow: packings of global ids kept in, or cast back to, int32.

The reference's rule (its PR 3 bug: ``u * n + v`` on int32 vertex ids
wraps once ``n * maxid`` crosses 2**31), in torch terms.  Two patterns
fire:

1. **unpromoted packing** — an additive combination of a multiplicative
   id term, ``X * S + Y`` at any nesting (``ii * ny * nz + jj * nz +
   kk``), where the product mixes an id-like name (``u``, ``v``, ``src``,
   ``row``, ``vid``, ``owner``, ``idx`` ...) with a size-like name (``n``,
   ``cols``, ``nz``, ``n_global`` ...), and no node of the expression
   promotes to 64 bits (``.long()``, ``.to(torch.int64)``,
   ``dtype=torch.int64``, ``.astype(np.int64)``) or routes through the id
   policy (``pol.id_dtype``/``ell_dtype``: ``IdPolicy`` widens exactly
   when the packing would wrap);
2. **demoted packing** — such a packing, promoted or not, cast back to
   int32 (``.to(torch.int32)``, ``.int()``, ``.type(torch.int32)``,
   ``.astype(np.int32)``): the promotion is thrown away where the ids are
   kept.  A cast to the policy's dtype is not a demotion.

Pure size-by-size arithmetic (``n_local_max * maxd``) stays quiet.
"""
from __future__ import annotations

import ast
import re

from .findings import Finding

ID_NAMES = {"u", "v", "src", "dst", "row", "rows", "col", "vid", "vids",
            "cid", "gid", "nid", "eid", "ii", "jj", "kk", "ni", "nj", "nk",
            "iu", "iv", "owner", "slot", "idx", "ids", "node", "vertex",
            "edge_src", "edge_dst", "indices", "gvid", "prio"}
SIZE_NAMES = {"n", "cols", "ncols", "grid_n", "ny", "nz", "nx", "n_global",
              "n_total", "num_nodes", "n_nodes", "width", "stride",
              "n_cols", "dim", "side", "m"}
PROMOTED = re.compile(r"int64|uint64|\blong\b|\bdouble\b|id_dtype|ell_dtype")
INT32 = re.compile(r"\bint32\b")
DEMOTERS = {"to", "type", "astype"}


def _names(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _is_promoted(node: ast.AST) -> bool:
    """Any 64-bit promotion inside the expression silences pattern 1."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in DEMOTERS | {
                    "new_tensor"}:
                if any(PROMOTED.search(ast.unparse(a)) for a in n.args):
                    return True
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if PROMOTED.search(name or ""):
                return True
            for kw in n.keywords:
                if kw.arg == "dtype" and PROMOTED.search(
                        ast.unparse(kw.value)):
                    return True
        if isinstance(n, ast.Attribute) and PROMOTED.search(n.attr):
            return True
    return False


def _id_mult(node: ast.AST) -> bool:
    """Is ``node`` (or a sub-product) an id-name times a size-name?"""
    for n in ast.walk(node):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult):
            left, right = _names(n.left), _names(n.right)
            if ((left & ID_NAMES and right & SIZE_NAMES)
                    or (right & ID_NAMES and left & SIZE_NAMES)):
                return True
    return False


def _packing(node: ast.AST) -> bool:
    """``X * S + Y`` with an id product on one side and ids on the other."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)):
        return False
    for mult, other in ((node.left, node.right), (node.right, node.left)):
        if _id_mult(mult) and _names(other) & ID_NAMES:
            return True
    return False


def _short(node: ast.AST) -> str:
    expr = ast.unparse(node)
    return expr if len(expr) <= 60 else expr[:57] + "..."


def _demotion(call: ast.Call) -> ast.AST | None:
    """The operand a call casts to int32 (``x.to(torch.int32)``,
    ``x.int()``, ``x.astype(np.int32)``), else None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "int" and not call.args:
        return f.value
    if f.attr in DEMOTERS:
        args = list(call.args) + [k.value for k in call.keywords
                                  if k.arg in ("dtype", None)]
        if any(INT32.search(ast.unparse(a)) for a in args):
            return f.value
    return None


def check_id_overflow(ctx) -> list[Finding]:
    findings = []
    covered: set[int] = set()     # descendants of an already-reported node
    for node in ast.walk(ctx.tree):
        if id(node) in covered:
            continue
        if isinstance(node, ast.Call):
            operand = _demotion(node)
            if operand is not None and any(
                    _packing(n) for n in ast.walk(operand)):
                covered.update(id(n) for n in ast.walk(node))
                findings.append(Finding(
                    ctx.path, node.lineno, "id-overflow",
                    f"id packing cast back to int32 in '{_short(node)}' "
                    f"(the promotion is lost; keep it int64 or cast to the "
                    f"id policy's dtype)"))
            continue
        if not _packing(node) or _is_promoted(node):
            continue
        covered.update(id(n) for n in ast.walk(node)
                       if isinstance(n, ast.BinOp))
        findings.append(Finding(
            ctx.path, node.lineno, "id-overflow",
            f"id packing '{_short(node)}' combines id and size without "
            f"explicit int64 promotion (wraps at 2**31)"))
    return findings
