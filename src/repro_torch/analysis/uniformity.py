"""Shard-uniformity dataflow for the port's host-driven loops.

The SPMD invariant of the port's mesh route (``core/comm.py``, one shard
per rank of a ``torch.distributed`` mesh): every rank of a group issues
the *same* sequence of collectives.  The reference guards it over traced
JAX (``lax.cond``, ``while_loop``, ``psum``); the port has no tracer.
Its loops are Python, steered by host reads of device values (``int(t)``,
``bool(t)``, ``.item()``, ``.tolist()``), so a rank-local read that
decides a branch or a trip count around a collective is an NCCL hang on
a world of several cards — and a one-rank world cannot show it.

The abstract value of a name is a :class:`Val`:

- ``static``  — a Python value known without reading any tensor (shapes,
  config fields, constants).  Static implies uniform.
- ``uniform`` — the same on every rank of the shard group.  Sources:
  statics; the reductions and gathers of ``core/comm.py`` (``psum``,
  ``pmax``, ``pmin``, ``lane_psum``, ``lane_pmax``, ``all_gather``,
  ``gather_lanes``, ``gather_objects``, ``root_value``), its
  ``lane_uniform`` decision, the buffers ``torch.distributed`` reduces,
  broadcasts or gathers in place, and the contract marker
  ``comm.shard_uniform(x)``.
- neither    — per-shard.  Sources: ``comm.index()``, ``comm.p``/``b``,
  ``dist.get_rank()``, received buffers (``p2p``, ``ppermute``,
  ``recv``), host clocks (``time.*``, a clock's ``now()``), and tensor
  parameters: annotated ``Tensor`` or ``dict`` (the device dict), or
  unannotated and used as a tensor (``tensor_params``).

A host read carries the uniformity of the tensor it reads.  Values also
carry ``tensor`` (may hold a tensor: what the ``host-sync`` rule judges),
``bearing`` (calling or using it runs a collective: the ``comm`` object,
an exchange, a function whose body communicates), tuple ``elems`` and
``fields`` (dict keys, dataclass fields: ``sched.n_classes``,
``stats["n_colors"]``).

The analysis is flow-sensitive with the reference's inter-procedural
devices:

- module-level functions (and, across modules of the package, the
  functions they import: ``modules.ModuleIndex``) get a memoised
  **strict summary** — return uniformity with every parameter per-shard.
  A helper that launders its result through a reduction is uniform at
  every call site.  Where the strict summary is not uniform, the callee
  is analysed again with the call site's abstract arguments (memoised).
- nested ``def``s and lambdas are analysed inline with the caller's
  environment; what they write into the enclosing scope flows back.
- the exchange objects (``make_exchange``, ``FlatExchange``,
  ``MeshExchange``) and ``run_sharded[_many]`` count as collective-bearing;
  a parameter named ``comm`` is the rank's collectives and one named
  ``exchange`` an exchange.  ``run_sharded``'s program is analysed with
  per-shard rows, uniform broadcast arguments and the ``comm``.

Host-driven control flow adds what traced code did not need:

- **implicit flows**: a value assigned under a branch or loop whose test
  is per-shard is per-shard (``if n.item(): on[lane] = False``);
- **escapes**: ``break`` and ``return`` inside a loop take part in its
  trip count (``while True: … if local: break``); ``continue`` and
  ``return`` under a per-shard test skip the collectives after them.

Parameters seed from the port's contract: every rank passes the same
host arguments (partitions, configs, orders, host arrays), and device
data is per rank.  So ``Tensor``/``dict`` annotations and unannotated
parameters the body uses as tensors are per-shard; ``ndarray`` and other
unannotated parameters are uniform host values; any other annotation
(``int``, config dataclasses) is static.  A strict summary takes every
parameter per-shard.  ``shard_uniform`` asserts the contract where a
value is uniform by construction.  Methods are analysed with ``self``
static: a service or engine object is built from the same arguments on
every rank.

The analyser records a :class:`Report` at every branch, loop and host
read; ``rules_spmd.py`` turns reports into findings.
"""
from __future__ import annotations

import ast
import builtins
import dataclasses
import re

from .modules import ModuleInfo

# ``comm`` methods that run a collective over the shard (or batch) group
COLLECTIVE_METHODS = {"psum", "pmax", "pmin", "lane_psum", "lane_pmax",
                      "lane_uniform", "all_gather", "gather_lanes",
                      "gather_objects", "root_value", "wait_lanes", "p2p",
                      "ppermute"}
# ... whose results are the same on every rank of the group
UNIFORM_METHODS = {"psum", "pmax", "pmin", "lane_psum", "lane_pmax",
                   "lane_uniform", "all_gather", "gather_lanes",
                   "gather_objects", "root_value"}
# ... whose results are this rank's own (what a peer sent it)
RECEIVED_METHODS = {"p2p", "ppermute"}
# torch.distributed calls that are collectives or point-to-point transfers
DIST_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_object",
                    "all_gather_into_tensor", "broadcast",
                    "broadcast_object_list", "reduce", "reduce_scatter",
                    "reduce_scatter_tensor", "all_to_all",
                    "all_to_all_single", "barrier", "monitored_barrier",
                    "batch_isend_irecv", "isend", "irecv", "send", "recv",
                    "gather", "scatter", "gather_object",
                    "scatter_object_list"}
# ... that leave their first argument the same on every rank
DIST_UNIFORM_OUT = {"all_reduce", "all_gather", "all_gather_object",
                    "all_gather_into_tensor", "broadcast",
                    "broadcast_object_list"}
# ... that leave their first argument this rank's own
DIST_RECEIVED_OUT = {"recv", "irecv", "reduce_scatter",
                     "reduce_scatter_tensor", "all_to_all",
                     "all_to_all_single", "scatter"}
DIST_NAMES = {"dist", "distributed"}
# calls that build or run collective-bearing objects
BEARING_CALLS = {"make_exchange", "FlatExchange", "MeshExchange",
                 "_sparse_exchange", "_allgather_exchange", "run_sharded",
                 "run_sharded_many"}
SHARDED_RUNNERS = {"run_sharded", "run_sharded_many"}
# attributes that are static whatever their base
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "itemsize",
                "layout", "requires_grad", "is_sparse"}
STATIC_METHODS = {"size", "numel", "dim", "element_size", "nelement",
                  "is_contiguous", "data_ptr", "get_device"}
# host reads of a value: their result carries the value's uniformity
HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_READ_BUILTINS = {"int", "float", "bool"}
# host clocks: each rank reads its own
CLOCK_CALLS = {"time", "perf_counter", "monotonic", "time_ns",
               "perf_counter_ns", "monotonic_ns", "now"}
# ``comm`` attributes that are this rank's own coordinates
PER_SHARD_COMM_ATTRS = {"p", "b"}
# builtins that keep static-ness through plain Python evaluation
STATIC_BUILTINS = {"len", "range", "zip", "enumerate", "tuple", "list",
                   "set", "dict", "sorted", "reversed", "min", "max", "abs",
                   "sum", "int", "float", "bool", "str", "isinstance",
                   "getattr", "hasattr", "divmod", "round", "map", "filter",
                   "frozenset", "repr", "any", "all", "print", "type"}
MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault"}
# tensor methods whose result's length depends on its values
DYNAMIC_SHAPE = {"nonzero", "unique", "unique_consecutive", "masked_select",
                 "argwhere"}
# builtins whose result is as long as their arguments
SAME_COUNT = {"list", "tuple", "sorted", "reversed", "enumerate", "zip",
              "set", "frozenset", "dict"}
TENSORISH_ANN = re.compile(r"Tensor|\bdict\b|Dict")
HOST_ARRAY_ANN = re.compile(r"ndarray")
# attributes and methods only a tensor has: a parameter used so is one
TENSOR_USES = {"shape", "dtype", "device", "is_cuda", "long", "int", "float",
               "bool", "to", "view", "reshape", "clamp", "gather", "scatter_",
               "scatter_add_", "index_put_", "sum", "amax", "amin", "any",
               "all", "numel", "dim", "size", "cpu", "tolist", "item",
               "repeat_interleave", "expand", "unsqueeze", "contiguous",
               "data_ptr", "clone", "masked_fill", "index_select", "new_zeros",
               "new_full", "flatten", "argsort", "nonzero", "cumsum", "mul_",
               "copy_", "unbind", "split", "T", "transpose", "max", "min",
               "mean", "abs", "sort", "topk", "eq", "ne", "gt", "lt", "ge",
               "le", "half", "double", "numpy"}
COMM_ANN = re.compile(r"Comm\b")
_MAX_DEPTH = 12
_MAX_PASSES = 3


@dataclasses.dataclass
class Val:
    """Abstract value: (uniform, static, tensor) bits and structure."""

    uniform: bool = False
    static: bool = False
    tensor: bool = False
    count: bool | None = None        # its length is the same on every rank
    bearing: bool = False            # calling / using it runs a collective
    comm: bool = False               # the rank's collectives object
    node: ast.AST | None = None      # FunctionDef/Lambda for callables
    env: dict | None = None          # closure environment
    owner: object | None = None      # ModuleAnalysis the node belongs to
    elems: list | None = None        # element Vals of tuples/lists
    fields: dict | None = None       # constant-key dict / object fields

    def __post_init__(self):
        if self.count is False:      # a static value has a static length
            self.static = False
        if self.static:
            self.uniform = True
        if self.count is None:       # a tensor's length is its shape
            self.count = self.uniform or self.tensor


def VS() -> Val:
    return Val(uniform=True, static=True)


def VN(tensor: bool = False) -> Val:
    return Val(tensor=tensor)


def meet(*vals: Val) -> Val:
    """Combining values: uniform/static only if every part is."""
    vals = [v if isinstance(v, Val) else VN() for v in vals]
    if not vals:
        return VS()
    return Val(uniform=all(v.uniform and v.count for v in vals),
               static=all(v.static for v in vals),
               tensor=any(v.tensor for v in vals))


def join(a: Val, b: Val) -> Val:
    """Control-flow merge: uniform only if both paths are."""
    out = Val(uniform=a.uniform and b.uniform, static=a.static and b.static,
              tensor=a.tensor or b.tensor, count=a.count and b.count,
              bearing=a.bearing or b.bearing, comm=a.comm and b.comm)
    if (a.elems is not None and b.elems is not None
            and len(a.elems) == len(b.elems)):
        out.elems = [join(x, y) for x, y in zip(a.elems, b.elems)]
    if a.fields is not None and b.fields is not None:
        out.fields = {k: join(a.fields[k], b.fields[k])
                      for k in a.fields.keys() & b.fields.keys()}
    if a.node is not None and a.node is b.node:
        out.node, out.env, out.owner = a.node, a.env, a.owner
    return out


def taint(v: Val, pc: Val) -> Val:
    """``v`` as written under control ``pc``: per-shard control makes the
    written value per-shard (an implicit flow), and run-time control
    makes it non-static."""
    if pc.static or (pc.uniform and not v.static):
        return v
    out = dataclasses.replace(v, uniform=v.uniform and pc.uniform,
                              static=False, count=v.count and pc.uniform)
    if v.elems is not None:
        out.elems = [taint(e, pc) for e in v.elems]
    if v.fields is not None:
        out.fields = {k: taint(e, pc) for k, e in v.fields.items()}
    return out


def uniformize(v: Val) -> Val:
    """``shard_uniform(v)`` / a gathered value: uniform, structure kept."""
    out = dataclasses.replace(v, uniform=True, count=True)
    if v.elems is not None:
        out.elems = [uniformize(e) for e in v.elems]
    if v.fields is not None:
        out.fields = {k: uniformize(e) for k, e in v.fields.items()}
    return out


def same(a: Val, b: Val) -> bool:
    if (a.uniform, a.static, a.tensor, a.count) != (
            b.uniform, b.static, b.tensor, b.count):
        return False
    ae, be = a.elems or [], b.elems or []
    af, bf = a.fields or {}, b.fields or {}
    return (len(ae) == len(be) and all(same(x, y) for x, y in zip(ae, be))
            and af.keys() == bf.keys()
            and all(same(af[k], bf[k]) for k in af))


def _sig(v: Val) -> tuple:
    elems = tuple(_sig(e) for e in v.elems) if v.elems is not None else None
    fields = (tuple(sorted((k, _sig(e)) for k, e in v.fields.items()))
              if v.fields is not None else None)
    return (v.uniform, v.static, v.tensor, v.count, v.bearing, v.comm,
            id(v.node), elems, fields)


@dataclasses.dataclass
class Report:
    """One analysed branch, loop or host read, for the SPMD rules."""

    kind: str          # "if" | "loop" | "host-sync"
    line: int
    pred: Val          # the test / trip control / read value
    bearing: bool      # a collective runs under this site
    detail: str = ""


def _func_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _recv_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        v = func.value
        if isinstance(v, ast.Name):
            return v.id
        if isinstance(v, ast.Attribute):
            return v.attr
    return ""


def _is_dist(func: ast.AST) -> bool:
    return (isinstance(func, ast.Attribute)
            and _recv_name(func) in DIST_NAMES)


def _commish(expr: ast.AST) -> bool:
    """A receiver named like the rank's collectives (``comm``,
    ``self._comm``, ``prog.comm``)."""
    name = (expr.attr if isinstance(expr, ast.Attribute) else
            expr.id if isinstance(expr, ast.Name) else "")
    return name.lstrip("_") == "comm"


def _all_args(a: ast.arguments) -> list[tuple[ast.arg, bool]]:
    out = [(x, False) for x in list(a.posonlyargs) + list(a.args)]
    out += [(x, True) for x in a.kwonlyargs]
    if a.vararg:
        out.append((a.vararg, False))
    if a.kwarg:
        out.append((a.kwarg, True))
    return out


def tensor_params(f) -> set[str]:
    """Parameters the body uses as tensors: a tensor's attribute or method
    on it (``TENSOR_USES``), or an argument of a ``torch`` call.  Other
    unannotated parameters (partitions, configs, flags, callables) are
    host values."""
    out = set()
    for n in ast.walk(f):
        if isinstance(n, ast.Attribute) and n.attr in TENSOR_USES:
            base = n.value.value if isinstance(n.value, ast.Subscript) \
                else n.value
            if isinstance(base, ast.Name):
                out.add(base.id)
        elif isinstance(n, ast.Call) and _recv_name(n.func) == "torch":
            out |= {a.id for a in n.args if isinstance(a, ast.Name)}
    return out


def param_seed(arg: ast.arg, kwonly: bool, strict: bool = False,
               tensor: bool = True) -> Val:
    """Seed one parameter (module docstring).  ``strict``: every parameter
    per-shard but the rank's ``comm``, an ``exchange`` and ``self``;
    ``tensor``: the body uses it as a tensor (``tensor_params``)."""
    ann = ast.unparse(arg.annotation) if arg.annotation is not None else ""
    if arg.arg == "comm" or COMM_ANN.search(ann):
        return Val(static=True, comm=True, bearing=True)
    if arg.arg == "exchange":
        return Val(static=True, bearing=True)
    if arg.arg in ("self", "cls"):
        return VN() if strict else VS()
    if strict:
        return VN(tensor=tensor and not kwonly)
    if ann:
        if TENSORISH_ANN.search(ann):
            return VN(tensor=True)
        return Val(uniform=True) if HOST_ARRAY_ANN.search(ann) else VS()
    # every rank passes the same host arguments; device data is per rank
    return VN(tensor=True) if tensor else Val(uniform=True)


class ModuleAnalysis:
    """One module: canonical collecting pass + per-function summaries."""

    def __init__(self, info: ModuleInfo, path: str = "<module>"):
        self.info = info
        self.tree = info.tree
        self.path = path
        self.funcs = info.funcs
        self.module_static = info.module_names
        self.reports: list[Report] = []
        self._strict: dict[int, Val] = {}
        self._stack: set[int] = set()
        self._bearing_memo: dict[int, bool] = {}
        self._call_memo: dict[tuple, Val] = {}

    @classmethod
    def of(cls, info: ModuleInfo) -> "ModuleAnalysis":
        """The (cached) analysis of another module of the package."""
        an = getattr(info, "_analysis", None)
        if an is None:
            an = info._analysis = cls(info, info.name)
        return an

    def run(self) -> list[Report]:
        """Canonical collecting pass over every module-level function and
        every method of every module-level class."""
        for f in self.funcs.values():
            self._canonical(f, None)
        for c in self.info.classes.values():
            for f in c.body:
                if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._canonical(f, c)
        return self.reports

    def _canonical(self, f, cls) -> None:
        used = tensor_params(f)
        env = {a.arg: param_seed(a, kw, tensor=a.arg in used)
               for a, kw in _all_args(f.args)}
        an = FuncAnalyzer(self, env, collect=True, cls=cls)
        an.exec_body(f.body)

    # ----------------------------------------------------------- summaries --
    def summary(self, f: ast.FunctionDef, args: list[Val], kws: dict,
                cls=None, depth: int = 0, collect: bool = False) -> Val:
        """Return value of ``f``: its strict summary when that is uniform,
        else ``f`` analysed with the call site's arguments.  ``collect``:
        the caller is a collecting pass, so what ``f`` does with these
        arguments is reported in ``f``'s own module (a per-shard value
        handed to a function that steers collectives with it)."""
        strict = self.strict_summary(f, cls)
        if strict.uniform and strict.elems is None and strict.fields is None:
            return strict
        if depth >= _MAX_DEPTH or id(f) in self._stack:
            return strict
        key = (id(f), collect, tuple(_sig(a) for a in args),
               tuple(sorted((k, _sig(v)) for k, v in kws.items())))
        if key in self._call_memo:
            return self._call_memo[key]
        self._stack.add(id(f))
        try:
            env = self._bind(f, args, kws, strict=False)
            an = FuncAnalyzer(self, env, collect=collect, cls=cls,
                              depth=depth + 1)
            an.exec_body(f.body)
            out = an.return_val()
        finally:
            self._stack.discard(id(f))
        self._call_memo[key] = out
        return out

    def strict_summary(self, f: ast.FunctionDef, cls=None) -> Val:
        if id(f) in self._strict:
            return self._strict[id(f)]
        if id(f) in self._stack:
            return VN(tensor=True)
        self._stack.add(id(f))
        try:
            env = {a.arg: param_seed(a, kw, strict=True)
                   for a, kw in _all_args(f.args)}
            an = FuncAnalyzer(self, env, collect=False, cls=cls, depth=1)
            an.exec_body(f.body)
            out = an.return_val()
        finally:
            self._stack.discard(id(f))
        self._strict[id(f)] = out
        return out

    def _bind(self, f, args: list[Val], kws: dict, strict: bool,
              env: dict | None = None) -> dict:
        env = {} if env is None else env
        used = tensor_params(f)
        a = f.args
        params = list(a.posonlyargs) + list(a.args)
        defaults = list(a.defaults)
        n_plain = len(params) - len(defaults)
        for i, p in enumerate(params):
            if i < len(args):
                env[p.arg] = args[i]
            elif p.arg in kws:
                env[p.arg] = kws[p.arg]
            elif i >= n_plain:
                env[p.arg] = VS() if _const(defaults[i - n_plain]) else \
                    param_seed(p, False, strict, p.arg in used)
            else:
                env[p.arg] = param_seed(p, False, strict, p.arg in used)
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if p.arg in kws:
                env[p.arg] = kws[p.arg]
            elif d is not None and _const(d):
                env[p.arg] = VS()
            else:
                env[p.arg] = param_seed(p, True, strict, p.arg in used)
        if a.vararg:
            env[a.vararg.arg] = meet(*args[len(params):]) if len(
                args) > len(params) else VS()
        if a.kwarg:
            env[a.kwarg.arg] = meet(*[v for k, v in kws.items()])
        return env

    # ------------------------------------------------------------- bearing --
    def is_bearing(self, node: ast.AST | None, env: dict | None = None,
                   _seen: set | None = None) -> bool:
        """Does executing ``node`` run a collective?"""
        if node is None:
            return False
        key = id(node)
        if key in self._bearing_memo:
            return self._bearing_memo[key]
        _seen = set() if _seen is None else _seen
        if key in _seen:
            return False
        _seen.add(key)
        found = any(self._call_bearing(n, env, _seen)
                    for n in ast.walk(node) if isinstance(n, ast.Call))
        self._bearing_memo[key] = found
        return found

    def _call_bearing(self, n: ast.Call, env, seen) -> bool:
        name = _func_name(n.func)
        if _is_dist(n.func):
            return name in DIST_COLLECTIVES
        if name in COLLECTIVE_METHODS and isinstance(n.func, ast.Attribute):
            return True
        if name in BEARING_CALLS:
            return True
        if isinstance(n.func, ast.Name) and env and isinstance(
                env.get(name), Val):
            target = env[name]
            if target.bearing:
                return True
            if target.node is not None:
                owner = target.owner or self
                return owner.is_bearing(target.node, target.env, seen)
        got = self.info.resolve_attr(n.func)
        if got is not None and got[0] == "func":
            owner = ModuleAnalysis.of(got[1]) if got[1] is not self.info \
                else self
            return owner.is_bearing(got[2], None, seen)
        if (isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "self"):
            for c in self.info.classes.values():
                for f in c.body:
                    if (isinstance(f, ast.FunctionDef) and f.name == name
                            and self.is_bearing(f, None, seen)):
                        return True
            return False
        if env:
            for a in list(n.args) + [k.value for k in n.keywords]:
                if isinstance(a, ast.Name) and isinstance(env.get(a.id), Val) \
                        and env[a.id].bearing:
                    return True
        return False


def _write(old: Val, key, v: Val) -> Val:
    """A container after ``old[key] = v`` (``key`` None: an unknown slot)."""
    if old.fields is not None and key is not None:
        return dataclasses.replace(old, fields={**old.fields, key: v})
    new = join(old, v)
    new.elems = None
    if old.fields is not None:
        new.fields = {k: join(f, v) for k, f in old.fields.items()}
    return new


def _trips(it: Val) -> Val:
    """The trip count of a loop over ``it``: its length's uniformity."""
    return Val(uniform=it.count, static=it.count and (
        it.static or it.tensor or it.elems is not None))


def _element(it: Val) -> Val:
    """One element of ``it``."""
    out = Val(uniform=it.uniform, static=it.static, tensor=it.tensor)
    for e in it.elems or ():
        out = join(out, e)
    return out


def _method(cls: ast.ClassDef, name: str):
    return next((f for f in cls.body if isinstance(f, ast.FunctionDef)
                 and f.name == name), None)


def _const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) or (
        isinstance(node, (ast.Tuple, ast.List))
        and all(isinstance(e, ast.Constant) for e in node.elts))


def _escapes(stmts: list, kind: type) -> bool:
    """Does a statement of ``stmts`` leave by ``kind`` (``ast.Continue``:
    not counting nested loops, whose continue is their own; ``ast.Return``
    from any depth)?  Nested defs never count."""
    return any(isinstance(n, kind) for st in stmts
               for n in _walk_shallow(st, loops=kind is not ast.Return))


def _walk_shallow(node, loops: bool):
    """``ast.walk`` that stops at nested defs and (``loops``) nested
    loops, whose break/continue are their own."""
    todo = [node]
    while todo:
        n = todo.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            if loops and isinstance(c, (ast.For, ast.While)):
                continue
            todo.append(c)


class FuncAnalyzer:
    """Flow-sensitive abstract interpreter of one function body."""

    def __init__(self, mod: ModuleAnalysis, env: dict, collect: bool,
                 cls=None, depth: int = 0):
        self.mod = mod
        self.env = env
        self.collect = collect
        self.cls = cls
        self.depth = depth
        self.returns: list[Val] = []
        self.pc = VS()             # control the current statement runs under
        self.rest = False          # collectives run after this statement
        self.loops: list[dict] = []  # enclosing loops: escapes, body bearing

    def report(self, kind: str, node: ast.AST, pred: Val, bearing: bool,
               detail: str = "") -> None:
        if self.collect:
            self.mod.reports.append(Report(
                kind=kind, line=getattr(node, "lineno", 0), pred=pred,
                bearing=bearing, detail=detail))

    def return_val(self) -> Val:
        if not self.returns:
            return VS()
        out = self.returns[0]
        for v in self.returns[1:]:
            out = join(out, v)
        return out

    def bearing(self, node) -> bool:
        return self.mod.is_bearing(node, self.env)

    # ----------------------------------------------------------- statements --
    def exec_body(self, stmts: list, rest: bool | None = None) -> None:
        outer = self.rest if rest is None else rest
        tails = [False] * (len(stmts) + 1)
        for i in range(len(stmts) - 1, -1, -1):
            tails[i] = tails[i + 1] or self.bearing(stmts[i])
        for i, st in enumerate(stmts):
            self.rest = tails[i + 1] or outer
            self.exec_stmt(st)
        self.rest = outer

    def exec_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, ast.Assign):
            v = self.eval(st.value)
            for t in st.targets:
                self.assign(t, v)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.assign(st.target, self.eval(st.value))
        elif isinstance(st, ast.AugAssign):
            self.assign(st.target, meet(self.eval(st.target),
                                        self.eval(st.value)))
        elif isinstance(st, ast.Return):
            v = self.eval(st.value) if st.value is not None else VS()
            self.returns.append(taint(v, self.pc))
            for lp in self.loops:
                lp["escapes"].append(self.pc)
        elif isinstance(st, (ast.Break,)):
            if self.loops:
                self.loops[-1]["escapes"].append(self.pc)
        elif isinstance(st, ast.If):
            self.exec_if(st)
        elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            self.exec_loop(st)
        elif isinstance(st, ast.Match):
            self.exec_match(st)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.env[st.name] = Val(static=True, node=st, env=self.env,
                                    owner=self.mod,
                                    bearing=self.mod.is_bearing(st,
                                                                self.env))
        elif isinstance(st, ast.Expr):
            self.eval(st.value)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                v = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, v)
            self.exec_body(st.body)
        elif isinstance(st, ast.Try):
            self.exec_body(st.body)
            for h in st.handlers:
                self.exec_body(h.body)
            self.exec_body(st.orelse)
            self.exec_body(st.finalbody)
        elif isinstance(st, (ast.Assert, ast.Raise, ast.Delete)):
            for n in ast.iter_child_nodes(st):
                if isinstance(n, ast.expr):
                    self.eval(n)
        # Pass / Import / Global / Nonlocal / Continue: nothing to track

    def assign(self, target: ast.expr, v: Val) -> None:
        v = taint(v, self.pc)
        if isinstance(target, ast.Name):
            self.env[target.id] = v
        elif isinstance(target, (ast.Tuple, ast.List)):
            elems = v.elems
            if elems is None or len(elems) != len(target.elts):
                elems = [Val(uniform=v.uniform, static=v.static,
                             tensor=v.tensor) for _ in target.elts]
            for t, e in zip(target.elts, elems):
                if isinstance(t, ast.Starred):
                    self.assign(t.value, Val(uniform=v.uniform,
                                             static=v.static))
                else:
                    self.assign(t, e)
        elif isinstance(target, ast.Attribute):
            base = target.value
            if isinstance(base, ast.Name) and base.id in self.env:
                old = self.env[base.id]
                fields = dict(old.fields or {})
                fields[target.attr] = v
                self.env[base.id] = dataclasses.replace(old, fields=fields)
            else:
                self._weak_update(target, v)
        elif isinstance(target, ast.Subscript):
            # which entries are written is data too (``a[idx] = True``)
            v = taint(v, meet(self.eval(target.slice)))
            key = (target.slice.value if isinstance(target.slice,
                                                    ast.Constant) else None)
            self._weak_update(target.value, v, key)

    def _weak_update(self, base: ast.expr, v: Val, key=None) -> None:
        """``base[key] = v`` (``key``: a constant subscript, else None) or
        ``base.x[...] = v``: write ``v`` into the container, or into the
        named field of it."""
        if isinstance(base, ast.Name) and base.id in self.env:
            self.env[base.id] = _write(self.env[base.id], key, v)
        elif (isinstance(base, ast.Attribute)
              and isinstance(base.value, ast.Name)
              and base.value.id in self.env):
            old = self.env[base.value.id]
            fields = dict(old.fields or {})
            prev = fields.get(base.attr, Val(uniform=old.uniform,
                                             static=old.static,
                                             tensor=old.tensor))
            fields[base.attr] = _write(prev, key, v)
            self.env[base.value.id] = dataclasses.replace(old, fields=fields)
        elif isinstance(base, (ast.Subscript, ast.Attribute)):
            self._weak_update(base.value, v)

    def _branches(self, test: Val, arms: list) -> None:
        """Run each arm from the same state under ``pc ∧ test`` and join."""
        before, pc0 = dict(self.env), self.pc
        outs = []
        for arm in arms:
            self.env = dict(before)
            self.pc = meet(pc0, test) if not test.static else pc0
            self.exec_body(arm)
            outs.append(self.env)
        self.pc = pc0
        merged = dict(before)
        for name in set().union(*[set(o) for o in outs]):
            vals = [o.get(name, before.get(name, VN())) for o in outs]
            out = vals[0]
            for x in vals[1:]:
                out = join(out, x)
            merged[name] = out
        self.env = merged

    def _arm_bearing(self, arms: list) -> bool:
        stmts = [s for arm in arms for s in arm]
        if any(self.bearing(s) for s in stmts):
            return True
        if self.loops and _escapes(stmts, ast.Continue) and \
                self.loops[-1]["bearing"]:
            return True
        return bool(_escapes(stmts, ast.Return) and self.rest)

    def exec_if(self, st: ast.If) -> None:
        test = meet(self.eval(st.test))       # a container's truth: its length
        self.report("if", st, test, self._arm_bearing([st.body, st.orelse]))
        self._branches(test, [st.body, st.orelse])

    def exec_match(self, st: ast.Match) -> None:
        subject = self.eval(st.subject)
        arms = [c.body for c in st.cases]
        self.report("if", st, subject, self._arm_bearing(arms))
        self._branches(subject, arms + [[]])

    def exec_loop(self, st) -> None:
        is_for = isinstance(st, (ast.For, ast.AsyncFor))
        it = self.eval(st.iter) if is_for else None
        bound = _trips(it) if is_for else meet(self.eval(st.test))
        body_bearing = any(self.bearing(s) for s in st.body)
        pc0, control = self.pc, bound
        frame = dict(escapes=[], bearing=body_bearing)
        self.loops.append(frame)
        for _ in range(_MAX_PASSES):
            before = dict(self.env)
            frame["escapes"] = []
            self.pc = meet(pc0, control) if not control.static else pc0
            if is_for:
                self.assign(st.target, _element(it))
            else:
                bound = meet(self.eval(st.test))
            self.exec_body(st.body, rest=self.rest or body_bearing)
            for name, v in list(self.env.items()):
                if name in before:
                    self.env[name] = join(before[name], v)
            new = meet(bound, *frame["escapes"])
            if same(new, control) and all(
                    same(before.get(n, v), v) for n, v in self.env.items()):
                break
            control = new
        self.loops.pop()
        self.pc = pc0
        self.report("loop", st, control, body_bearing)
        if not control.static:     # how long it ran decides what it left
            for name, v in list(self.env.items()):
                self.env[name] = taint(v, control)
        self.pc = meet(pc0, control) if not control.static else pc0
        self.exec_body(st.orelse)
        self.pc = pc0

    # ---------------------------------------------------------- expressions --
    def eval(self, node: ast.expr | None) -> Val:
        if node is None:
            return VS()
        if isinstance(node, ast.Constant):
            return VS()
        if isinstance(node, ast.Name):
            return self.eval_name(node.id)
        if isinstance(node, ast.Attribute):
            return self.eval_attr(node)
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            idx = self.eval(node.slice)
            s = node.slice
            if (base.elems is not None and isinstance(s, ast.Constant)
                    and isinstance(s.value, int)
                    and -len(base.elems) <= s.value < len(base.elems)):
                return base.elems[s.value]
            if (base.fields is not None and isinstance(s, ast.Constant)
                    and s.value in base.fields):
                return base.fields[s.value]
            return meet(base, idx)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            elems = [self.eval(e) for e in node.elts]
            v = meet(*elems) if elems else VS()
            return Val(uniform=v.uniform, static=v.static, tensor=v.tensor,
                       count=True,
                       elems=elems if not isinstance(node, ast.Set) else None)
        if isinstance(node, ast.Dict):
            keys = [self.eval(k) for k in node.keys if k is not None]
            vals = [self.eval(v) for v in node.values]
            v = meet(*(keys + vals)) if vals else VS()
            out = Val(uniform=v.uniform, static=v.static, tensor=v.tensor)
            if all(isinstance(k, ast.Constant) for k in node.keys):
                out.fields = {k.value: x for k, x in zip(node.keys, vals)}
            return out
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.Compare):
            if (len(node.ops) == 1 and isinstance(node.ops[0],
                                                  (ast.Is, ast.IsNot))):
                # `x is None`: whether a value was passed, not what it holds
                left = self.eval(node.left)
                right = self.eval(node.comparators[0])
                return Val(uniform=left.uniform and right.uniform,
                           static=True) if any(
                    isinstance(s, ast.Constant) and s.value is None
                    for s in (node.left, node.comparators[0])) else meet(
                        left, right)
            if (len(node.ops) == 1 and isinstance(node.ops[0],
                                                  (ast.In, ast.NotIn))):
                # a key of a device dict: its structure, not its tensors
                left = self.eval(node.left)
                right = self.eval(node.comparators[0])
                if right.tensor:
                    return Val(uniform=left.uniform and right.count)
                return meet(left, right)
            return meet(self.eval(node.left),
                        *[self.eval(c) for c in node.comparators])
        if isinstance(node, ast.BoolOp):
            vals = [meet(self.eval(node.values[0]))]
            for later in node.values[1:]:
                # later operands run only as the earlier ones decide
                if self.bearing(later):
                    self.report("if", node, meet(*vals), True)
                vals.append(self.eval(later))
            return meet(*vals)
        if isinstance(node, ast.BinOp):
            return meet(self.eval(node.left), self.eval(node.right))
        if isinstance(node, ast.UnaryOp):
            return meet(self.eval(node.operand))
        if isinstance(node, ast.IfExp):
            test = meet(self.eval(node.test))
            self.report("if", node, test,
                        self.bearing(node.body) or self.bearing(node.orelse))
            return taint(join(self.eval(node.body), self.eval(node.orelse)),
                         test)
        if isinstance(node, ast.Lambda):
            return Val(static=True, node=node, env=self.env, owner=self.mod,
                       bearing=self.mod.is_bearing(node, self.env))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self.eval_comp(node)
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, ast.JoinedStr):
            return meet(*[self.eval(v.value) for v in node.values
                          if isinstance(v, ast.FormattedValue)] or [VS()])
        if isinstance(node, ast.Slice):
            return meet(self.eval(node.lower), self.eval(node.upper),
                        self.eval(node.step))
        if isinstance(node, ast.NamedExpr):
            v = self.eval(node.value)
            self.assign(node.target, v)
            return v
        if isinstance(node, (ast.Await, ast.Yield, ast.YieldFrom)):
            return self.eval(node.value)
        return VN()

    def eval_name(self, name: str) -> Val:
        if name in self.env:
            return self.env[name]
        got = self.mod.info.resolve(name)
        if got is not None and got[0] == "func":
            owner = self._owner(got[1])
            return Val(static=True, node=got[2], env=None, owner=owner,
                       bearing=owner.is_bearing(got[2]))
        if (name in self.mod.module_static or name in STATIC_BUILTINS
                or hasattr(builtins, name)):
            return VS()
        return VN()

    def eval_attr(self, node: ast.Attribute) -> Val:
        if node.attr in STATIC_ATTRS:
            self.eval(node.value)
            return VS()
        base = self.eval(node.value)
        if base.fields is not None and node.attr in base.fields:
            return base.fields[node.attr]
        if base.comm or _commish(node.value):
            if node.attr in PER_SHARD_COMM_ATTRS:
                return VN()
            return VS()
        return Val(uniform=base.uniform, static=base.static,
                   tensor=base.tensor)

    def eval_comp(self, node) -> Val:
        env0, pc0 = dict(self.env), self.pc
        parts = []
        elems = []
        for gen in node.generators:
            it = self.eval(gen.iter)
            parts.append(_trips(it))
            elems.append(it)
            self.assign(gen.target, _element(it))
            parts.extend(self.eval(c) for c in gen.ifs)
        control = meet(*parts) if parts else VS()
        elt_nodes = ([node.key, node.value] if isinstance(node, ast.DictComp)
                     else [node.elt])
        if any(self.bearing(e) for e in elt_nodes):
            self.report("loop", node, control, True)
        self.pc = meet(pc0, control) if not control.static else pc0
        elt = meet(*[self.eval(e) for e in elt_nodes])
        self.env, self.pc = env0, pc0
        v = meet(elt, *elems)
        return Val(uniform=v.uniform, static=v.static, tensor=elt.tensor,
                   count=control.uniform)

    # ---------------------------------------------------------------- calls --
    def _owner(self, info: ModuleInfo) -> ModuleAnalysis:
        return self.mod if info is self.mod.info else ModuleAnalysis.of(info)

    def eval_call(self, node: ast.Call) -> Val:
        func = node.func
        name = _func_name(func)
        args = [self.eval(a) for a in node.args]
        kws = {k.arg: self.eval(k.value) for k in node.keywords if k.arg}
        for k in node.keywords:
            if k.arg is None:
                self.eval(k.value)
        allv = args + list(kws.values())

        if name == "shard_uniform":
            return uniformize(args[0]) if args else VS()
        if _is_dist(func):
            return self.eval_dist(node, name, args)
        recv = self.eval(func.value) if isinstance(func, ast.Attribute) \
            else None
        if recv is not None and (recv.comm or _commish(func.value)):
            got = self.eval_comm(name, args, kws)
            if got is not None:
                return got
        if name in COLLECTIVE_METHODS and isinstance(func, ast.Attribute):
            got = self.eval_comm(name, args, kws)
            if got is not None:
                return got
        if (isinstance(func, ast.Attribute) and recv is not None
                and isinstance(recv.node, ast.ClassDef)):
            meth = _method(recv.node, name)
            if meth is not None:    # a method of an object the module built
                return (recv.owner or self.mod).summary(
                    meth, [recv] + args, kws, cls=recv.node,
                    depth=self.depth, collect=self.collect)
        if isinstance(func, ast.Attribute) and recv is not None:
            if name in HOST_READ_METHODS:
                self.host_read(node, name, recv)
                return Val(uniform=recv.uniform, static=recv.static,
                           tensor=recv.tensor and name == "cpu",
                           count=recv.count)
            if name in DYNAMIC_SHAPE:
                v = meet(recv, *allv)
                return Val(uniform=v.uniform, tensor=True, count=v.uniform)
            if name in STATIC_METHODS:
                return VS()
        if (name in HOST_READ_BUILTINS and isinstance(func, ast.Name)
                and name not in self.env):
            a = args[0] if args else VS()
            self.host_read(node, name, a)
            return Val(uniform=a.uniform, static=a.static)
        if name in CLOCK_CALLS and isinstance(func, ast.Attribute) and (
                name == "now" or _recv_name(func) == "time"):
            return VN()
        if name in SHARDED_RUNNERS:
            return self.eval_runner(node, args, kws)
        if name in BEARING_CALLS:
            return Val(static=True, bearing=True)

        # local callables (nested defs, lambdas) inline
        target = self.env.get(func.id) if isinstance(func, ast.Name) else None
        if isinstance(target, Val) and target.node is not None and \
                target.env is not None:
            return self.call_inline(target, args, kws)
        if isinstance(target, Val) and target.bearing:
            return meet(*allv) if allv else VN()
        # module-level functions and classes, this module's or imported
        got = self.mod.info.resolve_attr(func) if target is None else None
        if got is not None and got[0] == "func":
            return self._owner(got[1]).summary(got[2], args, kws,
                                               depth=self.depth,
                                               collect=self.collect)
        if got is not None and got[0] == "class":
            return self.construct(got[2], args, kws, self._owner(got[1]))
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self" and self.cls is not None):
            meth = _method(self.cls, name)
            if meth is not None:
                return self.mod.summary(meth, [VS()] + args, kws,
                                        cls=self.cls, depth=self.depth,
                                        collect=self.collect)
        if name == "replace" and _recv_name(func) == "dataclasses" and args:
            out = dataclasses.replace(args[0])
            if args[0].fields is not None:
                out.fields = {**args[0].fields, **kws}
            return out
        if name == "dict" and isinstance(func, ast.Name) and not args:
            v = meet(*kws.values()) if kws else VS()
            return Val(uniform=v.uniform, static=v.static, tensor=v.tensor,
                       fields=dict(kws))
        if isinstance(func, ast.Attribute) and recv is not None:
            self.mutate(func.value, name, allv)
        base = recv if recv is not None else VS()
        v = meet(base, *allv)
        if isinstance(func, ast.Name) and name in STATIC_BUILTINS:
            if name == "len":
                a = args[0] if args else VS()
                return Val(uniform=a.count, static=a.count and (
                    a.static or a.tensor or a.elems is not None))
            count = (all(a.count for a in allv) if name in SAME_COUNT
                     else v.uniform)
            return Val(uniform=v.uniform, static=v.static, tensor=v.tensor,
                       count=count)
        tensor = v.tensor or (_recv_name(func) == "torch")
        return Val(uniform=v.uniform, static=False, tensor=tensor)

    def mutate(self, recv: ast.expr, name: str, vals: list[Val]) -> None:
        """In-place methods (``lst.append(v)``, ``t.mul_(m)``) write their
        arguments into the receiver."""
        if name not in MUTATORS and not (name.endswith("_")
                                         and not name.startswith("_")):
            return
        v = taint(meet(*vals) if vals else VS(), self.pc)
        if name in MUTATORS and not self.pc.uniform and isinstance(
                recv, ast.Name) and recv.id in self.env:
            self.env[recv.id] = dataclasses.replace(self.env[recv.id],
                                                    count=False)
        if isinstance(recv, ast.Subscript):
            recv = recv.value
        if isinstance(recv, (ast.Name, ast.Attribute)):
            self._weak_update(recv, v)

    def eval_comm(self, name: str, args: list[Val], kws: dict):
        """A method of the rank's collectives (``None``: not one)."""
        a = args[0] if args else VS()
        if name in UNIFORM_METHODS:
            return Val(uniform=True, tensor=a.tensor and name not in (
                "lane_uniform", "root_value", "gather_objects"))
        if name in RECEIVED_METHODS:
            return VN(tensor=True)
        if name == "index":
            return VN(tensor=True)
        if name == "lane":
            return Val(uniform=True, tensor=True)
        if name == "per_shard":
            return a
        if name == "wait_lanes":
            return VS()
        return None

    def eval_dist(self, node: ast.Call, name: str, args: list[Val]) -> Val:
        if name == "get_rank":
            return VN()
        if name in ("get_world_size", "is_initialized", "get_backend",
                    "get_global_rank", "P2POp", "new_group"):
            return VS()
        out_arg = node.args[0] if node.args else None
        if isinstance(out_arg, ast.Name) and out_arg.id in self.env:
            if name in DIST_UNIFORM_OUT:
                self.env[out_arg.id] = uniformize(self.env[out_arg.id])
            elif name in DIST_RECEIVED_OUT:
                self.env[out_arg.id] = VN(tensor=True)
        return Val(static=True)

    def eval_runner(self, node: ast.Call, args: list[Val], kws: dict) -> Val:
        """``run_sharded[_many](fn, mesh, sharded, broadcast, comm=)``:
        ``fn`` runs on every rank with its own rows, the broadcast
        arguments and the ``comm``; the results are gathered."""
        fn = args[0] if args else None
        if fn is not None and fn.node is not None:
            rows = args[2] if len(args) > 2 else kws.get("sharded_args")
            bcast = args[3] if len(args) > 3 else kws.get(
                "broadcast_args", kws.get("lane_args"))
            n_rows = len(rows.elems) if rows is not None and \
                rows.elems is not None else 1
            fargs = [VN(tensor=True) for _ in range(n_rows)]
            if bcast is not None and bcast.elems is not None:
                fargs += [uniformize(e) for e in bcast.elems]
            fargs.append(Val(static=True, comm=True, bearing=True))
            if fn.env is not None:
                self.call_inline(fn, fargs, {})
            else:
                (fn.owner or self.mod).summary(fn.node, fargs, {},
                                               depth=self.depth)
        return Val(uniform=True, tensor=True)

    def call_inline(self, target: Val, args: list[Val], kws: dict) -> Val:
        """A nested def or lambda, analysed with the caller's environment;
        the names of the enclosing scope it writes flow back."""
        if self.depth >= _MAX_DEPTH:
            return VN(tensor=True)
        fn = target.node
        owner = target.owner or self.mod
        memo = (id(fn), id(target.env), self.collect,
                tuple(_sig(a) for a in args),
                tuple(sorted((k, _sig(v)) for k, v in kws.items())),
                tuple(sorted((n, _sig(v)) for n, v in self.env.items()
                             if n in (target.env or {}))), _sig(self.pc))
        hit = owner._call_memo.get(memo)
        if hit is not None:
            return hit
        env = dict(self.env if target.env is not None else {})
        params = {a.arg for a, _ in _all_args(fn.args)}
        owner._bind(fn, args, kws, strict=False, env=env)
        inner = FuncAnalyzer(owner, env, collect=self.collect, cls=self.cls,
                             depth=self.depth + 1)
        inner.pc = self.pc
        if isinstance(fn, ast.Lambda):
            out = inner.eval(fn.body)
        else:
            local = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)
                     and isinstance(n.ctx, ast.Store)}
            nonlocal_ = {x for n in ast.walk(fn)
                         if isinstance(n, ast.Nonlocal) for x in n.names}
            inner.exec_body(fn.body, rest=self.rest)
            out = inner.return_val()
            for name, v in inner.env.items():
                if name in self.env and name not in params and (
                        name not in local or name in nonlocal_):
                    self.env[name] = join(self.env[name], v)
        owner._call_memo[memo] = out
        return out

    def construct(self, cls: ast.ClassDef, args: list[Val], kws: dict,
                  owner: ModuleAnalysis) -> Val:
        """A module-level class called: a dataclass keeps its fields."""
        names = [st.target.id for st in cls.body
                 if isinstance(st, ast.AnnAssign)
                 and isinstance(st.target, ast.Name)]
        fields = dict(zip(names, args))
        fields.update(kws)
        v = meet(*fields.values()) if fields else VS()
        bearing = cls.name in BEARING_CALLS
        return Val(uniform=v.uniform, static=v.static, tensor=v.tensor,
                   bearing=bearing, fields=fields, node=cls, owner=owner)

    def host_read(self, node: ast.Call, name: str, v: Val) -> None:
        if v.static or not v.tensor:
            return
        self.report("host-sync", node, v, bearing=False, detail=name)
