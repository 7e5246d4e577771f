"""Per-rank shards of the LM's leaves under ``ShardingPlan.spec`` (the
port's counterpart of the reference's ``NamedSharding`` placement).

A spec is the plan's tuple with one entry per dim: ``None``, one mesh axis
name, or a tuple of names.  Each mesh axis in a dim's entry splits that
dim, in mesh-coordinate order (a dim over ``("pod", "data")`` is split
pod-major, as ``NamedSharding`` lays it out), so a rank stores the block
of every dim that its coordinates select: ``local_shape``, ``shard_of``
(this rank's block of a whole tensor) and ``unshard`` (the whole tensor
again, all-gathered over the group of each sharded dim).

``RankMesh`` is one rank's view of a mesh: the axis names and sizes, the
rank's coordinate, its process groups (each axis's, the batch axes' and
all axes'), and an optional ``CollectiveLog``.  ``RankMesh.of`` takes
them from a built ``DeviceMesh``; ``RankMesh.dry(spec)`` is the dry run's
stand-in on ``meta`` tensors: every collective is recorded (op, bytes)
and returns an empty ``meta`` tensor of the right shape, communicating
nothing.

The model reads the ambient mesh (``set_mesh`` / ``current_mesh``; the
reference's ``compat.set_mesh``) and gathers each layer's weights just
before the layer uses them through ``GatherLayer``: all-gather forward,
and backward, for each mesh axis,

- a batch axis (``plan.batch``: the ranks compute different batch rows)
  that splits the leaf: reduce-scatter;
- a batch axis that replicates the leaf: all-reduce;
- any other axis (``model``): this rank's slice, no sum (its ranks
  computed the same rows on the same gathered weights, so they hold the
  same gradient);

then one division by the batch axes' rank count, so that the gradients
are those of the global mean loss.  ``batch_mean`` is the same mean for a
statistic that the loss takes over the whole batch (the MoE router's
load-balance terms).  Gradients thus leave the backward pass reduced and
sharded like their parameters, as the reference pins them
(``constrain_grads``: a reduce-scatter instead of an all-reduce).

On a mesh with a ``model`` axis the model also splits its compute along
that axis where the reference's plan splits the activation it pins (the
query heads, the MLP's hidden columns, the experts, the vocabulary):
``tp_ranks`` says whether a region splits, and a split region gathers its
leaves only over the axes that it does not split (``gather(...,
keep=1)``: the batch axes; the ``model`` block of each leaf stays this
rank's).  Megatron's two region operators bracket such a region:
``copy_to_model`` (identity forward, a sum over ``model`` backward) where
a replicated activation or leaf enters it, ``reduce_from_model`` (a sum
over ``model`` forward, identity backward) where its partial sums leave;
``sum_over_model`` (a sum both ways) where a partial sum feeds a split
region again (RWKV-6's norm over all channels, Mamba's ``dt`` and B/C
projections), ``gather_from_model`` (the blocks concatenated forward,
this rank's block backward) where a split result feeds computation that
every ``model`` rank repeats.
Where ``model`` exceeds the KV heads, the ranks that share one KV head
gather its ``wk`` / ``wv`` columns among themselves (``keep=s``, a
sub-group of ``s`` consecutive ``model`` ranks) and sum their gradients
(``summed``: a reduce-scatter over that sub-group, not a slice).

With ``cfg.seq_parallel_acts`` in training (Megatron-SP: the reference's
pin of the residual at ``("batch", "act_seq", None)``), the residual
stream between a layer's regions is this rank's block of the sequence
over ``model`` (``split_sequence``).  ``enter_region`` all-gathers it
where a region enters (its gradient reduce-scattered where ``model``
splits the region, this rank's block of it where every rank runs the
region whole); ``leave_region`` reduce-scatters a split region's partial
sums, or keeps this rank's block of a whole region's output (the
gradient all-gathered either way).  Without the split the two are
``copy_to_model`` / ``reduce_from_model``, or nothing.  A norm that runs
on the block has its gradient summed over ``model``.

A step at ``grad_accum > 1`` gathers its non-expert leaves over the batch
axes once (``gather_batch``; their gradients ``reduce_batch_grad``);
inside ``batch_gathered`` a layer gathers such a leaf over ``model``
only.  ``in_this_context`` runs a remat region's recompute, which
autograd may run on another thread, in its forward pass's context.

A cache's sequence dim is split where the plan splits it (a batch of
one leaves ``data`` to the sequence): ``seq_axes`` names the axes,
``seq_block`` this rank's slots, ``max_over`` / ``sum_over`` combine the
ranks' partial attention in decode.

No DTensor and no FSDP wrapper: the placement stays visible, leaf by
leaf, for the tests that hold it to the plan.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import plan_for_mesh
from repro_torch.core.comm import shard_uniform

# one entry per collective kind, named as the reference's HLO roofline names
# them (``coll_bytes`` keys): bytes are per-rank output bytes
ALL_GATHER, REDUCE_SCATTER, ALL_REDUCE = ("all-gather", "reduce-scatter",
                                          "all-reduce")
MODEL = "model"      # the mesh axis of the plan's "tp" and "exp"


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name, or names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, sizes: dict) -> tuple[int, ...]:
    """The per-rank shape of a leaf of global ``shape`` under ``spec``
    (``sizes``: mesh axis name -> size).  Raises when a dim does not divide:
    ``ShardingPlan.spec`` only keeps axes that divide."""
    out = []
    for n, entry in zip(shape, spec):
        k = math.prod(sizes[a] for a in spec_axes(entry))
        if n % k:
            raise ValueError(f"dim {n} of {tuple(shape)} does not split "
                             f"over {spec_axes(entry)} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardedLeaf:
    """What a rank's shard of a leaf is: the global ``shape``, the
    ``spec``, and the mesh axes that replicate it (no dim is split over
    them)."""
    shape: tuple
    spec: tuple
    replicated: tuple

    @classmethod
    def of(cls, shape, spec, axis_names) -> "ShardedLeaf":
        used = {a for e in spec for a in spec_axes(e)}
        return cls(tuple(shape), tuple(spec),
                   tuple(a for a in axis_names if a not in used))

    @property
    def split(self) -> tuple:
        """The mesh axes whose ranks hold distinct blocks of the leaf."""
        return tuple(a for e in self.spec for a in spec_axes(e))


def wire_bytes(op: str, out_bytes: int, n: int) -> float:
    """The bytes one rank sends in a ring collective of ``n`` ranks whose
    per-rank output is ``out_bytes``: an all-gather sends the other ranks'
    blocks on, a reduce-scatter n - 1 blocks of its output's size, an
    all-reduce both."""
    if op == ALL_GATHER:
        return out_bytes * (n - 1) / n
    if op == REDUCE_SCATTER:
        return out_bytes * (n - 1)
    return 2 * out_bytes * (n - 1) / n


class CollectiveLog:
    """Count, per-rank output bytes and wire bytes (``wire_bytes``) of each
    collective, by kind, and each call's (kind, axes, output shape) in
    ``calls``."""

    def __init__(self):
        self.count: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.wire: dict[str, float] = {}
        self.calls: list[tuple[str, tuple, tuple]] = []

    def add(self, op: str, out: torch.Tensor, axes, n: int) -> None:
        nb = out.numel() * out.element_size()
        self.count[op] = self.count.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + nb
        self.wire[op] = self.wire.get(op, 0.0) + wire_bytes(op, nb, n)
        self.calls.append((op, tuple(axes), tuple(out.shape)))


class RankMesh:
    """One rank of a mesh: ``names`` / ``sizes`` (mesh order), the rank's
    ``coord``, its ``device``, its process groups by axes (``None`` in a
    dry mesh) and ``log``, a ``CollectiveLog`` or ``None``."""

    def __init__(self, names, sizes, coord, device, groups=None, log=None,
                 ids=None):
        self.names = tuple(names)
        self.sizes = dict(zip(self.names, (int(s) for s in sizes)))
        self.coord = dict(zip(self.names, (int(c) for c in coord)))
        self.device = torch.device(device)
        self.groups = groups
        self.log = log
        self.ids = ids           # the mesh's global ranks (a built mesh)
        self._sub: dict = {}

    @property
    def is_dry(self) -> bool:
        return self.groups is None

    @property
    def axes(self) -> tuple:      # a MeshSpec's geometry (plan_for_mesh)
        return self.names

    @property
    def shape(self) -> tuple:
        return tuple(self.sizes[a] for a in self.names)

    @property
    def n_ranks(self) -> int:
        return math.prod(self.sizes.values())

    @classmethod
    def of(cls, mesh) -> "RankMesh":
        """The view of a built ``DeviceMesh`` (made once per mesh: new
        groups are created by a collective call of every rank).  A single
        axis's groups are the mesh's own (``get_group``); of the sets of
        several axes only the two that the collectives here use get
        groups: the plan's batch axes (a dim split over ``("pod",
        "data")``, the batch mean) and all the mesh's axes (the global
        norm's one sum)."""
        got = getattr(mesh, "_repro_rank_mesh", None)
        if got is not None:
            return got
        names = tuple(mesh.mesh_dim_names)
        ids = mesh.mesh
        coord = mesh.get_coordinate()

        def ranks(axes, fixed) -> list:
            """The group of ``axes`` at the other axes' coordinates
            ``fixed`` (a dict), in mesh order (row-major over ``axes``)."""
            index = tuple(slice(None) if a in axes else fixed[a]
                          for a in names)
            return ids[index].reshape(-1).tolist()

        groups = {(a,): mesh.get_group(a) for a in names}
        multi = sorted({tuple(plan_for_mesh(mesh).batch), names})
        for axes in (s for s in multi if len(s) > 1):
            rest = [a for a in names if a not in axes]
            for fixed in itertools.product(*(range(ids.shape[names.index(a)])
                                              for a in rest)):
                members = ranks(axes, dict(zip(rest, fixed)))
                g = dist.new_group(members)
                if dist.get_rank() in members:
                    groups[axes] = g
        mine = dict(zip(names, coord))
        for axes, g in groups.items():
            want = ranks(axes, mine)
            if [dist.get_global_rank(g, i) for i in range(len(want))] != want:
                raise ValueError(f"the group of {axes}: its rank order is "
                                 "not the mesh's coordinate order")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda"
               else torch.device(mesh.device_type))
        rm = cls(names, ids.shape, coord, dev, groups, ids=ids)
        mesh._repro_rank_mesh = rm
        return rm

    @classmethod
    def dry(cls, spec, coord=None) -> "RankMesh":
        """The dry stand-in of a ``MeshSpec`` (rank ``coord``, default the
        first): ``meta`` tensors, collectives recorded in ``log``."""
        coord = coord or (0,) * len(spec.axes)
        return cls(spec.axes, spec.shape, coord, "meta", None,
                   CollectiveLog())

    def ordered(self, axes) -> tuple[str, ...]:
        """``axes`` in mesh order (a spec entry's axes already are)."""
        return tuple(a for a in self.names if a in axes)

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's block among ``size(axes)``: its coordinates on
        ``axes``, the first the most significant."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coord[a]
        return i

    def group(self, axes):
        key = self.ordered(axes)
        if key not in self.groups:
            raise KeyError(f"no process group over {key}: RankMesh.of makes "
                           "single axes, the batch axes and all axes")
        return self.groups[key]

    def subgroup(self, axis: str, size: int):
        """The group of this rank's block of ``size`` consecutive ranks
        along ``axis`` (the other coordinates fixed).  Made at first use,
        every block of every rank's at once: the first use must come on
        every rank at the same point of the program (a new group is a
        collective call of every rank)."""
        key = (axis, size)
        if key not in self._sub:
            rows = torch.movedim(self.ids, self.names.index(axis), -1)
            mine = None
            for row in rows.reshape(-1, rows.shape[-1]).tolist():
                for b in range(0, len(row), size):
                    members = row[b:b + size]
                    g = dist.new_group(members)
                    if dist.get_rank() in members:
                        mine, want = g, members
            if [dist.get_global_rank(mine, i) for i in range(size)] != want:
                raise ValueError(f"a sub-group of {axis}: its rank order is "
                                 "not the mesh's coordinate order")
            self._sub[key] = mine
        return self._sub[key]

    def batch_axes(self, plan) -> tuple[str, ...]:
        """The plan's batch axes that this mesh has."""
        return self.ordered(a for a in plan.batch if a in self.sizes)


# ----------------------------------------------------------- collectives --

def _record(rm: RankMesh, op: str, out: torch.Tensor, axes, n: int) -> None:
    if rm.log is not None:
        rm.log.add(op, out, axes, n)


def _group(rm: RankMesh, axes, sub: int | None):
    """The group of ``axes``, or of this rank's block of ``sub`` ranks
    along the one axis of ``axes``."""
    return rm.group(axes) if sub is None else rm.subgroup(axes[0], sub)


def _all_gather(x, rm: RankMesh, axes, dim: int, sub: int | None = None):
    """Concatenate the ranks' ``x`` along ``dim`` in group order (the
    group of ``axes``, or this rank's block of ``sub`` of its ranks)."""
    n = sub or rm.size(axes)
    if shard_uniform(rm.is_dry):       # the same mesh on every rank
        out = torch.empty(x.shape[:dim] + (n * x.shape[dim],)
                          + x.shape[dim + 1:], dtype=x.dtype, device=x.device)
        _record(rm, ALL_GATHER, out, axes, n)
        return out
    src = torch.movedim(x, dim, 0).contiguous()
    # the ranks' blocks one after another along dim 0
    buf = src.new_empty((n,) + tuple(src.shape)).flatten(0, 1)
    dist.all_gather_into_tensor(buf, src, group=_group(rm, axes, sub))
    _record(rm, ALL_GATHER, buf, axes, n)
    return torch.movedim(buf, 0, dim).contiguous()


def _reduce_scatter(x, rm: RankMesh, axes, dim: int, sub: int | None = None):
    """Sum over the group, each rank keeping its block of ``dim``."""
    n = sub or rm.size(axes)
    blocks = torch.movedim(x, dim, 0).unflatten(0, (n, -1))
    if shard_uniform(rm.is_dry):
        out = torch.movedim(torch.empty_like(blocks[0]), 0, dim)
        _record(rm, REDUCE_SCATTER, out, axes, n)
        return out
    buf = blocks.new_empty(blocks.shape[1:])         # contiguous
    dist.reduce_scatter_tensor(buf, blocks.flatten(0, 1).contiguous(),
                               op=dist.ReduceOp.SUM,
                               group=_group(rm, axes, sub))
    _record(rm, REDUCE_SCATTER, buf, axes, n)
    return torch.movedim(buf, 0, dim).contiguous()


def all_reduce(x, rm: RankMesh, axes, op=dist.ReduceOp.SUM):
    """The sum (or ``op``) of ``x`` over the group of ``axes`` (a new
    tensor)."""
    if shard_uniform(rm.is_dry):
        out = torch.empty_like(x)
        _record(rm, ALL_REDUCE, out, axes, rm.size(axes))
        return out
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=rm.group(axes))
    _record(rm, ALL_REDUCE, out, axes, rm.size(axes))
    return out


# ---------------------------------------------------------------- shards --

def _block(t: torch.Tensor, rm: RankMesh, axes, dim: int,
           sub: int | None = None) -> torch.Tensor:
    """This rank's block of ``dim`` split over ``axes`` (or over its block
    of ``sub`` ranks of the one axis of ``axes``; a view)."""
    n = sub or rm.size(axes)
    step = t.shape[dim] // n
    return t.narrow(dim, rm.index(axes) % n * step, step)


def _model_dims(spec, rm: RankMesh, keep: int | None):
    """Per dim of ``spec``: (its axes, ``sub``, skip) under ``keep``, the
    count of consecutive ``model`` ranks whose blocks a region gathers
    (``None``: all of them, as every other axis).  ``skip``: the dim's
    ``model`` block is this rank's alone (``keep == 1``)."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        if keep is None or MODEL not in axes:
            yield dim, axes, None, False
            continue
        if axes != (MODEL,):
            raise ValueError(f"spec entry {entry}: a compute split of "
                             f"{MODEL} with other axes on one dim")
        n = rm.sizes[MODEL]
        yield dim, axes, (keep if 1 < keep < n else None), keep == 1


def shard_of(t: torch.Tensor, spec, rm: RankMesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (a contiguous copy)."""
    if rm.is_dry:
        return torch.empty(local_shape(t.shape, spec, rm.sizes),
                           dtype=t.dtype, device="meta")
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            t = _block(t, rm, axes, dim)
    return t.contiguous().clone()


def unshard(t: torch.Tensor, spec, rm: RankMesh,
            keep: int | None = None) -> torch.Tensor:
    """The whole tensor from every rank's block: an all-gather over the
    group of each sharded dim.  ``keep``: a compute split's gather (the
    blocks of ``keep`` consecutive ``model`` ranks, ``_model_dims``)."""
    for dim, axes, sub, skip in _model_dims(spec, rm, keep):
        if not skip:
            t = _all_gather(t, rm, axes, dim, sub)
    return t


def reduce_grad(g: torch.Tensor, spec, rm: RankMesh, batch,
                keep: int | None = None, summed: bool = False) -> torch.Tensor:
    """The gradient of a shard from the gathered leaf's gradient ``g`` on
    this rank: reduced over ``batch`` (mean), kept to this rank's block.
    Ranks of another axis that gathered the same block hold the same
    gradient (sliced), or, with ``summed``, partial sums of it (summed: a
    reduce-scatter, or an all-reduce over ``model`` for a leaf that
    ``model`` replicates)."""
    used: set = set()
    for dim, axes, sub, skip in _model_dims(spec, rm, keep):
        used.update(axes)
        inb = [a in batch for a in axes]
        if skip:               # this rank's block alone: nothing to reduce
            continue
        if not any(inb):       # the same gradient on these ranks: slice
            g = (_reduce_scatter if summed else _block)(g, rm, axes, dim, sub)
        elif all(inb):
            g = _reduce_scatter(g, rm, axes, dim)
        else:
            raise ValueError(f"spec entry {spec[dim]} mixes batch and other "
                             "mesh axes")
    if summed and MODEL in rm.sizes and MODEL not in used:
        g = all_reduce(g, rm, (MODEL,))
    rest = tuple(a for a in batch if a not in used)
    if rest:
        g = all_reduce(g, rm, rest)
    return g / rm.size(batch)


class GatherLayer(torch.autograd.Function):
    """``unshard`` forward; ``reduce_grad`` backward."""

    @staticmethod
    def forward(ctx, shard, spec, rm, batch, keep=None, summed=False):
        ctx.spec, ctx.rm, ctx.batch = spec, rm, batch
        ctx.keep, ctx.summed = keep, summed
        return unshard(shard, spec, rm, keep)

    @staticmethod
    def backward(ctx, g):
        return (reduce_grad(g, ctx.spec, ctx.rm, ctx.batch, ctx.keep,
                            ctx.summed), None, None, None, None, None)


class _BatchMean(torch.autograd.Function):
    """The mean of ``x`` over the batch axes' ranks, forward and backward
    (each rank's loss holds the same mean, and the parameters' gradients
    are averaged over these ranks once more)."""

    @staticmethod
    def forward(ctx, x, rm, batch):
        ctx.rm, ctx.batch = rm, batch
        return all_reduce(x, rm, batch) / rm.size(batch)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.rm, ctx.batch) / ctx.rm.size(ctx.batch), \
            None, None


# --------------------------------------------------------- ambient mesh --

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


def as_rank_mesh(mesh) -> RankMesh | None:
    """A ``RankMesh`` of a built ``DeviceMesh`` or a ``RankMesh``; ``None``
    for ``None`` and an unbuilt ``MeshSpec`` (no ranks: one device)."""
    if mesh is None or isinstance(mesh, RankMesh):
        return mesh
    if hasattr(mesh, "mesh_dim_names"):
        return RankMesh.of(mesh)
    return None


@contextlib.contextmanager
def set_mesh(mesh):
    """Run the model on ``mesh`` (a ``DeviceMesh``, a ``RankMesh``, or
    ``None``/a ``MeshSpec``: one device) inside the block."""
    token = _MESH.set(as_rank_mesh(mesh))
    try:
        yield
    finally:
        _MESH.reset(token)


def current_mesh() -> RankMesh | None:
    return _MESH.get()


def in_this_context(fn):
    """``fn`` to run in a copy of the caller's context (the ambient mesh,
    ``split_sequence``, ``batch_gathered``): a remat region's recompute
    runs in the backward pass, which autograd runs on another thread for
    CUDA tensors, where the context of the forward pass is not set."""
    ctx = contextvars.copy_context()

    def run(*args, **kw):
        return ctx.copy().run(fn, *args, **kw)
    return run


def gather(t: torch.Tensor, spec, plan, keep: int | None = None,
           summed: bool = False) -> torch.Tensor:
    """The whole leaf of this rank's shard ``t`` under the ambient mesh
    (``t`` itself without one); ``keep`` / ``summed``: a compute split's
    gather (``unshard``, ``reduce_grad``)."""
    rm = current_mesh()
    if rm is None:
        return t
    return GatherLayer.apply(t, tuple(spec), rm, rm.batch_axes(plan), keep,
                             summed)


def gather_tree(tree, defs, plan, split=None):
    """``gather`` over a nested dict of leaves with their ``ParamDef``
    tree ``defs`` (``plan.spec`` of each); ``split``, a nested dict of the
    same paths, holds a leaf's ``(keep, summed)`` where a compute split
    gathers it (every other leaf whole).  Inside ``batch_gathered`` a leaf
    that is not an expert's is already whole over the batch axes (and
    over its ``model`` sub-group where ``keep`` names one: ``gather_batch``):
    it is gathered over the other axes of its spec only, and its gradient
    is not reduced over the axes it was gathered over."""
    if isinstance(tree, dict):
        split = split or {}
        return {k: gather_tree(v, defs[k], plan, split.get(k))
                for k, v in tree.items()}
    rm = current_mesh()
    if rm is None:
        return tree
    spec, batch = plan.spec(defs.dims, defs.shape), rm.batch_axes(plan)
    if _ONCE.get() and "exp" not in defs.dims:
        if _sub_group(split):
            return tree
        spec, batch = drop_axes(spec, batch), ()
    return GatherLayer.apply(tree, spec, rm, batch, *(split or ()))


# ------------------------------------------ once a step, over the batch --

_ONCE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_batch_gathered", default=False)


@contextlib.contextmanager
def batch_gathered(on: bool):
    """Inside the block the non-expert leaves given to the model are whole
    over the batch axes (``gather_batch``; ``gather_tree``)."""
    token = _ONCE.set(bool(on))
    try:
        yield
    finally:
        _ONCE.reset(token)


def drop_axes(spec, axes) -> tuple:
    """``spec`` without the mesh axes ``axes``."""
    return tuple(tuple(a for a in spec_axes(e) if a not in axes) or None
                 for e in spec)


def only_axes(spec, axes) -> tuple:
    """``spec`` with only the mesh axes ``axes``."""
    return tuple(tuple(a for a in spec_axes(e) if a in axes) or None
                 for e in spec)


def _sub_group(split) -> bool:
    """Whether a compute split's ``(keep, summed)`` gathers a leaf over a
    sub-group of ``keep`` ``model`` ranks (the KV heads that several
    ranks share)."""
    return split is not None and (split[0] or 1) > 1


def gather_batch(t: torch.Tensor, spec, rm: RankMesh, batch,
                 split=None) -> torch.Tensor:
    """This rank's shard ``t`` all-gathered over the batch axes ``batch``
    only (its other axes' blocks stay this rank's): the reference's leaf
    constrained to its spec without the ``fsdp`` dim.  A leaf that a
    compute split gathers over a ``model`` sub-group (``split``'s
    ``keep``) is gathered over it too, as every microbatch would."""
    if _sub_group(split):
        return unshard(t, spec, rm, split[0])
    return unshard(t, only_axes(spec, batch), rm)


def reduce_batch_grad(g: torch.Tensor, spec, rm: RankMesh, batch,
                      split=None) -> torch.Tensor:
    """The gradient of a ``gather_batch`` copy reduced into this rank's
    shard (``GatherLayer``'s reduction over the axes it was gathered
    over)."""
    if _sub_group(split):
        return reduce_grad(g, spec, rm, batch, *split)
    return reduce_grad(g, only_axes(spec, batch), rm, batch)


# ------------------------------------------------- the compute split --

def tp_ranks(plan, logical: str, n: int) -> int:
    """The ``model`` ranks that split a region whose pinned activation has
    a dim of ``n`` on ``logical`` (``"tp"``, ``"exp"``): the ambient
    mesh's ``model`` size where ``plan.spec`` keeps ``model`` on that dim,
    else 1 (no mesh, no ``model`` axis, or a dim it does not divide)."""
    rm = current_mesh()
    if rm is None or rm.sizes.get(MODEL, 1) == 1:
        return 1
    # the mesh's geometry and a config's dim: the same on every rank
    return shard_uniform(rm.sizes[MODEL] if MODEL in spec_axes(
        plan.spec((logical,), (n,))[0]) else 1)


def tp_rank() -> int:
    """This rank's ``model`` coordinate on the ambient mesh."""
    return current_mesh().coord[MODEL]


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the sum over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, rm):
        ctx.rm = rm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.rm, (MODEL,)), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over ``model`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, rm):
        return all_reduce(x, rm, (MODEL,))

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Where a replicated ``x`` enters a region split over ``model``: each
    rank's gradient of ``x`` is a partial sum, summed here."""
    return _CopyToModel.apply(x, current_mesh())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ``model`` ranks' partial ``x`` (a split region's
    output)."""
    return _ReduceFromModel.apply(x, current_mesh())


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ``model`` ranks' partial ``x``, forward and backward:
    where the sum feeds a split region again, each rank's gradient of it
    is partial too (``copy_to_model`` of ``reduce_from_model``)."""
    return copy_to_model(reduce_from_model(x))


class _GatherFromModel(torch.autograd.Function):
    """The ``model`` ranks' blocks concatenated forward; this rank's block
    of the gradient backward."""

    @staticmethod
    def forward(ctx, x, rm, dim):
        ctx.rm, ctx.dim = rm, dim % x.dim()
        return _all_gather(x, rm, (MODEL,), ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.rm, (MODEL,), ctx.dim).contiguous(), None, None


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` ranks' blocks of ``x`` concatenated along ``dim``,
    where the whole result feeds computation that every ``model`` rank
    repeats (so each rank's gradient of it is the whole gradient, and its
    own block is its share)."""
    return _GatherFromModel.apply(x, current_mesh(), dim)


# ----------------------------------- the residual's sequence split --

_SEQ: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_split_sequence", default=False)


@contextlib.contextmanager
def split_sequence(on: bool):
    """Inside the block (with ``on``) the residual stream between a
    layer's regions is this rank's block of the sequence (dim 1) over
    ``model``: ``enter_region`` / ``leave_region`` gather and scatter it."""
    token = _SEQ.set(bool(on))
    try:
        yield
    finally:
        _SEQ.reset(token)


def sequence_split() -> bool:
    return _SEQ.get()


class _GatherSeq(torch.autograd.Function):
    """The ``model`` ranks' sequence blocks concatenated forward; the sum
    of the ranks' gradients, this rank's block, backward
    (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, rm):
        ctx.rm = rm
        return _all_gather(x, rm, (MODEL,), 1)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.rm, (MODEL,), 1), None


class _ScatterSeq(torch.autograd.Function):
    """The sum over ``model``, this rank's sequence block, forward
    (reduce-scatter); the blocks of the gradient concatenated backward."""

    @staticmethod
    def forward(ctx, x, rm):
        ctx.rm = rm
        return _reduce_scatter(x, rm, (MODEL,), 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.rm, (MODEL,), 1), None


class _SplitSeq(torch.autograd.Function):
    """This rank's sequence block forward; the blocks of the gradient
    concatenated backward."""

    @staticmethod
    def forward(ctx, x, rm):
        ctx.rm = rm
        return _block(x, rm, (MODEL,), 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.rm, (MODEL,), 1), None


def enter_region(x: torch.Tensor, split: bool) -> torch.Tensor:
    """The residual stream's ``x`` (B, S, d) where it enters a region that
    ``model`` splits (``split``) or that every ``model`` rank runs whole.
    Under ``split_sequence`` ``x`` is this rank's block of the sequence
    and the result the whole sequence: all-gathered, its gradient
    reduce-scattered (split: each rank's is a partial sum) or this rank's
    block of it (whole: every rank's is the same).  Otherwise ``x`` is
    whole: ``copy_to_model`` (split) or ``x``."""
    if not _SEQ.get():
        return copy_to_model(x) if split else x
    if split:
        return _GatherSeq.apply(x, current_mesh())
    return gather_from_model(x, 1)


def leave_region(y: torch.Tensor, split: bool) -> torch.Tensor:
    """A region's output ``y`` (B, S, d), whole sequence: partial sums
    over ``model`` (``split``) or the same on every ``model`` rank.  Under
    ``split_sequence``, this rank's block of the sequence of the sum
    (reduce-scatter, its gradient all-gathered) or of ``y`` (its gradient
    all-gathered); otherwise the sum (``reduce_from_model``) or ``y``."""
    if not _SEQ.get():
        return reduce_from_model(y) if split else y
    return (_ScatterSeq if split else _SplitSeq).apply(y, current_mesh())


def sequence_start(n_local: int) -> int:
    """The first position of this rank's ``n_local`` positions of the
    sequence (0 without ``split_sequence``)."""
    return tp_rank() * n_local if _SEQ.get() else 0


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over ``model`` (no gradient)."""
    return all_reduce(x.detach(), current_mesh(), (MODEL,),
                      op=dist.ReduceOp.MAX)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` ranks' ``x`` concatenated along ``dim`` in rank order
    (no gradient: serving's logits and cache writes)."""
    return _all_gather(x.detach(), current_mesh(), (MODEL,), dim)


# ------------------------------------------- a cache's split sequence --

def seq_axes(plan, dims, shape) -> tuple[str, ...]:
    """The mesh axes that split the ``"seq"`` dim of a cache leaf of
    logical ``dims`` and global ``shape`` under the plan on the ambient
    mesh (``plan.spec``: with a batch too small for ``data``, its sequence
    takes ``data``); () without a mesh or a ``"seq"`` dim."""
    if current_mesh() is None or "seq" not in dims:
        return ()
    return spec_axes(plan.spec(tuple(dims), tuple(shape))[
        tuple(dims).index("seq")])


def seq_block(axes, n_local: int) -> tuple[int, int]:
    """(the whole length, this rank's first slot) of a sequence dim of
    which this rank holds ``n_local`` slots, split over ``axes``."""
    if not axes:
        return n_local, 0
    rm = current_mesh()
    return n_local * rm.size(axes), rm.index(axes) * n_local


def max_over(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes`` (no
    gradient: decode only)."""
    return all_reduce(x.detach(), current_mesh(), axes, op=dist.ReduceOp.MAX)


def sum_over(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (no gradient)."""
    return all_reduce(x.detach(), current_mesh(), axes)


def batch_mean(x: torch.Tensor, plan) -> torch.Tensor:
    """The mean of ``x`` over the ambient mesh's batch ranks (``x`` itself
    without a mesh)."""
    rm = current_mesh()
    if rm is None:
        return x
    return _BatchMean.apply(x, rm, rm.batch_axes(plan))


def batch_rows(t: torch.Tensor, spec, rm: RankMesh | None) -> torch.Tensor:
    """This rank's rows of a batch or cache leaf (``t`` without a mesh)."""
    return t if rm is None else shard_of(t, spec, rm)


def unshard_tree(tree, specs, rm: RankMesh):
    """``unshard`` of every leaf with a spec; the others as they are."""
    return map_tree(lambda t, sp: t if sp is None else unshard(t, sp, rm),
                    tree, specs)


def map_tree(fn, tree, specs):
    """``fn(leaf, spec)`` over a nested dict; a leaf without a spec entry
    is passed ``None``."""
    if isinstance(tree, dict):
        specs = specs if isinstance(specs, dict) else {}
        return {k: map_tree(fn, v, specs.get(k)) for k, v in tree.items()}
    return fn(tree, specs)
