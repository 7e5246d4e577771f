"""Boundary exchange between the simulated shards of one device.

Every device tensor of the port carries an explicit leading shard axis: the
reference's ``vmap`` over its SPMD program, written out.  A batch of L
same-shape graphs (``color_many``'s lanes, the reference's second ``vmap``)
lays its lanes' shards end to end, ``(L·P, …)``, lane l holding rows
``l·P … l·P + P - 1``; one graph is the case L = 1.  ``AxisComm`` is the
collective set over that axis: ``psum``/``pmax`` reduce each lane's P
shards, ``(L·P, …) → (L, …)``, and ``index`` is the shard's index within
its lane.

Both exchange schemes are one precomputed gather/scatter over the flat
view (``FlatExchange``): every ghost slot of every shard knows the flat
view entry it copies.  They give the reference's views and wire bytes:

- ``"allgather"`` — every shard broadcasts its boundary payload
  ``view[boundary]``; ghost g of shard p reads entry ``ghost_slot[g]`` of
  owner ``ghost_owner[g]``'s payload (every ghost column, padding
  included).  ``(P-1)·max_b`` items per exchange.
- ``"sparse"`` — the paper's neighbour-to-neighbour scheme: round r ships
  from every shard p to ``(p + shifts[r]) % P`` the boundary colors that
  destination reads (``graph.CommPlan``).  Each ghost's source (owner
  shard, send slot) and round are derived once; an exchange copies the
  ghosts of the rounds it runs, and the wire bytes are the lane's exact
  widths of those rounds (``round_widths``, zero on a bucket's rounds
  that carry nothing of this lane).

An exchange takes a lane mask and per-lane round masks: the entries are
sorted by (lane, round), so the due lanes' rounds are a few contiguous
segments of one index pair, and only those lanes refresh their ghosts and
add wire bytes.  That is the pull form (``__call__``), which the
speculative stage and every other exchange object take.  The recoloring
loop pushes instead (``FlatExchange.push``): after a run of classes, each
vertex the run recolored stores its color at its ghost copies through the
same entries keyed by source (``fan_out``), one ``ops.exchange_push``
launch, and nothing else is copied.  Its views and wire bytes are the
pull's (``recolor.recolor_steps``).

**On a mesh** (``torch.distributed``, one shard per rank: the reference's
``shard_map`` with ``P(axis)``), a rank holds one shard of each of its L
lanes, ``(L, …)`` rows, and ``MeshComm`` is the collective set over the
mesh's shard group: the same reductions become ``all_reduce`` calls, and
``MeshExchange`` ships the boundary colors between the ranks
(``all_gather`` of the payloads, or the sparse scheme's ring rounds as
``batch_isend_irecv``).  Its views and modelled wire bytes are bitwise
the simulator's.  ``run_sharded`` / ``run_sharded_many`` run a
rank-local program on each rank's rows of the global host arrays and
gather the results back to every rank.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.kernels.ref import take_rows  # noqa: F401 (re-export)

AXIS = "workers"        # the shard (graph-partition) mesh axis
BATCH_AXIS = "batch"    # the graph-lane axis of 2D batch x shard meshes

ALLGATHER = "allgather"
SPARSE = "sparse"
SCHEMES = (ALLGATHER, SPARSE)          # the two concrete exchange programs
AUTO = "auto"                          # resolved per partition by the entry points
SCHEME_CHOICES = SCHEMES + (AUTO,)

# Default scheme of every config that does not set one (the reference's
# REPRO_SCHEME switch, read the same way).
DEFAULT_SCHEME = os.environ.get("REPRO_SCHEME", AUTO)
if DEFAULT_SCHEME not in SCHEME_CHOICES:
    raise ValueError(f"REPRO_SCHEME={DEFAULT_SCHEME!r} invalid, want one of "
                     f"{SCHEME_CHOICES}")


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Static configuration of the boundary exchange."""

    scheme: str = DEFAULT_SCHEME   # "allgather" | "sparse" | "auto"
    wire16: bool = False           # int16 payloads (half the wire bytes)

    def __post_init__(self):
        if self.scheme not in SCHEME_CHOICES:
            raise ValueError(f"bad scheme {self.scheme!r}")

    @property
    def itemsize(self) -> int:
        return 2 if self.wire16 else 4


@dataclasses.dataclass(frozen=True)
class AxisComm:
    """Collectives over the leading axis of ``(L·P, …)`` tensors: L lanes
    of P shards each.  The index maps (``index``, ``lane``) are made once
    per device and kept on the instance."""

    P: int
    L: int = 1
    _maps: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def _map(self, name: str, device, make) -> torch.Tensor:
        key = (name, str(torch.device(device)))
        if key not in self._maps:
            self._maps[key] = make()
        return self._maps[key]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``(L·P, …) → (L, …)``: the sum over each lane's shards."""
        return x.reshape((self.L, self.P) + x.shape[1:]).sum(dim=1)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``(L·P, …) → (L, …)``: the max over each lane's shards."""
        return x.reshape((self.L, self.P) + x.shape[1:]).amax(dim=1)

    def index(self, device) -> torch.Tensor:
        """``(L·P,)``: each shard's index within its lane."""
        return self._map("index", device, lambda: torch.arange(
            self.P, device=device).repeat(self.L))

    def lane(self, device) -> torch.Tensor:
        """``(L·P,)``: each shard's lane."""
        return self._map("lane", device, lambda: torch.arange(
            self.L, device=device).repeat_interleave(self.P))

    def per_shard(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, …) → (L·P, …)``: each lane's value on each of its shards."""
        return x.repeat_interleave(self.P, dim=0)

    @property
    def shards(self) -> int:
        """Shards of each lane held here: all P of them."""
        return self.P

    @property
    def rows(self) -> int:
        return self.L * self.P

    def lane_psum(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, …)`` per-lane sums over the shards held here, which are
        all of them: the identity (``MeshComm`` adds the other ranks')."""
        return x

    lane_pmax = lane_psum

    def lane_uniform(self, flag: bool) -> bool:
        """One device holds every lane: the identity."""
        return flag

    def wait_lanes(self) -> None:
        """Nothing to wait for on one device."""


def allgather_bytes_per_exchange(P_size: int, max_boundary: int,
                                 itemsize: int = 4) -> int:
    """Per-shard wire bytes of one broadcast exchange (ring all-gather:
    every shard receives the other P-1 payloads of max_b entries)."""
    return (P_size - 1) * max_boundary * itemsize


def resolve_scheme(scheme: str, pg) -> str:
    """``"auto"``: whichever exchange physically ships fewer bytes for this
    partition (the sparse plan's pow2-rung buffers against the ring
    all-gather; ties go to sparse).  Any other scheme returns as-is."""
    if scheme != AUTO:
        return scheme
    sparse_b = pg.comm_plan.bytes_per_exchange(padded=True)
    return SPARSE if sparse_b <= allgather_bytes_per_exchange(
        pg.P, pg.max_boundary) else ALLGATHER


def _wire(vals: torch.Tensor, wire16: bool) -> torch.Tensor:
    return vals.to(torch.int16).to(vals.dtype) if wire16 else vals


def sparse_rounds(arrs: dict) -> int:
    """Ring-shift rounds of the sparse plan in ``arrs`` (0 without one).
    Every shard's row of ``shift_to_round`` is the plan's one table
    (``graph.build_comm_plan`` broadcasts it), so a rank that reads its
    own row reads the count every rank reads."""
    if "shift_to_round" not in arrs:
        return 0
    with tracing.span("read.exchange_build"):
        return shard_uniform(int((arrs["shift_to_round"][0] >= 0).sum()))


class _Exchange:
    """What every exchange shares: ``widths[l][r]`` is lane l's wire items
    in round r, and ``__call__(view, lanes=None, rounds=None)`` refreshes
    the ghosts of the due ``lanes`` (host bools, ``None`` = all) in the
    rounds each asks for (``rounds[l]``: host bools per round, or ``None``
    = all; ``None`` = all for every lane) in place and returns ``(view,
    wire bytes per lane)``.  ``broadcast`` (the all-gather scheme, one
    round) ignores round masks."""

    def __init__(self, widths: list, n_rounds: int, cfg: CommConfig,
                 broadcast: bool):
        self.n_lanes = len(widths)
        self.n_rounds = n_rounds
        self.widths = widths
        self.cfg = cfg
        self.broadcast = broadcast

    def _due(self, lanes, rounds) -> list:
        """Per lane: ``None`` when it is not due, else its due rounds."""
        out = []
        for lane in range(self.n_lanes):
            mask = None if rounds is None or self.broadcast else rounds[lane]
            out.append(None if lanes is not None and not lanes[lane] else
                       [r for r in range(self.n_rounds)
                        if mask is None or mask[r]])
        return out

    def _bytes(self, due: list) -> list:
        return [0 if rs is None else self.cfg.itemsize * sum(w[r] for r in rs)
                for rs, w in zip(due, self.widths)]


class FlatExchange(_Exchange):
    """A boundary exchange as one gather/scatter over the flat view.

    ``dst``/``src`` (int64 device tensors) pair each ghost entry's flat
    view index with the flat index it copies; ``seg`` (host ints) is each
    entry's (lane, round) segment ``lane * n_rounds + round``, and the
    entries come sorted by it.  ``n_slots``/``n_local_max``: the view's
    columns and local rows; ``n_local`` ``(L·P,)``: each view row's valid
    local rows.  Called as every ``_Exchange``; ``push`` is the recoloring
    loop's form.
    """

    def __init__(self, dst, src, seg_counts: list, widths: list,
                 n_rounds: int, cfg: CommConfig, broadcast: bool,
                 n_slots: int, n_local_max: int, n_local: torch.Tensor):
        super().__init__(widths, n_rounds, cfg, broadcast)
        bounds = [0]
        for c in seg_counts:
            bounds.append(bounds[-1] + c)
        self.bounds = bounds
        self.dst, self.src = dst, src
        self.n_slots, self.n_local_max = n_slots, n_local_max
        self.n_local = n_local
        self._fan = None

    def fan_out(self):
        """``(fan_ptr, fan_dst, lane_entries)``: the entries keyed by
        source.  ``fan_dst`` lists the entries' ``dst`` grouped by source
        row, and shard p's row v owns ``fan_dst[fan_ptr[p, v] : fan_ptr[p,
        v + 1]]``; int32, or int64 for a view of 2^31 entries or more.
        Entries whose source is no valid local row (padding, the sentinel)
        sort past the last offset: no run recolors their source, so they
        stay 0 through an iteration, as the view they start from.
        ``lane_entries`` ``(L,)`` int64: each lane's entries with a valid
        source, which its pushes write once an iteration.  Built at the
        first push with one stable sort and no host read, then kept."""
        if self._fan is None:
            with tracing.span("exchange.build"):
                nlm, n_slots = self.n_local_max, self.n_slots
                rows, dev = self.n_local.shape[0], self.src.device
                idx = (torch.int64 if rows * n_slots > 2**31 - 1
                       else torch.int32)
                shard, slot = self.src // n_slots, self.src % n_slots
                n_keys = rows * nlm
                key, order = torch.sort(
                    torch.where(slot < self.n_local[shard],
                                shard * nlm + slot, n_keys).to(idx),
                    stable=True)
                ptr = torch.searchsorted(key, torch.arange(
                    n_keys + 1, dtype=idx, device=dev))
                at = (torch.arange(rows, device=dev)[:, None] * nlm
                      + torch.arange(nlm + 1, device=dev))
                fan_ptr = ptr[at].to(idx)
                lane = (fan_ptr[:, -1] - fan_ptr[:, 0]).long()
                self._fan = (fan_ptr, self.dst[order].to(idx),
                             lane.view(self.n_lanes, -1).sum(dim=1))
        return self._fan

    def _due_entries(self, due: list) -> int:
        R = self.n_rounds
        return sum(self.bounds[lane * R + r + 1] - self.bounds[lane * R + r]
                   for lane, rs in enumerate(due) for r in rs or ())

    def _ranges(self, due: list) -> list:
        """The due segments as merged ``[start, end)`` entry ranges."""
        R, out = self.n_rounds, []
        if all(rs is not None and len(rs) == R for rs in due):
            return [[0, self.bounds[-1]]] if self.bounds[-1] else []
        for lane, rs in enumerate(due):
            for r in rs or ():
                a, b = self.bounds[lane * R + r], self.bounds[lane * R + r + 1]
                if a == b:
                    continue
                if out and out[-1][1] == a:
                    out[-1][1] = b
                else:
                    out.append([a, b])
        return out

    def __call__(self, view: torch.Tensor, lanes=None, rounds=None):
        with tracing.span("exchange"):
            due = self._due(lanes, rounds)
            ranges = self._ranges(due)
            if ranges:
                n = sum(b - a for a, b in ranges)
                tracing.count("exchange.entries", n)
                tracing.count("exchange.entries_due", n)
                if len(ranges) == 1:
                    (a, b), = ranges
                    dst, src = self.dst[a:b], self.src[a:b]
                else:
                    dst = torch.cat([self.dst[a:b] for a, b in ranges])
                    src = torch.cat([self.src[a:b] for a, b in ranges])
                flat = view.view(-1)
                flat[dst] = _wire(flat[src], self.cfg.wire16)
            return view, self._bytes(due)

    def push(self, view: torch.Tensor, rows: tuple, first: int, last: int,
             lane_on=None, lanes=None, rounds=None, backend: str = "auto"):
        """The exchange after recolor classes ``first … last`` ran, as a
        push: each vertex they recolored stores its color at its ghost
        copies (``ops.exchange_push`` on the schedule's ``rows`` =
        ``(sorted_pad, start_local, local_sizes)``; a lane that is 0 in
        ``lane_on``, ``(L,)`` int32 on the device, pushes nothing), in
        place.  ``lanes``/``rounds`` are the pull's due masks: they give
        the wire bytes, ``(view, bytes per lane)`` as ``__call__`` returns,
        and ``exchange.entries_due``.  The entries written are counted
        once an iteration, by the loop (``fan_out``'s ``lane_entries``)."""
        fan_ptr, fan_dst, _ = self.fan_out()    # its span beside "exchange"
        with tracing.span("exchange"):
            due = self._due(lanes, rounds)
            tracing.count("exchange.entries_due", self._due_entries(due))
            ops.exchange_push(view, fan_ptr, fan_dst, *rows, lane_on,
                              first_class=first, last_class=last,
                              wire16=self.cfg.wire16, backend=backend)
            return view, self._bytes(due)


def _lane_flat(P: int, L: int, n_slots: int, dev) -> torch.Tensor:
    """``(L·P, 1)``: the flat view offset of each shard's first slot."""
    return (torch.arange(L * P, device=dev) * n_slots)[:, None]


def _allgather_exchange(arrs: dict, comm: AxisComm, n_local_max: int,
                        cfg: CommConfig) -> FlatExchange:
    """The broadcast scheme: ghost g of shard p copies entry
    ``ghost_slot[g]`` of its owner's payload ``view[owner, boundary]``, on
    every ghost column."""
    P, L = comm.P, comm.L
    n_slots = arrs["prio"].shape[1]
    boundary = arrs["boundary"].long()
    max_b = boundary.shape[1]
    n_ghost_cols = arrs["ghost_owner"].shape[1]
    dev = boundary.device
    base = _lane_flat(P, L, n_slots, dev)
    lane_first = (comm.lane(dev) * P)[:, None]          # lane's shard 0
    owner = lane_first + arrs["ghost_owner"].long()     # global shard
    slot = boundary.reshape(-1)[owner * max_b + arrs["ghost_slot"].long()]
    src = (owner * n_slots + slot).reshape(-1)
    dst = (base + n_local_max
           + torch.arange(n_ghost_cols, device=dev)).reshape(-1)
    width = (P - 1) * max_b
    return FlatExchange(dst, src, [P * n_ghost_cols] * L, [[width]] * L, 1,
                        cfg, broadcast=True, n_slots=n_slots,
                        n_local_max=n_local_max, n_local=arrs["n_local"])


def _sparse_exchange(arrs: dict, comm: AxisComm, n_local_max: int,
                     cfg: CommConfig) -> FlatExchange:
    """The sparse round schedule: each ghost's source (owner shard, send
    slot) and round, derived once; one device->host read at set-up."""
    P, L = comm.P, comm.L
    send_slot = arrs["send_slot"]
    shift, pos = arrs["ghost_shift"], arrs["ghost_pos"]
    n_slots = arrs["prio"].shape[1]
    n_ghost_cols = shift.shape[1]
    dev = send_slot.device
    n_rounds = sparse_rounds(arrs)
    s2r = arrs["shift_to_round"][0]
    q = comm.index(dev)[:, None]
    lane_first = (comm.lane(dev) * P)[:, None]
    k = shift.long().clamp(min=0)
    src_shard = lane_first + (q - k) % P
    rnd = s2r.long()[k]
    slot = send_slot[src_shard, rnd.clamp(min=0),
                     pos.long().clamp(max=send_slot.shape[2] - 1)]
    real = shift >= 0
    seg = torch.where(real, comm.lane(dev)[:, None] * n_rounds + rnd,
                      -1).reshape(-1)
    dst = (_lane_flat(P, L, n_slots, dev) + n_local_max
           + torch.arange(n_ghost_cols, device=dev)).reshape(-1)
    src = (src_shard * n_slots + slot).reshape(-1)
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg[order] + 1, minlength=L * n_rounds + 1)
    widths = arrs["round_widths"][::P, :n_rounds]
    with tracing.span("read.exchange_build"):
        host = torch.cat([counts, widths.reshape(-1).long()]).tolist()
    counts, widths = host[:L * n_rounds + 1], host[L * n_rounds + 1:]
    skip = counts[0]                                   # entries of no round
    return FlatExchange(dst[order][skip:], src[order][skip:], counts[1:],
                        [widths[i * n_rounds:(i + 1) * n_rounds]
                         for i in range(L)], n_rounds, cfg, broadcast=False,
                        n_slots=n_slots, n_local_max=n_local_max,
                        n_local=arrs["n_local"])


def make_exchange(arrs: dict, cfg: CommConfig, lanes: int = 1, comm=None):
    """Build the exchange of ``arrs`` under ``cfg``'s resolved scheme: the
    ``FlatExchange`` of ``lanes`` graphs of ``P = rows / lanes`` shards
    each, or with a ``MeshComm`` the ``MeshExchange`` of this rank's rows.
    Exchanges update the view in place."""
    n_local_max = arrs["indptr"].shape[1] - 1
    if cfg.scheme not in SCHEMES:
        raise ValueError(f"scheme {cfg.scheme!r} must be resolved to "
                         f"{SCHEMES} before the run")
    sparse = cfg.scheme == SPARSE
    with tracing.span("exchange.build"):
        if isinstance(comm, MeshComm):
            return MeshExchange(arrs, comm, n_local_max, cfg, sparse)
        comm = AxisComm(arrs["prio"].shape[0] // lanes, lanes)
        if sparse:
            return _sparse_exchange(arrs, comm, n_local_max, cfg)
        return _allgather_exchange(arrs, comm, n_local_max, cfg)


def stats_to_host(stats: dict) -> dict:
    """Stats dict of python ints and device scalars -> python ints, with
    one device->host transfer for all device entries."""
    dev = {k: v for k, v in stats.items() if isinstance(v, torch.Tensor)}
    if dev:
        vals = torch.stack([v.reshape(()).long() for v in dev.values()])
        dev = dict(zip(dev, vals.tolist()))
    return {k: int(dev.get(k, v)) for k, v in stats.items()}


# ------------------------------------------------------------------ meshes --

def mesh_axes(mesh) -> tuple:
    """``((axis name, axis size), ...)`` of a ``DeviceMesh`` or a
    ``launch.mesh.MeshSpec``: the component of a ``PlanSignature`` that
    pins the mesh geometry a program runs on."""
    names = getattr(mesh, "mesh_dim_names", getattr(mesh, "axes", None))
    if names is None:
        raise ValueError("the mesh has no axis names; build it via "
                         "launch.mesh.MeshSpec")
    return tuple((str(n), int(s)) for n, s in zip(names, mesh.shape))


def shard_axis_of(mesh) -> str:
    """The mesh axis graph partitions shard over: a ``workers`` axis
    always wins; otherwise the single non-``batch`` axis; otherwise the one
    such axis of size > 1; otherwise (every axis of size 1) the last.
    Anything else is ambiguous and raises."""
    axes = mesh_axes(mesh)
    names = tuple(n for n, _ in axes)
    if AXIS in names:
        return AXIS
    cands = [(n, s) for n, s in axes if n != BATCH_AXIS]
    if len(cands) == 1:
        return cands[0][0]
    sized = [n for n, s in cands if s > 1]
    if len(sized) == 1:
        return sized[0]
    if cands and not sized:          # all-size-1 smoke mesh: any axis works
        return cands[-1][0]
    raise ValueError(
        f"cannot infer the shard axis of mesh axes {names}: none is named "
        f"{AXIS!r} and {len(sized)} non-{BATCH_AXIS!r} axes have size > 1; "
        f"build the mesh via launch.mesh.MeshSpec")


def batch_axis_of(mesh) -> str | None:
    """The graph-lane axis of a 2D ``batch × shard`` mesh (None if 1D)."""
    return BATCH_AXIS if BATCH_AXIS in dict(mesh_axes(mesh)) else None


def batch_axis_size(mesh) -> int:
    """Size of the graph-lane mesh axis (1 when the mesh has none)."""
    return dict(mesh_axes(mesh)).get(BATCH_AXIS, 1)


def shard_uniform(x):
    """Identity marker: ``x`` is the same on every shard by contract (a
    value read back from a ``psum``/``pmax``, or a round mask derived from
    one).  Host control flow that decides which collectives run must only
    read such values, or the ranks fall out of step."""
    return x


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """int16 payloads travel as their bytes (NCCL has no int16 type)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.int16 else x


class MeshComm:
    """The collectives of one rank of a ``DeviceMesh``: the mesh form of
    ``AxisComm``.

    The rank holds shard ``p`` (its coordinate on the shard axis) of each
    of its ``L`` lanes, ``(L, …)`` rows; on a 2D ``batch × shard`` mesh the
    lanes of a batch are split over the batch axis in blocks of L, batch
    row ``b`` holding lanes ``b·L … b·L + L - 1``.  ``psum``/``pmax``/
    ``pmin`` reduce each lane over the shard group (``(L, …) → (L, …)``),
    and so do ``lane_psum``/``lane_pmax`` (what ``AxisComm`` has already
    reduced on one device); ``lane_uniform`` takes a host flag's max over
    the batch group, the identity when the batch axis has one rank.
    """

    shards = 1

    def __init__(self, mesh, lanes: int = 1):
        axis = shard_axis_of(mesh)
        baxis = batch_axis_of(mesh)
        names = [n for n, _ in mesh_axes(mesh)]
        self.mesh = mesh
        self.L = int(lanes)
        self.P = dict(mesh_axes(mesh))[axis]
        self.n_batch = batch_axis_size(mesh)
        self.p = mesh.get_local_rank(axis)
        self.b = mesh.get_local_rank(baxis) if baxis is not None else 0
        self.group = mesh.get_group(axis)
        self.batch_group = (mesh.get_group(baxis) if self.n_batch > 1
                            else None)
        coord = list(mesh.get_coordinate())
        coord[names.index(axis)] = slice(None)
        self._peers = mesh.mesh[tuple(coord)].tolist()
        if ([dist.get_global_rank(self.group, i) for i in range(self.P)]
                != self._peers):
            raise ValueError("the shard group's rank order is not the mesh's "
                             "coordinate order")
        self._root = int(mesh.mesh.reshape(-1)[0])
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda"
                       else torch.device(mesh.device_type))

    @property
    def rows(self) -> int:
        return self.L

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.to(torch.uint8 if x.dtype == torch.bool else x.dtype,
                 copy=True)
        dist.all_reduce(y, op=op, group=self.group)
        return y.bool() if x.dtype == torch.bool else y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, …)``: each lane's sum over its P shards."""
        if x.dtype == torch.bool:
            raise TypeError("psum of bools; pmax takes their OR")
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, …)``: each lane's max over its P shards (bools: OR)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    lane_psum = psum
    lane_pmax = pmax

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(…) → (P, …)``, shard order, the same on every shard."""
        wire = _to_wire(x)
        outs = [torch.empty_like(wire) for _ in range(self.P)]
        dist.all_gather(outs, wire, group=self.group)
        return torch.stack([o.view(x.dtype) for o in outs])

    def p2p(self, sends: list) -> list:
        """One batch of point-to-point transfers on the shard axis: each
        ``(payload, to, frm)`` sends ``payload`` to shard ``to`` and
        receives a payload of the same shape from shard ``frm``.  Returns
        the received tensors."""
        ops, bufs = [], []
        for x, to, frm in sends:
            wire = _to_wire(x)
            buf = torch.empty_like(wire)
            ops += [dist.P2POp(dist.isend, wire, self._peers[to], self.group),
                    dist.P2POp(dist.irecv, buf, self._peers[frm], self.group)]
            bufs.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [b.view(x.dtype) for b, (x, _, _) in zip(bufs, sends)]

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """The reference's ``ppermute`` for a permutation of the shards:
        send to this shard's destination in ``perm`` (``(src, dst)``
        pairs), return what its source sent."""
        to = [d for s, d in perm if s == self.p]
        frm = [s for s, d in perm if d == self.p]
        if len(to) != 1 or len(frm) != 1:
            raise ValueError(f"shard {self.p} needs one destination and one "
                             f"source in {perm}")
        return self.p2p([(x, to[0], frm[0])])[0]

    def index(self, device=None) -> torch.Tensor:
        """``(L,)``: the shard coordinate of each row (the Random-X and
        RAND draws fold it in, as the simulator folds its shard index)."""
        return torch.full((self.L,), self.p, dtype=torch.int64,
                          device=device or self.device)

    def lane(self, device=None) -> torch.Tensor:
        """``(L,)``: each row's lane among this rank's lanes."""
        return torch.arange(self.L, device=device or self.device)

    def per_shard(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, …)``: one row per lane already."""
        return x

    def lane_uniform(self, flag: bool) -> bool:
        """``flag`` or'ed over the batch group: the rows of a 2D mesh loop
        in step, each applying only its own lanes' work."""
        if self.batch_group is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.batch_group)
        with tracing.span("read.lane_uniform"):
            return bool(t.item())

    def wait_lanes(self) -> None:
        """For a rank whose lanes are done: take the loop's remaining
        ``lane_uniform`` decisions (False) until the other batch rows'
        lanes are done too."""
        while self.lane_uniform(False):
            pass

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, …) → (P, n_batch·L, …)``: every rank's rows, on every
        rank, lanes in the batch's order."""
        x = self.all_gather(x)
        if self.batch_group is None:
            return x
        outs = [torch.empty_like(x) for _ in range(self.n_batch)]
        dist.all_gather(outs, x.contiguous(), group=self.batch_group)
        return torch.cat(outs, dim=1)

    def gather_objects(self, objs: list) -> list:
        """One host object per local lane -> one per lane of the batch, on
        every rank (the shard group's ranks hold the same objects)."""
        if self.batch_group is None:
            return list(objs)
        out = [None] * self.n_batch
        dist.all_gather_object(out, list(objs), group=self.batch_group)
        return [o for part in out for o in part]

    def root_value(self, x: float) -> float:
        """The mesh's first rank's ``x``, on every rank of the mesh (whose
        ranks make up the whole world)."""
        t = torch.tensor([float(x)], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=self._root)
        with tracing.span("read.root_value"):
            return float(t.item())


class MeshExchange(_Exchange):
    """The boundary exchange between the ranks of a mesh's shard group, for
    this rank's ``(L, n_slots)`` view; called as every ``_Exchange``.

    The ranks of a shard group hold the same lanes and read the same
    (``psum``/``pmax``-reduced) schedules, so they agree on which lanes and
    rounds are due; each round moves the due lanes' payloads end to end.

    - ``"allgather"``: the due lanes' payloads ``view[boundary]`` are
      all-gathered, ``(P, lanes, max_b)``; ghost g of lane l reads entry
      ``ghost_slot`` of owner ``ghost_owner``'s payload.
    - ``"sparse"``: round r sends lane l's first ``round_widths[l, r]``
      entries of ``send_slot[l, r]`` to shard ``(p + shifts[r]) % P`` and
      receives from ``(p - shifts[r]) % P``; a ghost of shift
      ``shifts[r]`` reads position ``ghost_pos`` of its lane's part.
      All due rounds go in one ``batch_isend_irecv``.

    Wire bytes per lane are the simulator's (``FlatExchange``), and
    ``wire16`` ships int16.
    """

    def __init__(self, arrs: dict, comm: MeshComm, n_local_max: int,
                 cfg: CommConfig, sparse: bool):
        L, P = comm.L, comm.P
        n_slots = arrs["prio"].shape[1]
        dev = arrs["prio"].device
        self.comm = comm
        base = (torch.arange(L, device=dev) * n_slots)[:, None]
        n_ghost_cols = arrs["ghost_owner"].shape[1]
        ghost_dst = base + n_local_max + torch.arange(n_ghost_cols,
                                                      device=dev)
        if not sparse:
            boundary = arrs["boundary"].long()
            self.pay = base + boundary
            self.owner = arrs["ghost_owner"].long()
            self.slot = arrs["ghost_slot"].long()
            self.dst = ghost_dst
            super().__init__([[(P - 1) * boundary.shape[1]]] * L, 1, cfg,
                             broadcast=True)
            return
        R = sparse_rounds(arrs)
        s2r = arrs["shift_to_round"][0].long()
        shift = arrs["ghost_shift"].long()
        real = shift >= 0
        rnd = s2r[shift.clamp(min=0)]
        seg = torch.where(real, torch.arange(L, device=dev)[:, None] * R + rnd,
                          -1).reshape(-1)
        order = torch.argsort(seg, stable=True)
        counts = torch.bincount(seg[order] + 1, minlength=L * R + 1)
        with tracing.span("read.exchange_build"):
            host = torch.cat([s2r, counts, arrs["round_widths"][:, :R]
                              .reshape(-1).long()]).tolist()   # the one read
        s2r_h, counts = host[:P], host[P:P + L * R + 1]
        widths = host[P + L * R + 1:]
        super().__init__([widths[i * R:(i + 1) * R] for i in range(L)], R,
                         cfg, broadcast=False)
        self.shifts = [s2r_h.index(r) for r in range(R)]
        send = base[:, :, None] + arrs["send_slot"].long()
        # per (lane, round): send indices, ghost destinations, positions
        dst = ghost_dst.reshape(-1)[order][counts[0]:]
        pos = arrs["ghost_pos"].long().reshape(-1)[order][counts[0]:]
        dsts, poss = dst.split(counts[1:]), pos.split(counts[1:])
        self.send = [[send[l, r, :self.widths[l][r]] for r in range(R)]
                     for l in range(L)]
        self.recv = [[(dsts[l * R + r], poss[l * R + r]) for r in range(R)]
                     for l in range(L)]

    def __call__(self, view: torch.Tensor, lanes=None, rounds=None):
        with tracing.span("exchange"):
            return self._exchange(view, self._due(lanes, rounds))

    def _exchange(self, view: torch.Tensor, due: list):
        flat = view.view(-1)
        wire = (lambda v: v.to(torch.int16)) if self.cfg.wire16 else (
            lambda v: v)
        if self.broadcast:
            on = [lane for lane, rs in enumerate(due) if rs is not None]
            if on:
                sel = (slice(None) if len(on) == self.n_lanes else
                       torch.tensor(on, device=view.device))
                for name in ("exchange.entries", "exchange.entries_due"):
                    tracing.count(name, len(on) * self.pay.shape[1])
                table = self.comm.all_gather(wire(flat[self.pay[sel]]))
                lane = torch.arange(len(on), device=view.device)[:, None]
                flat[self.dst[sel]] = table[self.owner[sel], lane,
                                            self.slot[sel]].to(view.dtype)
            return view, self._bytes(due)
        P, p = self.comm.P, self.comm.p
        sends, recvs = [], []
        for r, k in enumerate(self.shifts):
            part = [lane for lane, rs in enumerate(due)
                    if rs is not None and r in rs and self.widths[lane][r]]
            if not part:
                continue
            offs = np.cumsum([0] + [self.widths[lane][r] for lane in part])
            for name in ("exchange.entries", "exchange.entries_due"):
                tracing.count(name, int(offs[-1]))
            idx = torch.cat([self.send[lane][r] for lane in part])
            sends.append((wire(flat[idx]), (p + k) % P, (p - k) % P))
            recvs.append((torch.cat([self.recv[lane][r][0] for lane in part]),
                          torch.cat([self.recv[lane][r][1] + int(o)
                                     for lane, o in zip(part, offs)])))
        for (d, pos), buf in zip(recvs, self.comm.p2p(sends)):
            flat[d] = buf[pos].to(view.dtype)
        return view, self._bytes(due)


def _local(a, rows, device):
    """Global host arrays (or a dict of them) -> this rank's ``rows`` on
    its device, dtypes kept."""
    if isinstance(a, dict):
        return {k: _local(v, rows, device) for k, v in a.items()}
    if isinstance(a, torch.Tensor):
        return a[rows].to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[rows])).to(
        device)


def run_sharded(fn, mesh, sharded_args: tuple, broadcast_args: tuple = (),
                comm: MeshComm | None = None):
    """Run the rank-local program ``fn`` on this rank's shard of the mesh
    (the reference's ``shard_map`` with ``P(axis)``).

    Every rank passes the same global host arrays ``sharded_args`` (arrays
    or dicts of arrays with a leading shard axis of size P); each copies
    its shard's row, as one lane of ``(1, …)`` rows, to its device and
    calls ``fn(*rows, *broadcast_args, comm)``, which returns ``(tensors,
    lanes)``: a tuple of ``(1, …)`` device tensors and a list of host
    values that are the same on every shard.  Returns the tensors gathered
    to ``(P, …)`` on every rank, and ``lanes``.  On a 2D mesh the one graph
    is replicated over the batch axis.
    """
    comm = MeshComm(mesh) if comm is None else comm
    rows = slice(comm.p, comm.p + 1)
    tensors, lanes = fn(*(_local(a, rows, comm.device)
                          for a in sharded_args), *broadcast_args, comm)
    return tuple(comm.all_gather(t)[:, 0] for t in tensors), lanes


def run_sharded_many(fn, mesh, sharded_args: tuple, lane_args: tuple = (),
                     comm: MeshComm | None = None):
    """Run a lane-batched rank-local program on a mesh (the reference's
    ``run_sharded_many``).

    ``sharded_args`` carry ``(P, B, …)`` host arrays (dicts of them too),
    ``lane_args`` ``(B, …)`` tensors (the per-lane keys).  Each rank takes
    shard ``p`` of its batch row's block of ``B / n_batch`` lanes and calls
    ``fn(*rows, *lane_args, comm)`` on ``(L, …)`` rows; ``fn`` returns
    ``(tensors, lanes)``, ``(L, …)`` tensors and one host value per lane.
    Returns the tensors gathered to ``(P, B, …)`` and the B host values,
    the same on every rank.  ``B`` must be a multiple of the batch axis.
    """
    first = next(iter(sharded_args[0].values())) if isinstance(
        sharded_args[0], dict) else sharded_args[0]
    B, n_batch = first.shape[1], batch_axis_size(mesh)
    if B % n_batch:
        raise ValueError(f"{B} lanes do not split over a batch axis of "
                         f"{n_batch}")
    comm = MeshComm(mesh, B // n_batch) if comm is None else comm
    if comm.L * comm.n_batch != B:
        raise ValueError(f"comm of {comm.L} lanes per batch row does not "
                         f"hold {B} lanes")
    lanes = slice(comm.b * comm.L, (comm.b + 1) * comm.L)
    tensors, per_lane = fn(
        *(_local(a, (comm.p, lanes), comm.device) for a in sharded_args),
        *(torch.as_tensor(a)[lanes].to(comm.device) for a in lane_args),
        comm)
    return (tuple(comm.gather_lanes(t) for t in tensors),
            comm.gather_objects(per_lane))
