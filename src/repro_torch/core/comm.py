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
add wire bytes.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.kernels.ref import take_rows  # noqa: F401 (re-export)

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
    """Ring-shift rounds of the sparse plan in ``arrs`` (0 without one)."""
    if "shift_to_round" not in arrs:
        return 0
    return int((arrs["shift_to_round"][0] >= 0).sum())


class FlatExchange:
    """A boundary exchange as one gather/scatter over the flat view.

    ``dst``/``src`` (int64 device tensors) pair each ghost entry's flat
    view index with the flat index it copies; ``seg`` (host ints) is each
    entry's (lane, round) segment ``lane * n_rounds + round``, and the
    entries come sorted by it.  ``widths[l][r]`` is lane l's wire items in
    round r.  ``__call__(view, lanes=None, rounds=None)`` refreshes the
    ghosts of the due ``lanes`` (host bools, ``None`` = all) in the rounds
    each asks for (``rounds[l]``: host bools per round, or ``None`` = all;
    ``None`` = all for every lane) in place, and returns ``(view, wire
    bytes per lane)``.
    """

    def __init__(self, dst, src, seg_counts: list, widths: list,
                 n_rounds: int, cfg: CommConfig, broadcast: bool):
        self.n_lanes = len(widths)
        self.n_rounds = n_rounds
        bounds = [0]
        for c in seg_counts:
            bounds.append(bounds[-1] + c)
        self.bounds = bounds
        self.dst, self.src = dst, src
        self.widths = widths
        self.cfg = cfg
        self.broadcast = broadcast   # all-gather: round masks are ignored

    def _due(self, lanes, rounds) -> list:
        """Per lane: ``None`` when it is not due, else its due rounds."""
        out = []
        for lane in range(self.n_lanes):
            mask = None if rounds is None or self.broadcast else rounds[lane]
            out.append(None if lanes is not None and not lanes[lane] else
                       [r for r in range(self.n_rounds)
                        if mask is None or mask[r]])
        return out

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
        due = self._due(lanes, rounds)
        ranges = self._ranges(due)
        if ranges:
            if len(ranges) == 1:
                (a, b), = ranges
                dst, src = self.dst[a:b], self.src[a:b]
            else:
                dst = torch.cat([self.dst[a:b] for a, b in ranges])
                src = torch.cat([self.src[a:b] for a, b in ranges])
            flat = view.view(-1)
            flat[dst] = _wire(flat[src], self.cfg.wire16)
        return view, [0 if rs is None else
                      self.cfg.itemsize * sum(w[r] for r in rs)
                      for rs, w in zip(due, self.widths)]


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
                        cfg, broadcast=True)


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
    host = torch.cat([counts, widths.reshape(-1).long()]).tolist()
    counts, widths = host[:L * n_rounds + 1], host[L * n_rounds + 1:]
    skip = counts[0]                                   # entries of no round
    return FlatExchange(dst[order][skip:], src[order][skip:], counts[1:],
                        [widths[i * n_rounds:(i + 1) * n_rounds]
                         for i in range(L)], n_rounds, cfg, broadcast=False)


def make_exchange(arrs: dict, cfg: CommConfig, lanes: int = 1):
    """Build the ``FlatExchange`` of ``arrs`` (``lanes`` graphs of ``P =
    rows / lanes`` shards each) under ``cfg``'s resolved scheme.
    Exchanges update the view in place."""
    n_local_max = arrs["indptr"].shape[1] - 1
    comm = AxisComm(arrs["prio"].shape[0] // lanes, lanes)
    if cfg.scheme == SPARSE:
        return _sparse_exchange(arrs, comm, n_local_max, cfg)
    if cfg.scheme != ALLGATHER:
        raise ValueError(f"scheme {cfg.scheme!r} must be resolved to "
                         f"{SCHEMES} before the run")
    return _allgather_exchange(arrs, comm, n_local_max, cfg)


def stats_to_host(stats: dict) -> dict:
    """Stats dict of python ints and device scalars -> python ints, with
    one device->host transfer for all device entries."""
    dev = {k: v for k, v in stats.items() if isinstance(v, torch.Tensor)}
    if dev:
        vals = torch.stack([v.reshape(()).long() for v in dev.values()])
        dev = dict(zip(dev, vals.tolist()))
    return {k: int(dev.get(k, v)) for k, v in stats.items()}
