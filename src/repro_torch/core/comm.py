"""Boundary exchange between the P simulated shards of one device.

Every device tensor of the port carries an explicit leading shard axis
``(P, …)``: the reference's ``vmap`` over its SPMD program, written out.
``AxisComm`` is the collective set over that axis (``psum``/``pmax``
reduce dim 0, ``index`` is ``arange(P)``).

Two exchange schemes produce bitwise-identical views (and the reference's
wire-byte accounting):

- ``"allgather"`` — every shard broadcasts its boundary payload
  ``view[boundary]``; ghost g of shard p reads entry ``ghost_slot[g]`` of
  owner ``ghost_owner[g]``'s payload.  ``(P-1)·max_b`` items per exchange.
- ``"sparse"`` — the paper's neighbour-to-neighbour scheme: round r ships
  from every shard p to ``(p + shifts[r]) % P`` the boundary colors that
  destination reads (``graph.CommPlan``).  On one device all rounds become
  one precomputed gather: each ghost's source (owner shard, send slot) and
  round are derived once, an exchange copies the ghosts of the rounds it
  runs, and the wire bytes are the plan's exact widths of those rounds.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.kernels.ref import take_rows

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
    """Collectives over the leading shard axis of ``(P, …)`` tensors."""

    P: int

    @staticmethod
    def psum(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    @staticmethod
    def pmax(x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    def index(self, device) -> torch.Tensor:
        return torch.arange(self.P, device=device)


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


def exchange_boundary(view: torch.Tensor, boundary: torch.Tensor,
                      ghost_owner: torch.Tensor, ghost_slot: torch.Tensor,
                      n_local_max: int, wire16: bool = False) -> torch.Tensor:
    """One broadcast boundary-color exchange (all-gather scheme).

    Payload ``view[p, boundary[p]]`` of every shard forms the ``(P,
    max_b)`` table; ghost slots refresh with one gather.  Updates ``view``
    in place (only its ghost slots) and returns it.
    """
    table = _wire(take_rows(view, boundary), wire16)       # (P, max_b)
    max_b = table.shape[1]
    flat = ghost_owner.long() * max_b + ghost_slot
    view[:, n_local_max:n_local_max + flat.shape[1]] = table.reshape(-1)[flat]
    return view


def sparse_rounds(arrs: dict) -> int:
    """Ring-shift rounds of the sparse plan in ``arrs`` (0 without one)."""
    if "shift_to_round" not in arrs:
        return 0
    return int((arrs["shift_to_round"][0] >= 0).sum())


class SparseExchange:
    """The sparse round schedule as one gather per exchange (see module doc).

    Built once per run from the plan arrays (``send_slot``,
    ``ghost_shift``, ``ghost_pos``, ``shift_to_round``, ``round_widths``);
    ``__call__(view, round_mask)`` refreshes the ghosts of the rounds in
    ``round_mask`` (host bools, ``None`` = all) in place and returns
    ``(view, wire_bytes)`` with the plan's exact widths.
    """

    def __init__(self, arrs: dict, n_local_max: int, cfg: CommConfig):
        send_slot = arrs["send_slot"]
        shift, pos = arrs["ghost_shift"], arrs["ghost_pos"]
        P, n_slots = arrs["prio"].shape
        n_ghost_cols = shift.shape[1]
        dev = send_slot.device
        s2r = arrs["shift_to_round"][0]
        q = torch.arange(P, device=dev)[:, None]
        k = shift.long().clamp(min=0)
        src = (q - k) % P
        rnd = s2r.long()[k]
        slot = send_slot[src, rnd.clamp(min=0),
                         pos.long().clamp(max=send_slot.shape[2] - 1)]
        real = shift >= 0
        # one device->host read at set-up: the ghosts of each round
        rnd = torch.where(real, rnd, -1).reshape(-1)
        dst = (q * n_slots + n_local_max
               + torch.arange(n_ghost_cols, device=dev)).reshape(-1)
        src_flat = (src * n_slots + slot).reshape(-1)
        order = torch.argsort(rnd, stable=True)
        n_rounds = sparse_rounds(arrs)
        counts = torch.bincount(rnd[order] + 1, minlength=n_rounds + 1)
        counts = counts.tolist()
        dst, src_flat = dst[order], src_flat[order]
        bounds = [sum(counts[:r + 1]) for r in range(n_rounds + 1)]
        self.dst = [dst[bounds[r]:bounds[r + 1]] for r in range(n_rounds)]
        self.src = [src_flat[bounds[r]:bounds[r + 1]] for r in range(n_rounds)]
        self.dst_all = dst[bounds[0]:]
        self.src_all = src_flat[bounds[0]:]
        self.widths = arrs["round_widths"][0, :n_rounds].tolist()
        self.n_rounds = n_rounds
        self.cfg = cfg

    def __call__(self, view: torch.Tensor, round_mask=None):
        if round_mask is None or all(round_mask):
            dst, src = self.dst_all, self.src_all
            width = sum(self.widths)
        else:
            live = [r for r in range(self.n_rounds) if round_mask[r]]
            dst = torch.cat([self.dst[r] for r in live]) if live else None
            src = torch.cat([self.src[r] for r in live]) if live else None
            width = sum(self.widths[r] for r in live)
        if dst is not None and dst.numel():
            flat = view.view(-1)
            flat[dst] = _wire(flat[src], self.cfg.wire16)
        return view, width * self.cfg.itemsize


def make_exchange(arrs: dict, cfg: CommConfig):
    """Build ``exchange(view, round_mask=None) -> (view, wire_bytes)``.

    ``round_mask`` (host bools per sparse round) selects the rounds a
    piggybacked exchange runs; the broadcast scheme ignores it and always
    ships ``(P-1)·max_b`` items.  Exchanges update ``view`` in place.
    """
    n_local_max = arrs["indptr"].shape[1] - 1
    if cfg.scheme == SPARSE:
        return SparseExchange(arrs, n_local_max, cfg)
    if cfg.scheme != ALLGATHER:
        raise ValueError(f"scheme {cfg.scheme!r} must be resolved to "
                         f"{SCHEMES} before the run")
    P, max_b = arrs["boundary"].shape
    wire_bytes = allgather_bytes_per_exchange(P, max_b, cfg.itemsize)

    def exchange(view, round_mask=None):
        exchange_boundary(view, arrs["boundary"], arrs["ghost_owner"],
                          arrs["ghost_slot"], n_local_max, cfg.wire16)
        return view, wire_bytes

    return exchange


def stats_to_host(stats: dict) -> dict:
    """Stats dict of python ints and device scalars -> python ints, with
    one device->host transfer for all device entries."""
    dev = {k: v for k, v in stats.items() if isinstance(v, torch.Tensor)}
    if dev:
        vals = torch.stack([v.reshape(()).long() for v in dev.values()])
        dev = dict(zip(dev, vals.tolist()))
    return {k: int(dev.get(k, v)) for k, v in stats.items()}
