"""Entry points of the color kernels, with a backend switch.

``select_colors`` (bitset color selection) and ``detect_conflicts`` (the
speculative repair's loser test) take a padded neighbour tile — the gather
of an ELL row block.  ``select_colors_d2`` / ``detect_conflicts_d2`` are
their distance-2 forms: they also take the strict two-hop tile (the gather
of ``nbr2`` rows) and treat its colors like the one-hop ones.

``select_run`` / ``recolor_run`` (and their ``_d2`` forms) are the fused
run form of the selection, which the coloring loops go through: one call
colors a whole run of speculative tiles or recolor chunks, on every shard,
in their sequential order, straight from the view (updated in place) and
the ELL arrays; each tile reads the view as it stood before the tile.
The tile-form ``select_colors[_d2]`` is the counterpart of the
reference's ``select_colors``.  ``detect_conflicts_frontier`` (and its
``_d2`` form) is the fused frontier form of the loser test, which the
speculative repair goes through: one call tests a whole round's frontier
on every shard, straight from the view and the ELL arrays, and returns
the uncolored copy of the view and the two counts.  ``greedy_run`` (and
its ``_d2`` form) is the sequential superstep coloring (the paper's
scalar loop, and every Least-Used run): one call colors a run of
supersteps one vertex at a time per shard, each vertex seeing every color
written before it.  ``exchange_push`` is the recoloring loop's boundary
exchange: after a run of recolor classes, each recolored row stores its
color at its ghost copies.  ``backend``:

  "cuda"  — the hand-written Hopper kernels in ``csrc/`` (built by
            ``build.py`` at first use); CUDA tensors only, and a launch
            that fails raises.
  "torch" — the plain PyTorch versions in ``ref.py``: the CPU path and
            the oracle the kernels are held against on the card.
  "auto"  — "cuda" for a CUDA tensor, "torch" for a CPU tensor.

Contract (the reference's ``repro/kernels/ops.py``): colors are 1-based
and bit 0 always counts as taken; neighbour colors ``<= 0`` or ``>=
max_colors`` are ignored; ``max_colors - 1`` is the saturation sentinel;
inactive rows return 0 / False; leading batch dims are flattened onto the
row axis (one launch for a ``(P, V, D)`` tile).  Tiles and colors are
int32; Random-X draws are passed as the int32 bit pattern of uint32 words;
priorities are int32 on the CUDA path.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

FIRST_FIT = "first_fit"
STAGGERED = "staggered"
RANDOM_X = "random_x"
LEAST_USED = "least_used"   # sequential by nature; not a tile strategy
SELECTIONS = (FIRST_FIT, STAGGERED, RANDOM_X)
# every strategy of the coloring loops (the sequential kernel takes all)
STRATEGIES = (FIRST_FIT, STAGGERED, LEAST_USED, RANDOM_X)

BACKENDS = ("auto", "torch", "cuda")

# shared memory a block may use on Hopper (227 KB); the select kernels
# keep W bitset words per warp: 8 warps per block in the tile form, up to
# 32 (one block per shard) in the run form
_MAX_SMEM = 227 * 1024
_SELECT_WARPS = 8
_RUN_WARPS = 32
# the sequential kernels (csrc/greedy_run.cuh): the shared memory a block
# may use, the most slots of the producers' ring, the local ids a slot
# lists, and the least ring that keeps the local colors in shared memory
_GREEDY_SMEM = _MAX_SMEM
_GREEDY_RING = 128
_GREEDY_LIST = 128
_GREEDY_MIN_RING = 32
_SLOT_HEADER = 5     # int32 words per slot: two flags, vertex, count, draw
_GREEDY_CONTROL = 26  # int32 words of the turn warps' state

_P = ctypes.c_void_p


class Kernel:
    """One hand-written CUDA kernel: its C entry point and launch count.

    ``launches`` is incremented once per successful launch, and nowhere
    else, so a run can show which kernels it went through; ``variants``
    counts the launches of a kernel with several template instantiations
    per instantiation (the sequential kernels: ``"shared"`` and
    ``"device"``, where the local colors live).
    """

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.variants: dict[str, int] = {}
        self._fn = None

    def launch(self, *args, variant: str | None = None) -> None:
        if self._fn is None:
            fn = getattr(build.load(self.name), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1

    def reset(self) -> None:
        """Set the launch counts to 0."""
        self.launches = 0
        self.variants = {}


COLOR_SELECT = Kernel(
    "color_select", "repro_color_select",
    [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, _P])
COLOR_SELECT_D2 = Kernel(
    "color_select_d2", "repro_color_select_d2",
    [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P])
CONFLICT = Kernel(
    "conflict", "repro_conflict",
    [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     _P])
CONFLICT_D2 = Kernel(
    "conflict_d2", "repro_conflict_d2",
    [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, _P])
_RUN_ARGS = [_P] * 10 + [ctypes.c_int, ctypes.c_longlong] + (
    [ctypes.c_int] * 15) + [_P]
SELECT_RUN = Kernel("select_run", "repro_select_run", _RUN_ARGS)
SELECT_RUN_D2 = Kernel("select_run_d2", "repro_select_run_d2", _RUN_ARGS)
_FRONTIER_ARGS = [_P] * 9 + [ctypes.c_int, ctypes.c_longlong] + (
    [ctypes.c_int] * 7) + [_P]
CONFLICT_FRONTIER = Kernel("conflict_frontier", "repro_conflict_frontier",
                           _FRONTIER_ARGS)
CONFLICT_FRONTIER_D2 = Kernel(
    "conflict_frontier_d2", "repro_conflict_frontier_d2", _FRONTIER_ARGS)
_GREEDY_ARGS = [_P] * 7 + [ctypes.c_int, ctypes.c_longlong] + (
    [ctypes.c_int] * 14) + [_P]
GREEDY_RUN = Kernel("greedy_run", "repro_greedy_run", _GREEDY_ARGS)
GREEDY_RUN_D2 = Kernel("greedy_run_d2", "repro_greedy_run_d2", _GREEDY_ARGS)
EXCHANGE_PUSH = Kernel(
    "exchange_push", "repro_exchange_push",
    [_P] * 7 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 9
    + [_P])
KERNELS = (COLOR_SELECT, CONFLICT, COLOR_SELECT_D2, CONFLICT_D2, SELECT_RUN,
           SELECT_RUN_D2, CONFLICT_FRONTIER, CONFLICT_FRONTIER_D2,
           GREEDY_RUN, GREEDY_RUN_D2, EXCHANGE_PUSH)


def resolve_backend(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}, want one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "torch"
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors, got a tensor on "
                         f"{t.device}")
    return backend


def _rows(a, lead: tuple, v: int, device) -> torch.Tensor:
    """A per-row operand (python scalar, (…, V) or broadcastable) -> flat
    contiguous int32 (rows,)."""
    if isinstance(a, int):      # made on the device: no host copy per call
        return torch.full((math.prod(lead) * v,), a, dtype=torch.int32,
                          device=device)
    a = torch.as_tensor(a, device=device)
    if a.dtype == torch.bool:
        a = a.to(torch.int32)
    if a.dtype != torch.int32:
        raise TypeError(f"per-row operands must be int32 or bool, got {a.dtype}")
    return torch.broadcast_to(a, lead + (v,)).reshape(-1).contiguous()


def _tile(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.int32:
        raise TypeError(f"neighbour tiles must be int32, got {t.dtype}")
    return t.reshape(-1, t.shape[-1]).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on one "
                             f"CUDA device ({t.device} vs {dev})")


def select_colors(nbr_colors: torch.Tensor, active, rand_u32=None, *,
                  max_colors: int, selection: str = FIRST_FIT, x: int = 10,
                  offset=None, backend: str = "auto") -> torch.Tensor:
    """Tile-parallel color selection over a padded neighbour tile.

    ``nbr_colors`` (…, V, MAXD) int32; ``active`` (…, V) bool/int32;
    ``rand_u32`` (…, V) int32 bit pattern (random_x only); ``offset``
    scalar or (…, V) int32 (staggered only).  Returns (…, V) int32, 0
    where inactive.
    """
    return _select((nbr_colors,), active, rand_u32, max_colors=max_colors,
                   selection=selection, x=x, offset=offset, backend=backend)


def select_colors_d2(nbr_colors: torch.Tensor, nbr2_colors: torch.Tensor,
                     active, rand_u32=None, *, max_colors: int,
                     selection: str = FIRST_FIT, x: int = 10, offset=None,
                     backend: str = "auto") -> torch.Tensor:
    """Distance-2 color selection over two padded neighbour tiles.

    ``select_colors``' contract plus ``nbr2_colors`` (…, V, MAXD2) int32,
    the strict two-hop neighbour colors: the chosen color differs from
    every color within graph distance 2.
    """
    return _select((nbr_colors, nbr2_colors), active, rand_u32,
                   max_colors=max_colors, selection=selection, x=x,
                   offset=offset, backend=backend)


def _select(tiles: tuple, active, rand_u32, *, max_colors: int,
            selection: str, x: int, offset, backend: str) -> torch.Tensor:
    """``select_colors`` over one tile (distance 1) or two (distance 2)."""
    if selection not in SELECTIONS:
        raise ValueError(
            f"unknown selection {selection!r}, want one of {SELECTIONS}")
    if max_colors % 32 or max_colors <= 0:
        raise ValueError(f"max_colors={max_colors} must be a positive "
                         "multiple of 32")
    backend = resolve_backend(backend, tiles[0])
    *lead, v, _ = tiles[0].shape
    lead = tuple(lead)
    _same_rows(tiles, lead + (v,))
    dev = tiles[0].device
    flat = tuple(_tile(t) for t in tiles)
    act = _rows(active, lead, v, dev)
    rand = _rows(0 if rand_u32 is None else rand_u32, lead, v, dev)
    off = _rows(0 if offset is None else offset, lead, v, dev)
    staggered = selection == STAGGERED
    x_eff = x if selection == RANDOM_X else 0
    if x_eff < 0:
        raise ValueError(f"random_x needs x >= 0, got {x}")
    if backend == "torch":
        plain = ref.select_colors if len(flat) == 1 else ref.select_colors_d2
        out = plain(*flat, act, rand, off, max_colors=max_colors, x=x_eff,
                    staggered=staggered)
    else:
        out = _select_cuda(flat, act, rand, off, max_colors, x_eff, staggered)
    return out.reshape(lead + (v,))


def _same_rows(tiles: tuple, rows: tuple) -> None:
    for t in tiles[1:]:
        if tuple(t.shape[:-1]) != rows:
            raise ValueError(f"tiles {tuple(tiles[0].shape)} and "
                             f"{tuple(t.shape)} differ in their rows")


def _check_smem(max_colors: int, warps: int) -> int:
    """Bitset words per row; raises when ``warps`` bitsets do not fit."""
    n_words = max_colors // 32
    if warps * n_words * 4 > _MAX_SMEM:
        raise ValueError(
            f"max_colors={max_colors} needs {warps * n_words * 4} bytes of "
            f"shared memory per block; the CUDA select kernels take at most "
            f"{_MAX_SMEM} (max_colors <= {_MAX_SMEM * 8 // warps})")
    return n_words


def _select_cuda(tiles, act, rand, off, max_colors, x, staggered):
    _check_cuda(*tiles, act, rand, off)
    n_words = _check_smem(max_colors, _SELECT_WARPS)
    rows = tiles[0].shape[0]
    dev = tiles[0].device
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        kernel = COLOR_SELECT if len(tiles) == 1 else COLOR_SELECT_D2
        kernel.launch(
            *(t.data_ptr() for t in tiles), act.data_ptr(), rand.data_ptr(),
            off.data_ptr(), out.data_ptr(), rows,
            *(t.shape[1] for t in tiles), n_words, x, int(staggered),
            dev.index, _stream(tiles[0]))
    return out


def select_run(view: torch.Tensor, order_pad: torch.Tensor,
               nbr: torch.Tensor, rand=None, offset=None, *, first_step: int,
               n_steps: int, superstep: int, tile: int, max_colors: int,
               selection: str = FIRST_FIT, x: int = 10,
               backend: str = "auto") -> torch.Tensor:
    """Speculative supersteps ``first_step … first_step + n_steps - 1`` in
    one call: each superstep as ``ceil(superstep / tile)`` tiles of
    ``tile`` rows, in order, on every shard (``ref.select_run``).

    ``view`` ``(P, n_slots)`` int32, updated in place and returned (its
    sentinel slot ``n_slots - 1`` holds 0); ``order_pad`` ``(P, L)`` visit
    order of local slots, -1 = skip; ``nbr`` ``(P, n_local_max, MAXD)``,
    each row its slot ids first and then sentinel padding (as
    ``core.to_device`` lays it out: the kernel reads a row wider than one
    round of its loads, 256 ids, only up to its first sentinel);
    ``rand`` ``(P, n_local_max)`` int32 bit patterns (random_x only);
    ``offset`` ``(P, 1)``/``(P,)`` int32 per-shard start colors (staggered
    only).
    """
    return _select_run(view, order_pad, (nbr,), rand, offset,
                       first_step=first_step, n_steps=n_steps,
                       superstep=superstep, tile=tile, max_colors=max_colors,
                       selection=selection, x=x, backend=backend)


def select_run_d2(view: torch.Tensor, order_pad: torch.Tensor,
                  nbr: torch.Tensor, nbr2: torch.Tensor, rand=None,
                  offset=None, *, first_step: int, n_steps: int,
                  superstep: int, tile: int, max_colors: int,
                  selection: str = FIRST_FIT, x: int = 10,
                  backend: str = "auto") -> torch.Tensor:
    """``select_run`` at distance 2: ``nbr2`` ``(P, n_local_max, MAXD2)``
    is the strict two-hop ELL, whose colors count like the one-hop ones."""
    return _select_run(view, order_pad, (nbr, nbr2), rand, offset,
                       first_step=first_step, n_steps=n_steps,
                       superstep=superstep, tile=tile, max_colors=max_colors,
                       selection=selection, x=x, backend=backend)


def recolor_run(view: torch.Tensor, nbr: torch.Tensor,
                sorted_pad: torch.Tensor, start: torch.Tensor,
                sizes: torch.Tensor, class_chunks: torch.Tensor, *,
                first_class: int, last_class: int, chunk: int,
                max_colors: int, backend: str = "auto") -> torch.Tensor:
    """First Fit of recolor classes ``first_class … last_class`` in one
    call, every chunk of every class in order, on every shard
    (``ref.recolor_run``).

    ``sorted_pad`` ``(P, n_local_max + chunk)`` step-sorted local rows;
    ``start``/``sizes`` ``(P, n_cls)`` first sorted position and rows of
    class t per shard; ``class_chunks`` ``(n_cls,)`` chunks of class t
    (the same on every shard), or ``(L, n_cls)`` for a batch of L graphs
    (lanes) of ``P / L`` shards each, which shard p reads at row ``p //
    (P / L)``.  ``view`` as in ``select_run``.
    """
    return _recolor_run(view, (nbr,), sorted_pad, start, sizes, class_chunks,
                        first_class=first_class, last_class=last_class,
                        chunk=chunk, max_colors=max_colors, backend=backend)


def recolor_run_d2(view: torch.Tensor, nbr: torch.Tensor, nbr2: torch.Tensor,
                   sorted_pad: torch.Tensor, start: torch.Tensor,
                   sizes: torch.Tensor, class_chunks: torch.Tensor, *,
                   first_class: int, last_class: int, chunk: int,
                   max_colors: int, backend: str = "auto") -> torch.Tensor:
    """``recolor_run`` at distance 2 (``nbr2`` as in ``select_run_d2``)."""
    return _recolor_run(view, (nbr, nbr2), sorted_pad, start, sizes,
                        class_chunks, first_class=first_class,
                        last_class=last_class, chunk=chunk,
                        max_colors=max_colors, backend=backend)


def _select_run(view, order_pad, nbrs, rand, offset, *, first_step, n_steps,
                superstep, tile, max_colors, selection, x, backend):
    if selection not in SELECTIONS:
        raise ValueError(
            f"unknown selection {selection!r}, want one of {SELECTIONS}")
    _check_run(view, nbrs, max_colors, tile)
    if superstep <= 0 or first_step < 0:
        raise ValueError(f"bad superstep {superstep} / first step "
                         f"{first_step}")
    if order_pad.shape[1] < tile:
        raise ValueError(f"order_pad has {order_pad.shape[1]} columns, "
                         f"fewer than a tile of {tile}")
    staggered = selection == STAGGERED
    x_eff = x if selection == RANDOM_X else 0
    if x_eff < 0:
        raise ValueError(f"random_x needs x >= 0, got {x}")
    if x_eff and rand is None:
        raise ValueError("random_x needs the per-row draws rand=")
    P = view.shape[0]
    off = None
    if staggered:     # one start color per shard, (P,)
        off = torch.broadcast_to(torch.as_tensor(
            0 if offset is None else offset, device=view.device).reshape(-1),
            (P,))
    backend = resolve_backend(backend, view)
    if n_steps <= 0:
        return view
    if backend == "torch":
        return ref.select_run(view, order_pad, nbrs, rand,
                              None if off is None else off[:, None],
                              first_step=first_step, n_steps=n_steps,
                              superstep=superstep, tile=tile,
                              max_colors=max_colors, x=x_eff,
                              staggered=staggered)
    return _launch_run(view, nbrs, _int32(order_pad),
                       _int32(rand) if x_eff else None,
                       _int32(off) if staggered else None, None, first_step,
                       first_step + n_steps - 1, superstep, tile, max_colors,
                       x_eff, staggered)


def _recolor_run(view, nbrs, sorted_pad, start, sizes, class_chunks, *,
                 first_class, last_class, chunk, max_colors, backend):
    _check_run(view, nbrs, max_colors, chunk)
    if sorted_pad.shape[1] != nbrs[0].shape[1] + chunk:
        raise ValueError(f"sorted_pad {tuple(sorted_pad.shape)} must have "
                         f"n_local_max + chunk = {nbrs[0].shape[1] + chunk} "
                         "columns")
    chunks2 = class_chunks.reshape(-1, class_chunks.shape[-1])
    if class_chunks.dim() > 2 or view.shape[0] % chunks2.shape[0]:
        raise ValueError(f"class_chunks {tuple(class_chunks.shape)} must be "
                         f"(n_cls,) or (L, n_cls) with L dividing the "
                         f"{view.shape[0]} shards")
    if first_class < 0 or last_class >= chunks2.shape[1]:
        raise ValueError(f"classes [{first_class}, {last_class}] out of "
                         f"range of {chunks2.shape[1]}")
    backend = resolve_backend(backend, view)
    if last_class < first_class:
        return view
    if backend == "torch":
        return ref.recolor_run(view, nbrs, sorted_pad, start, sizes,
                               chunks2, first_class=first_class,
                               last_class=last_class, chunk=chunk,
                               max_colors=max_colors)
    sched = (_int32(start), _int32(sizes), _int32(chunks2))
    return _launch_run(view, nbrs, _int32(sorted_pad), None, None, sched,
                       first_class, last_class, 0, chunk, max_colors, 0,
                       False)


def _check_run(view, nbrs, max_colors: int, tile: int) -> None:
    if max_colors % 32 or max_colors <= 0:
        raise ValueError(f"max_colors={max_colors} must be a positive "
                         "multiple of 32")
    if tile <= 0:
        raise ValueError(f"tile/chunk must be > 0, got {tile}")
    _check_ell(view, nbrs)


def _check_ell(view, nbrs) -> None:
    if view.dtype != torch.int32 or view.dim() != 2:
        raise TypeError(f"the view must be (P, n_slots) int32, got "
                        f"{view.dtype} {tuple(view.shape)}")
    for n in nbrs:
        if n.dtype != torch.int32 or n.dim() != 3:
            raise TypeError(f"ELL arrays must be (P, n_local_max, D) int32, "
                            f"got {n.dtype} {tuple(n.shape)}")
        if n.shape[:2] != nbrs[0].shape[:2] or n.shape[0] != view.shape[0]:
            raise ValueError(f"ELL {tuple(n.shape)} does not match "
                             f"{tuple(nbrs[0].shape)} / view "
                             f"{tuple(view.shape)}")


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _launch_run(view, nbrs, rows, rand, off, sched, first, last, superstep,
                tile, max_colors, x, staggered):
    """One launch of SELECT_RUN[_D2]: ``sched`` is (start, sizes,
    class_chunks ``(L, n_cls)``) in recolor mode and None in speculative
    mode."""
    nbrs = tuple(n.contiguous() for n in nbrs)
    live = [t for t in (view, rows, rand, off, *nbrs, *(sched or ()))
            if t is not None]
    _check_cuda(*live)
    n_words = _check_smem(max_colors, min(tile, _RUN_WARPS))
    P, n_slots = view.shape
    scratch = torch.empty((P, tile), dtype=torch.int32, device=view.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    start, sizes, chunks = sched or (None, None, None)
    lane_shards = P if chunks is None else P // chunks.shape[0]
    kernel = SELECT_RUN if len(nbrs) == 1 else SELECT_RUN_D2
    kernel.launch(
        view.data_ptr(), rows.data_ptr(), nbrs[0].data_ptr(),
        ptr(nbrs[1] if len(nbrs) > 1 else None), ptr(rand), ptr(off),
        ptr(start), ptr(sizes), ptr(chunks), scratch.data_ptr(), P, n_slots,
        rows.shape[1], nbrs[0].shape[1], nbrs[0].shape[2],
        nbrs[1].shape[2] if len(nbrs) > 1 else 0,
        0 if start is None else start.shape[1], lane_shards, first, last,
        superstep, tile,
        int(sched is not None), n_words, x, int(staggered), view.device.index,
        _stream(view))
    return view


def detect_conflicts(my_color, my_prio, nbr_colors: torch.Tensor,
                     nbr_prio: torch.Tensor, active, *,
                     backend: str = "auto") -> torch.Tensor:
    """Tile-parallel conflict detection: a row loses iff it is active and a
    neighbour holds the same nonzero color with a strictly higher priority.
    Operands (…, V) and (…, V, MAXD); returns (…, V) bool.
    """
    return _conflicts(my_color, my_prio, ((nbr_colors, nbr_prio),), active,
                      backend)


def detect_conflicts_d2(my_color, my_prio, nbr_colors: torch.Tensor,
                        nbr_prio: torch.Tensor, nbr2_colors: torch.Tensor,
                        nbr2_prio: torch.Tensor, active, *,
                        backend: str = "auto") -> torch.Tensor:
    """Distance-2 conflict detection: a row loses iff it is active and a
    neighbour within graph distance 2 (one-hop tile or strict two-hop tile
    ``(…, V, MAXD2)``) holds the same nonzero color with a strictly higher
    priority.  Returns (…, V) bool.
    """
    return _conflicts(my_color, my_prio, ((nbr_colors, nbr_prio),
                                          (nbr2_colors, nbr2_prio)),
                      active, backend)


def _conflicts(my_color, my_prio, pairs: tuple, active,
               backend: str) -> torch.Tensor:
    """``detect_conflicts`` over one (colors, priorities) tile pair
    (distance 1) or two (distance 2)."""
    backend = resolve_backend(backend, pairs[0][0])
    *lead, v, _ = pairs[0][0].shape
    lead = tuple(lead)
    shape = lead + (v,)
    _same_rows(tuple(t for pair in pairs for t in pair), shape)
    dev = pairs[0][0].device
    if backend == "torch":
        row = lambda a: torch.broadcast_to(torch.as_tensor(a, device=dev),
                                           shape).reshape(-1)
        mat = lambda t: t.reshape(-1, t.shape[-1])
        plain = ref.detect_conflicts if len(pairs) == 1 else (
            ref.detect_conflicts_d2)
        out = plain(row(my_color), row(my_prio),
                    *(mat(t) for pair in pairs for t in pair), row(active))
        return out.reshape(shape)
    if torch.as_tensor(my_prio).dtype != torch.int32 or any(
            p.dtype != torch.int32 for _, p in pairs):
        raise TypeError("the CUDA conflict kernels take int32 priorities "
                        "(int64 ids, past 2**31 vertices, are not supported)")
    myc = _rows(my_color, lead, v, dev)
    myp = _rows(my_prio, lead, v, dev)
    act = _rows(active, lead, v, dev)
    flat = [(_tile(c), _tile(p)) for c, p in pairs]
    for tc, tp in flat:
        if tc.shape != tp.shape:
            raise ValueError(f"color tile {tuple(tc.shape)} and priority "
                             f"tile {tuple(tp.shape)} differ")
    _check_cuda(*(t for pair in flat for t in pair), myc, myp, act)
    rows = flat[0][0].shape[0]
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        kernel = CONFLICT if len(flat) == 1 else CONFLICT_D2
        kernel.launch(myc.data_ptr(), myp.data_ptr(),
                      *(t.data_ptr() for pair in flat for t in pair),
                      act.data_ptr(), out.data_ptr(), rows,
                      *(tc.shape[1] for tc, _ in flat), dev.index,
                      _stream(flat[0][0]))
    return out.reshape(shape).bool()


def detect_conflicts_frontier(view: torch.Tensor, prio: torch.Tensor,
                              is_internal: torch.Tensor,
                              order_pad: torch.Tensor, nbr: torch.Tensor,
                              n_need: torch.Tensor, *, n_steps: int,
                              superstep: int, lanes: int | None = None,
                              backend: str = "auto"):
    """The repair of one speculative round in one call: over the first
    ``n_steps * superstep`` positions of the visit order on every shard,
    uncolor each active row that loses (``ref.detect_conflicts_frontier``).

    ``view`` ``(P, n_slots)`` int32, only read (its sentinel slot
    ``n_slots - 1`` holds 0); ``prio`` ``(P, n_slots)`` priorities (int32
    on the card); ``is_internal`` ``(P, n_local_max)`` bool; ``order_pad``
    ``(P, L)`` visit order of local slots, -1 = skip; ``nbr`` ``(P,
    n_local_max, MAXD)``, each row its slot ids first and then sentinel
    padding (as ``select_run`` reads it); ``n_need`` ``(P,)`` rows to
    rescan per shard (position i is active iff ``i < n_need[p]`` and its
    entry is ``>= 0``).  Returns ``(new_view, n_conflicts,
    any_boundary_conflict)``: a new view with the losers at 0, an int64
    and a bool device scalar.  With ``lanes=L`` the P shards are L graphs
    of ``P / L`` shards each (a batch laid end to end), and the two counts
    are ``(L,)`` tensors, one per graph.
    """
    return _conflicts_frontier(view, prio, is_internal, order_pad, (nbr,),
                               n_need, n_steps=n_steps, superstep=superstep,
                               lanes=lanes, backend=backend)


def detect_conflicts_frontier_d2(view: torch.Tensor, prio: torch.Tensor,
                                 is_internal: torch.Tensor,
                                 order_pad: torch.Tensor, nbr: torch.Tensor,
                                 nbr2: torch.Tensor, n_need: torch.Tensor, *,
                                 n_steps: int, superstep: int,
                                 lanes: int | None = None,
                                 backend: str = "auto"):
    """``detect_conflicts_frontier`` at distance 2: a row also loses
    against its strict two-hop ELL row ``nbr2`` ``(P, n_local_max,
    MAXD2)``."""
    return _conflicts_frontier(view, prio, is_internal, order_pad,
                               (nbr, nbr2), n_need, n_steps=n_steps,
                               superstep=superstep, lanes=lanes,
                               backend=backend)


def _conflicts_frontier(view, prio, is_internal, order_pad, nbrs, n_need, *,
                        n_steps, superstep, lanes, backend):
    _check_ell(view, nbrs)
    P, n_slots = view.shape
    L = 1 if lanes is None else lanes
    if L <= 0 or P % L:
        raise ValueError(f"{L} lanes do not divide the {P} shards")
    if superstep <= 0 or n_steps < 0:
        raise ValueError(f"bad superstep {superstep} / n_steps {n_steps}")
    n_pos = n_steps * superstep
    if n_pos > order_pad.shape[1]:
        raise ValueError(f"{n_steps} supersteps of {superstep} pass the "
                         f"{order_pad.shape[1]} columns of order_pad")
    if (tuple(prio.shape) != (P, n_slots)
            or tuple(is_internal.shape) != (P, nbrs[0].shape[1])
            or tuple(n_need.shape) != (P,)):
        raise ValueError(f"prio {tuple(prio.shape)} / is_internal "
                         f"{tuple(is_internal.shape)} / n_need "
                         f"{tuple(n_need.shape)} do not match view "
                         f"{tuple(view.shape)} / ELL "
                         f"{tuple(nbrs[0].shape)}")
    backend = resolve_backend(backend, view)
    if backend == "torch":
        new_view, n_conf, bnd = ref.detect_conflicts_frontier(
            view, prio, is_internal, order_pad, nbrs, n_need,
            n_steps=n_steps, superstep=superstep, lanes=L)
        return (new_view, n_conf, bnd) if lanes else (new_view, n_conf[0],
                                                      bnd[0])
    if prio.dtype != torch.int32:
        raise TypeError("the CUDA conflict kernels take int32 priorities "
                        "(int64 ids, past 2**31 vertices, are not supported)")
    new_view = view.clone()
    counts = torch.zeros((L, 2), dtype=torch.int64, device=view.device)
    if P and n_pos:
        launch_frontier(view, prio, is_internal, order_pad, nbrs, n_need,
                        n_pos, new_view, counts)
    if lanes:
        return new_view, counts[:, 0], counts[:, 1] != 0
    return new_view, counts[0, 0], counts[0, 1] != 0


def launch_frontier(view, prio, is_internal, order_pad, nbrs, n_need,
                    n_pos: int, new_view, counts) -> None:
    """One launch of CONFLICT_FRONTIER[_D2] over the first ``n_pos``
    positions, into the caller's ``new_view`` (a copy of ``view``) and
    zeroed ``counts`` ``(L, 2)`` int64: the kernel alone, without the
    entry point's copy and count buffer (``detect_conflicts_frontier``)."""
    P, n_slots = view.shape
    nbrs = tuple(n.contiguous() for n in nbrs)
    rows = _int32(order_pad)
    internal = is_internal.to(torch.bool).contiguous()
    need = n_need.to(torch.int64).contiguous()
    _check_cuda(view, prio, internal, rows, need, new_view, counts, *nbrs)
    kernel = CONFLICT_FRONTIER if len(nbrs) == 1 else CONFLICT_FRONTIER_D2
    kernel.launch(
        view.data_ptr(), prio.data_ptr(), internal.data_ptr(),
        rows.data_ptr(), nbrs[0].data_ptr(),
        nbrs[1].data_ptr() if len(nbrs) > 1 else None, need.data_ptr(),
        new_view.data_ptr(), counts.data_ptr(), P, n_slots,
        rows.shape[1], n_pos, nbrs[0].shape[1], nbrs[0].shape[2],
        nbrs[1].shape[2] if len(nbrs) > 1 else 0, P // counts.shape[0],
        view.device.index, _stream(view))


def exchange_push(view: torch.Tensor, fan_ptr: torch.Tensor,
                  fan_dst: torch.Tensor, sorted_pad: torch.Tensor,
                  start: torch.Tensor, sizes: torch.Tensor, lane_on=None, *,
                  first_class: int, last_class: int, wire16: bool = False,
                  backend: str = "auto") -> torch.Tensor:
    """Push the colors of recolor classes ``first_class … last_class`` to
    their ghost copies (``ref.exchange_push``): the recoloring loop's
    boundary exchange, one launch a run of classes.

    ``view`` ``(S, n_slots)`` int32 is updated in place and returned.
    ``fan_ptr`` ``(S, n_local_max + 1)`` and ``fan_dst`` ``(E,)`` (both
    int32, or both int64 for a view of 2^31 entries or more) are the
    exchange's fan-out: the ghost copies of shard p's local row v are the
    flat view entries ``fan_dst[fan_ptr[p, v] : fan_ptr[p, v + 1]]``.
    ``sorted_pad``, ``start``, ``sizes`` as in ``recolor_run``, int32:
    shard p pushes its sorted rows ``[start[p, first_class], start[p,
    last_class] + sizes[p, last_class])``.  ``lane_on`` ``(L,)`` int32
    (``None`` = all): the S shards are L lanes of ``S / L``, and a lane
    that is 0 pushes nothing.  ``wire16`` sends each color through int16.
    The operands are taken as they are, not converted: one call a run of
    classes, and the host time of a call counts where the host sets the
    pace.
    """
    S, n_slots = view.shape
    if view.dim() != 2 or any(t is not None and t.dtype != torch.int32 for t
                              in (view, sorted_pad, start, sizes, lane_on)):
        raise TypeError("the view, sorted_pad, start, sizes and lane_on "
                        "must be int32, the view (S, n_slots)")
    n_local_max = fan_ptr.shape[1] - 1
    if (fan_ptr.dim() != 2 or fan_ptr.shape[0] != S
            or fan_ptr.dtype != fan_dst.dtype
            or fan_ptr.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"fan_ptr {fan_ptr.dtype} {tuple(fan_ptr.shape)} "
                         f"and fan_dst {fan_dst.dtype} must be int32 or "
                         f"int64 alike, fan_ptr (S={S}, n_local_max + 1)")
    if fan_ptr.dtype == torch.int32 and view.numel() > 2**31 - 1:
        raise ValueError("a view of 2^31 entries or more needs an int64 "
                         "fan-out")
    if sorted_pad.shape[0] != S or sorted_pad.shape[1] < n_local_max:
        raise ValueError(f"sorted_pad {tuple(sorted_pad.shape)} must have "
                         f"{S} rows of at least {n_local_max} positions")
    if start.shape != sizes.shape or start.shape[0] != S:
        raise ValueError(f"start {tuple(start.shape)} and sizes "
                         f"{tuple(sizes.shape)} must be (S={S}, n_cls)")
    if first_class < 0 or last_class >= start.shape[1]:
        raise ValueError(f"classes [{first_class}, {last_class}] out of "
                         f"range of {start.shape[1]}")
    if lane_on is not None and (lane_on.dim() != 1
                                or S % lane_on.shape[0]):
        raise ValueError(f"lane_on {tuple(lane_on.shape)} must be (L,) with "
                         f"L dividing the {S} shards")
    backend = resolve_backend(backend, view)
    if last_class < first_class:
        return view
    if backend == "torch":
        return ref.exchange_push(view, fan_ptr, fan_dst, sorted_pad, start,
                                 sizes, lane_on, first_class=first_class,
                                 last_class=last_class, wire16=wire16)
    on = lane_on
    _check_cuda(*(t for t in (view, fan_ptr, fan_dst, sorted_pad, start,
                              sizes, on) if t is not None))
    EXCHANGE_PUSH.launch(
        view.data_ptr(), fan_ptr.data_ptr(), fan_dst.data_ptr(),
        sorted_pad.data_ptr(), start.data_ptr(), sizes.data_ptr(),
        None if on is None else on.data_ptr(), S, n_slots,
        sorted_pad.shape[1], n_local_max, start.shape[1],
        S if on is None else S // on.shape[0], first_class, last_class,
        int(wire16), int(fan_ptr.dtype == torch.int64), view.device.index,
        _stream(view))
    return view


def greedy_run(view: torch.Tensor, usage: torch.Tensor,
               order_pad: torch.Tensor, nbr: torch.Tensor, rand=None,
               offset=None, *, first_step: int, n_steps: int,
               superstep: int, max_colors: int, selection: str = FIRST_FIT,
               x: int = 10, backend: str = "auto"):
    """Sequential supersteps ``first_step … first_step + n_steps - 1`` in
    one call: their positions of the visit order one at a time, in order,
    on every shard (``ref.greedy_run``).

    ``view`` ``(P, n_slots)`` int32 and ``usage`` ``(P, max_colors)`` int32
    (colors handed out per shard so far, read by Least-Used) are updated
    in place and returned; ``order_pad``, ``nbr``, ``rand`` and ``offset``
    as in ``select_run``.  ``selection`` may also be ``"least_used"``.
    """
    return _greedy_run(view, usage, order_pad, (nbr,), rand, offset,
                       first_step=first_step, n_steps=n_steps,
                       superstep=superstep, max_colors=max_colors,
                       selection=selection, x=x, backend=backend)


def greedy_run_d2(view: torch.Tensor, usage: torch.Tensor,
                  order_pad: torch.Tensor, nbr: torch.Tensor,
                  nbr2: torch.Tensor, rand=None, offset=None, *,
                  first_step: int, n_steps: int, superstep: int,
                  max_colors: int, selection: str = FIRST_FIT, x: int = 10,
                  backend: str = "auto"):
    """``greedy_run`` at distance 2 (``nbr2`` as in ``select_run_d2``)."""
    return _greedy_run(view, usage, order_pad, (nbr, nbr2), rand, offset,
                       first_step=first_step, n_steps=n_steps,
                       superstep=superstep, max_colors=max_colors,
                       selection=selection, x=x, backend=backend)


def _greedy_run(view, usage, order_pad, nbrs, rand, offset, *, first_step,
                n_steps, superstep, max_colors, selection, x, backend):
    if selection not in STRATEGIES:
        raise ValueError(f"unknown selection {selection!r}, want one of "
                         f"{STRATEGIES}")
    _check_run(view, nbrs, max_colors, superstep)
    P = view.shape[0]
    if usage.dtype != torch.int32 or tuple(usage.shape) != (P, max_colors):
        raise TypeError(f"usage must be ({P}, {max_colors}) int32, got "
                        f"{usage.dtype} {tuple(usage.shape)}")
    if first_step < 0 or (first_step + max(n_steps, 0)) * superstep > (
            order_pad.shape[1]):
        raise ValueError(f"supersteps {first_step} + {n_steps} of "
                         f"{superstep} pass the {order_pad.shape[1]} "
                         "columns of order_pad")
    staggered = selection == STAGGERED
    x_eff = x if selection == RANDOM_X else 0
    if x_eff < 0:
        raise ValueError(f"random_x needs x >= 0, got {x}")
    if x_eff and rand is None:
        raise ValueError("random_x needs the per-row draws rand=")
    off = None
    if staggered:     # one start color per shard, (P,)
        off = torch.broadcast_to(torch.as_tensor(
            0 if offset is None else offset, device=view.device).reshape(-1),
            (P,))
    backend = resolve_backend(backend, view)
    if n_steps <= 0:
        return view, usage
    if backend == "torch":
        return ref.greedy_run(view, usage, order_pad, nbrs,
                              rand if x_eff else None, off,
                              first_step=first_step, n_steps=n_steps,
                              superstep=superstep, max_colors=max_colors,
                              x=x_eff, staggered=staggered,
                              least_used=selection == LEAST_USED)
    n_words = max_colors // 32
    variant, ring, list_cap = _greedy_layout(nbrs[0].shape[1], max_colors)
    nbrs = tuple(n.contiguous() for n in nbrs)
    rows = _int32(order_pad)
    rand = _int32(rand) if x_eff else None
    off = _int32(off) if staggered else None
    _check_cuda(*(t for t in (view, usage, rows, rand, off, *nbrs)
                  if t is not None))
    P, n_slots = view.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    kernel = GREEDY_RUN if len(nbrs) == 1 else GREEDY_RUN_D2
    kernel.launch(
        view.data_ptr(), usage.data_ptr(), rows.data_ptr(),
        nbrs[0].data_ptr(), ptr(nbrs[1] if len(nbrs) > 1 else None),
        ptr(rand), ptr(off), P, n_slots, rows.shape[1], nbrs[0].shape[1],
        nbrs[0].shape[2], nbrs[1].shape[2] if len(nbrs) > 1 else 0,
        first_step * superstep, (first_step + n_steps) * superstep, n_words,
        x_eff, int(staggered), int(selection == LEAST_USED), ring, list_cap,
        int(variant == "shared"), view.device.index, _stream(view),
        variant=variant)
    return view, usage


def _greedy_layout(n_local_max: int, max_colors: int,
                   budget: int | None = None) -> tuple[str, int, int]:
    """Which instantiation of the sequential kernels a launch takes, from
    the shapes alone: ``(variant, ring, list_cap)``.

    A block holds the usage row (``max_colors`` int32), the turn warps'
    state (``_GREEDY_CONTROL`` int32), a ring of slots
    (per slot: a 5-word header, the ``max_colors / 32``-word bitset and
    ``list_cap`` local ids) and, in the ``"shared"`` form, the shard's
    ``n_local_max`` local colors as 16-bit values
    (``greedy_run.cuh:greedy_smem_bytes``).  ``"shared"`` when the local
    colors fit beside a ring of at least ``_GREEDY_MIN_RING`` slots (up to
    ``_GREEDY_RING``); else ``"device"``, the local colors read and written
    in device memory, with the largest ring that fits (its id lists cut
    down only when not one slot fits whole).  ``budget`` defaults to
    ``_GREEDY_SMEM`` bytes.  Raises when not even a one-slot ring fits.
    """
    budget = _GREEDY_SMEM if budget is None else budget
    n_words = max_colors // 32
    room = budget // 4 - max_colors - _GREEDY_CONTROL  # int32 words left
    slot = _SLOT_HEADER + n_words + _GREEDY_LIST
    ring = min(_GREEDY_RING, (room - (n_local_max + 1) // 2) // slot)
    if ring >= _GREEDY_MIN_RING:
        return "shared", ring, _GREEDY_LIST
    ring = min(_GREEDY_RING, room // slot)
    if ring >= 1:
        return "device", ring, _GREEDY_LIST
    list_cap = room - _SLOT_HEADER - n_words
    if list_cap < 0:
        raise ValueError(
            f"max_colors={max_colors} needs "
            f"{4 * (max_colors + _GREEDY_CONTROL + _SLOT_HEADER + n_words)} "
            f"bytes of shared memory (usage row, turn state and one ring "
            f"slot); the CUDA sequential kernels take at most {budget}")
    return "device", 1, list_cap
