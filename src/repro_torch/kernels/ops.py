"""Entry points of the color kernels, with a backend switch.

``select_colors`` (bitset color selection) and ``detect_conflicts`` (the
speculative repair's loser test) take a padded neighbour tile — the gather
of an ELL row block — and are the only way the coloring code reaches a
kernel.  ``select_colors_d2`` / ``detect_conflicts_d2`` are their
distance-2 forms: they also take the strict two-hop tile (the gather of
``nbr2`` rows) and treat its colors like the one-hop ones.  ``backend``:

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

BACKENDS = ("auto", "torch", "cuda")

# shared memory a block may use on Hopper (227 KB); the select kernel keeps
# W bitset words + X Random-X candidates per warp, 8 warps per block
_MAX_SMEM = 227 * 1024
_SELECT_WARPS = 8

_P = ctypes.c_void_p


class Kernel:
    """One hand-written CUDA kernel: its C entry point and launch count.

    ``launches`` is incremented once per successful launch, and nowhere
    else, so a run can show which kernels it went through.
    """

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
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
KERNELS = (COLOR_SELECT, CONFLICT, COLOR_SELECT_D2, CONFLICT_D2)


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


def _select_cuda(tiles, act, rand, off, max_colors, x, staggered):
    _check_cuda(*tiles, act, rand, off)
    n_words = max_colors // 32
    smem = _SELECT_WARPS * (n_words + x) * 4
    if smem > _MAX_SMEM:
        raise ValueError(
            f"max_colors={max_colors} with x={x} needs {smem} bytes of shared "
            f"memory per block; the CUDA select kernel takes at most "
            f"{_MAX_SMEM} (max_colors/32 + x <= "
            f"{_MAX_SMEM // (4 * _SELECT_WARPS)})")
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
