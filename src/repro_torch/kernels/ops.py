"""Entry points of the two color kernels, with a backend switch.

``select_colors`` (bitset color selection) and ``detect_conflicts`` (the
speculative repair's loser test) take a padded neighbour tile — the gather
of an ELL row block — and are the only way the coloring code reaches a
kernel.  ``backend``:

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
int32; Random-X draws are passed as the int32 bit pattern of uint32 words.
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
CONFLICT = Kernel(
    "conflict", "repro_conflict",
    [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     _P])
KERNELS = (COLOR_SELECT, CONFLICT)


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
    if selection not in SELECTIONS:
        raise ValueError(
            f"unknown selection {selection!r}, want one of {SELECTIONS}")
    if max_colors % 32 or max_colors <= 0:
        raise ValueError(f"max_colors={max_colors} must be a positive "
                         "multiple of 32")
    backend = resolve_backend(backend, nbr_colors)
    *lead, v, _ = nbr_colors.shape
    lead = tuple(lead)
    dev = nbr_colors.device
    tile = _tile(nbr_colors)
    act = _rows(active, lead, v, dev)
    rand = _rows(0 if rand_u32 is None else rand_u32, lead, v, dev)
    off = _rows(0 if offset is None else offset, lead, v, dev)
    staggered = selection == STAGGERED
    x_eff = x if selection == RANDOM_X else 0
    if x_eff < 0:
        raise ValueError(f"random_x needs x >= 0, got {x}")
    if backend == "torch":
        out = ref.select_colors(tile, act, rand, off, max_colors=max_colors,
                                x=x_eff, staggered=staggered)
    else:
        out = _select_cuda(tile, act, rand, off, max_colors, x_eff, staggered)
    return out.reshape(lead + (v,))


def _select_cuda(tile, act, rand, off, max_colors, x, staggered):
    _check_cuda(tile, act, rand, off)
    n_words = max_colors // 32
    smem = _SELECT_WARPS * (n_words + x) * 4
    if smem > _MAX_SMEM:
        raise ValueError(
            f"max_colors={max_colors} with x={x} needs {smem} bytes of shared "
            f"memory per block; the CUDA select kernel takes at most "
            f"{_MAX_SMEM} (max_colors/32 + x <= "
            f"{_MAX_SMEM // (4 * _SELECT_WARPS)})")
    rows, maxd = tile.shape
    out = torch.empty(rows, dtype=torch.int32, device=tile.device)
    if rows:
        COLOR_SELECT.launch(
            tile.data_ptr(), act.data_ptr(), rand.data_ptr(), off.data_ptr(),
            out.data_ptr(), rows, maxd, n_words, x, int(staggered),
            tile.device.index, _stream(tile))
    return out


def detect_conflicts(my_color, my_prio, nbr_colors: torch.Tensor,
                     nbr_prio: torch.Tensor, active, *,
                     backend: str = "auto") -> torch.Tensor:
    """Tile-parallel conflict detection: a row loses iff it is active and a
    neighbour holds the same nonzero color with a strictly higher priority.
    Operands (…, V) and (…, V, MAXD); returns (…, V) bool.
    """
    backend = resolve_backend(backend, nbr_colors)
    *lead, v, _ = nbr_colors.shape
    lead = tuple(lead)
    dev = nbr_colors.device
    if backend == "torch":
        shape = lead + (v,)
        out = ref.detect_conflicts(
            torch.broadcast_to(torch.as_tensor(my_color, device=dev),
                               shape).reshape(-1),
            torch.broadcast_to(torch.as_tensor(my_prio, device=dev),
                               shape).reshape(-1),
            nbr_colors.reshape(-1, nbr_colors.shape[-1]),
            nbr_prio.reshape(-1, nbr_prio.shape[-1]),
            torch.broadcast_to(torch.as_tensor(active, device=dev),
                               shape).reshape(-1))
        return out.reshape(shape)
    if torch.as_tensor(my_prio).dtype != torch.int32 or (
            nbr_prio.dtype != torch.int32):
        raise TypeError("the CUDA conflict kernel takes int32 priorities "
                        "(int64 ids, past 2**31 vertices, are not supported)")
    myc = _rows(my_color, lead, v, dev)
    myp = _rows(my_prio, lead, v, dev)
    act = _rows(active, lead, v, dev)
    tc, tp = _tile(nbr_colors), _tile(nbr_prio)
    if tc.shape != tp.shape:
        raise ValueError(f"color tile {tuple(tc.shape)} and priority tile "
                         f"{tuple(tp.shape)} differ")
    _check_cuda(tc, tp, myc, myp, act)
    rows, maxd = tc.shape
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        CONFLICT.launch(myc.data_ptr(), myp.data_ptr(), tc.data_ptr(),
                        tp.data_ptr(), act.data_ptr(), out.data_ptr(), rows,
                        maxd, dev.index, _stream(tc))
    return out.reshape(lead + (v,)).bool()
