// The run form of the bitset color selection (First Fit, Staggered First
// Fit, Random-X Fit), hand-written for Hopper (sm_90a): one launch colors
// a whole run of speculative tiles or recolor chunks, on every shard, in
// their sequential order, gathering the neighbour colors from the view
// itself.
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// color_select_pallas / _select_kernel together with the tile loops around
// it in the reference (repro/core/speculative.py:_parallel_chunk,
// repro/core/recolor.py chunk_body), which gather each tile's neighbour
// colors and scatter its colors back between launches.  Semantics and
// design: select_run.cuh; the select tail: select_common.cuh.
//
// What bounds it on an H100: per active row it reads its int32 neighbour
// ids (a row wider than one round of loads, 256 ids, only up to its first
// sentinel: about its degree, far below the ELL width MAXD on a
// heavy-tailed graph), gathers their colors and writes one color, a few
// operations per byte, so device-memory bytes (3.35 TB/s) bound the work
// of one launch;
// the tile-to-tile dependence (every tile waits for the previous tile's
// writes) is the real floor of a run of small tiles.  Design: the tile
// is never written to device memory (the gathered colors go straight into
// the warp's bitset), the launch per tile and its host-side gathers,
// index arithmetic and scatters are gone, and the shards run in parallel,
// one block each.
#include <cuda_runtime.h>

#include "select_run.cuh"

namespace {

using namespace repro_select;

__global__ void __launch_bounds__(kRunMaxWarps * 32)
    select_run_kernel(const RunArgs a) {
  select_run_body<false>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).  `lane_shards` is
// the shards per lane of `class_chunks` (recolor mode).  `nbr2`/`maxd2`
// are ignored (distance 1).
extern "C" int repro_select_run(
    void* view, const void* rows, const void* nbr, const void* nbr2,
    const void* rand_bits, const void* offset, const void* start,
    const void* sizes, const void* class_chunks, void* scratch, int n_shards,
    long long n_slots, int rows_len, int n_local_max, int maxd, int maxd2,
    int n_cls, int lane_shards, int first, int last, int superstep,
    int tile, int recolor, int n_words, int x, int staggered, int device,
    void* stream) {
  return launch_run(select_run_kernel, view, rows, nbr, nbr2, rand_bits,
                    offset, start, sizes, class_chunks, scratch, n_shards,
                    n_slots, rows_len, n_local_max, maxd, maxd2, n_cls,
                    lane_shards, first, last, superstep, tile, recolor,
                    n_words, x, staggered, device, stream);
}
