// The run form of the distance-2 bitset color selection, hand-written for
// Hopper (sm_90a): one launch colors a whole run of speculative tiles or
// recolor chunks, on every shard, in their sequential order, gathering the
// one-hop and the strict two-hop neighbour colors from the view itself.
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// color_select_pallas_d2 / _select_kernel_d2 together with the tile loops
// around it in the reference (repro/core/speculative.py:_parallel_chunk,
// repro/core/recolor.py chunk_body at distance 2).  Semantics and design:
// select_run.cuh; both ELL rows are ORed into the same bitset before the
// one selection tail (select_common.cuh).
//
// What bounds it on an H100: per active row it reads its MAXD + MAXD2
// int32 neighbour ids (in one round of loads up to 256 ids, wider rows
// only up to each ELL row's first sentinel), gathers their colors and
// writes one color, so
// device-memory bytes bound the work of one launch; at the distance-2
// tile of 16 rows per shard that work is tiny, and the real floor is the
// tile-to-tile dependence: one tile's gathers, selection and write-back in
// a row, about two memory round trips and two block barriers.  Design: as
// select_run.cu; one launch per run of supersteps replaces one launch and
// about 25 host-side device ops per tile.
#include <cuda_runtime.h>

#include "select_run.cuh"

namespace {

using namespace repro_select;

__global__ void __launch_bounds__(kRunMaxWarps * 32)
    select_run_d2_kernel(const RunArgs a) {
  select_run_body<true>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).  `lane_shards` is
// the shards per lane of `class_chunks` (recolor mode).
extern "C" int repro_select_run_d2(
    void* view, const void* rows, const void* nbr, const void* nbr2,
    const void* rand_bits, const void* offset, const void* start,
    const void* sizes, const void* class_chunks, void* scratch, int n_shards,
    long long n_slots, int rows_len, int n_local_max, int maxd, int maxd2,
    int n_cls, int lane_shards, int first, int last, int superstep,
    int tile, int recolor, int n_words, int x, int staggered, int device,
    void* stream) {
  return launch_run(select_run_d2_kernel, view, rows, nbr, nbr2, rand_bits,
                    offset, start, sizes, class_chunks, scratch, n_shards,
                    n_slots, rows_len, n_local_max, maxd, maxd2, n_cls,
                    lane_shards, first, last, superstep, tile, recolor,
                    n_words, x, staggered, device, stream);
}
