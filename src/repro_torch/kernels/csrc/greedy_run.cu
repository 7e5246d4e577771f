// The sequential superstep coloring (First Fit, Staggered First Fit,
// Random-X Fit, Least-Used), hand-written for Hopper (sm_90a): one launch
// colors a run of supersteps up to the next boundary exchange, on every
// shard, one vertex at a time, each seeing every color written before it.
//
// Replaces no Pallas kernel: the reference runs this loop as
// src/repro/core/speculative.py:_greedy_chunk, a nested lax.fori_loop
// that XLA compiles into one device loop (ColorConfig(parallel_chunk=
// False), and every Least-Used run).  Semantics and design:
// greedy_run.cuh; the First Fit / Staggered / Random-X tail:
// select_common.cuh.
//
// What bounds it on an H100: per colored vertex it reads its order entry,
// its own color, its ELL ids up to the first sentinel, their colors, and
// writes one color, so device-memory bytes bound the work (a few µs per
// 512-vertex launch); but every vertex waits for the previous one's
// write, so the floor is one in-order step per vertex per shard.  Design
// (greedy_run.cuh): what cannot change within the launch (order entries,
// ids, ghost colors, draws) is read ahead by 12 producer warps into a
// ring of slots in shared memory; 4 turn warps prepare the next vertices
// from it (the local neighbours' colors, which live in shared memory as
// 16-bit values when they fit, and the pick's candidates), so the
// in-order step left is a turn: the one write since the preparation
// checked, the pick taken from the candidates, the color written and the
// turn passed on, all in shared memory.  When the local colors do not
// fit, the second instantiation reads them from device memory.
#include <cuda_runtime.h>

#include "greedy_run.cuh"

namespace {

using namespace repro_select;

template <bool kLeastUsed, bool kLocalSmem>
__global__ void __launch_bounds__(kGreedyThreads, 1)
    greedy_run_kernel(const GreedyArgs a) {
  greedy_run_body<false, kLeastUsed, kLocalSmem>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).  `nbr2`/`maxd2`
// are ignored (distance 1).  `ring`, `list_cap` and `local_smem` come from
// the wrapper's layout (ops.py:_greedy_layout).
extern "C" int repro_greedy_run(
    void* view, void* usage, const void* rows, const void* nbr,
    const void* nbr2, const void* rand_bits, const void* offset,
    int n_shards, long long n_slots, int rows_len, int n_local_max, int maxd,
    int maxd2, int pos0, int pos1, int n_words, int x, int staggered,
    int least_used, int ring, int list_cap, int local_smem, int device,
    void* stream) {
  auto kernel = least_used ? (local_smem ? &greedy_run_kernel<true, true>
                                         : &greedy_run_kernel<true, false>)
                           : (local_smem ? &greedy_run_kernel<false, true>
                                         : &greedy_run_kernel<false, false>);
  return launch_greedy(kernel, view, usage, rows, nbr, nbr2, rand_bits,
                       offset, n_shards, n_slots, rows_len, n_local_max, maxd,
                       maxd2, pos0, pos1, n_words, x, staggered, ring,
                       list_cap, local_smem != 0, device, stream);
}
