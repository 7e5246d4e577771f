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
// writes one color, so device-memory bytes bound the work; but every
// vertex waits for the previous one's write, so the real floor is one
// chain of dependent loads (own color, ids, gathered colors) and a warp
// reduction per vertex, one warp per shard.  Design: the order entries
// come 32 at a time, one per lane; the bitset and the usage row stay in
// shared memory; one launch per run of supersteps, no host work per
// vertex.
#include <cuda_runtime.h>

#include "greedy_run.cuh"

namespace {

using namespace repro_select;

template <bool kLeastUsed>
__global__ void __launch_bounds__(32) greedy_run_kernel(const GreedyArgs a) {
  greedy_run_body<false, kLeastUsed>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).  `nbr2`/`maxd2`
// are ignored (distance 1).
extern "C" int repro_greedy_run(
    void* view, void* usage, const void* rows, const void* nbr,
    const void* nbr2, const void* rand_bits, const void* offset,
    int n_shards, long long n_slots, int rows_len, int n_local_max, int maxd,
    int maxd2, int pos0, int pos1, int n_words, int x, int staggered,
    int least_used, int device, void* stream) {
  auto kernel =
      least_used ? &greedy_run_kernel<true> : &greedy_run_kernel<false>;
  return launch_greedy(kernel, view, usage, rows, nbr, nbr2, rand_bits,
                       offset, n_shards, n_slots, rows_len, n_local_max, maxd,
                       maxd2, pos0, pos1, n_words, x, staggered, device,
                       stream);
}
