// The sequential superstep coloring at distance 2, hand-written for Hopper
// (sm_90a): as greedy_run.cu, with the strict two-hop ELL row of every
// vertex ORed into its bitset beside the one-hop row.
//
// Replaces no Pallas kernel: the reference runs this loop as
// src/repro/core/speculative.py:_greedy_chunk with its two-hop row
// _forbid_ell_row (ColorConfig(distance=2, parallel_chunk=False), and
// every Least-Used run at distance 2).  Semantics and design:
// greedy_run.cuh.
//
// What bounds it on an H100: per colored vertex its MAXD + MAXD2 ids (one
// round of loads up to 256 ids) and their colors, one write; the vertex
// to vertex dependence (one dependent chain and a warp reduction per
// vertex, one warp per shard) is the real floor.  Design: greedy_run.cu.
#include <cuda_runtime.h>

#include "greedy_run.cuh"

namespace {

using namespace repro_select;

template <bool kLeastUsed>
__global__ void __launch_bounds__(32)
    greedy_run_d2_kernel(const GreedyArgs a) {
  greedy_run_body<true, kLeastUsed>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_greedy_run_d2(
    void* view, void* usage, const void* rows, const void* nbr,
    const void* nbr2, const void* rand_bits, const void* offset,
    int n_shards, long long n_slots, int rows_len, int n_local_max, int maxd,
    int maxd2, int pos0, int pos1, int n_words, int x, int staggered,
    int least_used, int device, void* stream) {
  auto kernel =
      least_used ? &greedy_run_d2_kernel<true> : &greedy_run_d2_kernel<false>;
  return launch_greedy(kernel, view, usage, rows, nbr, nbr2, rand_bits,
                       offset, n_shards, n_slots, rows_len, n_local_max, maxd,
                       maxd2, pos0, pos1, n_words, x, staggered, device,
                       stream);
}
