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
// round of loads up to 256 ids) and their colors, one write: the bytes
// bound; the vertex-to-vertex dependence is one in-order step per vertex
// per shard.  Design: greedy_run.cu — the producer warps read both rows
// ahead and gather their ghost colors; the turn warps OR the local ids'
// colors (of both rows, mostly local on a stencil: a slot lists 128)
// from shared memory while the vertices before take their turns.
#include <cuda_runtime.h>

#include "greedy_run.cuh"

namespace {

using namespace repro_select;

template <bool kLeastUsed, bool kLocalSmem>
__global__ void __launch_bounds__(kGreedyThreads, 1)
    greedy_run_d2_kernel(const GreedyArgs a) {
  greedy_run_body<true, kLeastUsed, kLocalSmem>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_greedy_run_d2(
    void* view, void* usage, const void* rows, const void* nbr,
    const void* nbr2, const void* rand_bits, const void* offset,
    int n_shards, long long n_slots, int rows_len, int n_local_max, int maxd,
    int maxd2, int pos0, int pos1, int n_words, int x, int staggered,
    int least_used, int ring, int list_cap, int local_smem, int device,
    void* stream) {
  auto kernel =
      least_used ? (local_smem ? &greedy_run_d2_kernel<true, true>
                               : &greedy_run_d2_kernel<true, false>)
                 : (local_smem ? &greedy_run_d2_kernel<false, true>
                               : &greedy_run_d2_kernel<false, false>);
  return launch_greedy(kernel, view, usage, rows, nbr, nbr2, rand_bits,
                       offset, n_shards, n_slots, rows_len, n_local_max, maxd,
                       maxd2, pos0, pos1, n_words, x, staggered, ring,
                       list_cap, local_smem != 0, device, stream);
}
