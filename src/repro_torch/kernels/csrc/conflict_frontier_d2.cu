// The frontier form of the distance-2 conflict detection, hand-written
// for Hopper (sm_90a): one launch runs a round's whole repair, on every
// shard, over the one-hop (nbr) and the strict two-hop (nbr2) ELL rows,
// reading the view and the priorities itself.
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// conflict_pallas_d2 / _conflict_kernel_d2 together with the chunk loop
// around it in the reference (repro/core/speculative.py:
// _detect_conflicts_frontier, distance=2).  Semantics and design:
// conflict_frontier.cuh; a live row's one-hop and two-hop ids (26 + 98 on
// the 27-point stencil) are read as one sequence in one round of loads.
//
// What bounds it on an H100: as conflict_frontier.cu, over both rows of
// each live row: device-memory bytes (3.35 TB/s).
#include <cuda_runtime.h>

#include "conflict_frontier.cuh"

namespace {

using namespace repro_conflict;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    conflict_frontier_d2_kernel(const FrontierArgs a) {
  frontier_body<true>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).  `counts` is
// (n_shards / lane_shards, 2): per lane, losers and boundary loser.
extern "C" int repro_conflict_frontier_d2(
    const void* view, const void* prio, const void* is_internal,
    const void* rows, const void* nbr, const void* nbr2, const void* n_need,
    void* new_view, void* counts, int n_shards, long long n_slots,
    int rows_len, int n_pos, int n_local_max, int maxd, int maxd2,
    int lane_shards, int device, void* stream) {
  return launch_frontier(conflict_frontier_d2_kernel, view, prio,
                         is_internal, rows, nbr, nbr2, n_need, new_view,
                         counts, n_shards, n_slots, rows_len, n_pos,
                         n_local_max, maxd, maxd2, lane_shards, device,
                         stream);
}
