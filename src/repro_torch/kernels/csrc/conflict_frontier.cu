// The frontier form of the speculative-coloring conflict detection,
// hand-written for Hopper (sm_90a): one launch runs a round's whole
// repair, on every shard, reading the visit order, the ELL ids, the view
// and the priorities itself, and writes the uncolorings and the two
// counts.
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// conflict_pallas / _conflict_kernel together with the chunk loop around
// it in the reference (repro/core/speculative.py:
// _detect_conflicts_frontier), which gathers each chunk's neighbour colors
// and priorities and scatters its losers between launches.  Semantics and
// design: conflict_frontier.cuh.
//
// What bounds it on an H100: per live (active, colored) row it reads its
// order entry, color, priority and is_internal flag, its int32 ids up to
// the first sentinel (about its degree, far below the ELL width MAXD on a
// heavy-tailed graph), 4 B of color per id and 4 B of priority per id of
// the same color, and writes 4 B per loser: one compare per byte or so,
// so device-memory bytes (3.35 TB/s) bound it.  Design: the tiles of
// colors and priorities that the chunk loop gathered into device memory
// (MAXD wide, mostly padding) are never made, and the chunks' launches,
// gathers, scatters and reductions are one launch.
#include <cuda_runtime.h>

#include "conflict_frontier.cuh"

namespace {

using namespace repro_conflict;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    conflict_frontier_kernel(const FrontierArgs a) {
  frontier_body<false>(a);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).  `counts` is
// (n_shards / lane_shards, 2): per lane, losers and boundary loser.
// `nbr2`/`maxd2` are ignored (distance 1).
extern "C" int repro_conflict_frontier(
    const void* view, const void* prio, const void* is_internal,
    const void* rows, const void* nbr, const void* nbr2, const void* n_need,
    void* new_view, void* counts, int n_shards, long long n_slots,
    int rows_len, int n_pos, int n_local_max, int maxd, int maxd2,
    int lane_shards, int device, void* stream) {
  return launch_frontier(conflict_frontier_kernel, view, prio, is_internal,
                         rows, nbr, nbr2, n_need, new_view, counts, n_shards,
                         n_slots, rows_len, n_pos, n_local_max, maxd, maxd2,
                         lane_shards, device, stream);
}
