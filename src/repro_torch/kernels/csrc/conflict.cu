// Speculative-coloring conflict detection for one tile of vertices,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// conflict_pallas / _conflict_kernel (with _lose_against).
//
// Contract (kernels/ops.py, kernels/ref.py): row v loses (out = 1) iff
// active[v] != 0, my_color[v] > 0 and some neighbour k has
// nbr_colors[v, k] == my_color[v] and nbr_prio[v, k] > my_prio[v].
// Priorities are int32 (padded entries carry -1, which never wins).
//
// What bounds it on an H100: it reads the two (rows, MAXD) int32 tiles
// (neighbour colors and priorities) once and writes one int32 per row, one
// compare per element, so it is bound by device-memory bytes (3.35 TB/s).
// Design: one warp per row; the lanes stride over MAXD with coalesced
// 128-byte reads of both tiles and combine their verdicts with one
// __any_sync.  Rows that cannot lose (inactive or uncolored) read no tile
// bytes at all.  No TILE_V padding: the ragged edge is masked here.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void conflict_kernel(const int* __restrict__ my_color,
                                const int* __restrict__ my_prio,
                                const int* __restrict__ nbr_colors,
                                const int* __restrict__ nbr_prio,
                                const int* __restrict__ active,
                                int* __restrict__ out, long long n_rows,
                                int maxd) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n_rows) return;  // warp-uniform
  const int myc = my_color[row];
  if (active[row] == 0 || myc <= 0) {  // warp-uniform
    if (lane == 0) out[row] = 0;
    return;
  }
  const int myp = my_prio[row];
  const long long base = row * (long long)maxd;
  bool lose = false;
  for (int k = lane; k < maxd; k += 32) {
    lose |= (nbr_colors[base + k] == myc) && (nbr_prio[base + k] > myp);
  }
  const bool any = __any_sync(kFullMask, lose);
  if (lane == 0) out[row] = any ? 1 : 0;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_conflict(const void* my_color, const void* my_prio,
                              const void* nbr_colors, const void* nbr_prio,
                              const void* active, void* out, long long n_rows,
                              int maxd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  conflict_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(my_color), static_cast<const int*>(my_prio),
      static_cast<const int*>(nbr_colors), static_cast<const int*>(nbr_prio),
      static_cast<const int*>(active), static_cast<int*>(out), n_rows, maxd);
  return static_cast<int>(cudaGetLastError());
}
