// Distance-2 speculative-coloring conflict detection for one tile of
// vertices, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// conflict_pallas_d2 / _conflict_kernel_d2 (_lose_against over both
// tiles).
//
// Contract (kernels/ops.py, kernels/ref.py): row v loses (out = 1) iff
// active[v] != 0, my_color[v] > 0 and some one-hop neighbour k (MAXD
// tile) or strict two-hop neighbour k (MAXD2 tile) has the same color and
// a strictly higher priority.  Priorities are int32 (padded entries carry
// -1, which never wins).
//
// What bounds it on an H100: it reads the four tiles (one-hop and two-hop
// colors and priorities) once and writes one int32 per row, one compare
// per element, so it is bound by device-memory bytes (3.35 TB/s).  Design:
// conflict.cu's, one warp per row; the lanes stride over each tile with
// coalesced 128-byte reads and combine lose(nbr) | lose(nbr2) with one
// __any_sync.  Rows that cannot lose (inactive or uncolored) read no tile
// bytes at all.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool lose_against(const int* colors,
                                             const int* prio, int len,
                                             int myc, int myp, int lane) {
  bool lose = false;
  for (int k = lane; k < len; k += 32) {
    lose |= (colors[k] == myc) && (prio[k] > myp);
  }
  return lose;
}

__global__ void conflict_d2_kernel(const int* __restrict__ my_color,
                                   const int* __restrict__ my_prio,
                                   const int* __restrict__ nbr_colors,
                                   const int* __restrict__ nbr_prio,
                                   const int* __restrict__ nbr2_colors,
                                   const int* __restrict__ nbr2_prio,
                                   const int* __restrict__ active,
                                   int* __restrict__ out, long long n_rows,
                                   int maxd, int maxd2) {
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
  const long long b1 = row * (long long)maxd;
  const long long b2 = row * (long long)maxd2;
  const bool lose =
      lose_against(nbr_colors + b1, nbr_prio + b1, maxd, myc, myp, lane) |
      lose_against(nbr2_colors + b2, nbr2_prio + b2, maxd2, myc, myp, lane);
  const bool any = __any_sync(kFullMask, lose);
  if (lane == 0) out[row] = any ? 1 : 0;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_conflict_d2(const void* my_color, const void* my_prio,
                                 const void* nbr_colors, const void* nbr_prio,
                                 const void* nbr2_colors,
                                 const void* nbr2_prio, const void* active,
                                 void* out, long long n_rows, int maxd,
                                 int maxd2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  conflict_d2_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(my_color), static_cast<const int*>(my_prio),
      static_cast<const int*>(nbr_colors), static_cast<const int*>(nbr_prio),
      static_cast<const int*>(nbr2_colors),
      static_cast<const int*>(nbr2_prio), static_cast<const int*>(active),
      static_cast<int*>(out), n_rows, maxd, maxd2);
  return static_cast<int>(cudaGetLastError());
}
