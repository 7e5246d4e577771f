// Distance-2 bitset color selection for one tile of vertices (First Fit,
// Staggered First Fit, Random-X Fit), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// color_select_pallas_d2 / _select_kernel_d2 (the OR of two
// _forbidden_words bitsets, then select_from_words).
//
// Contract: select_common.cuh; row v's bitset holds the colors of its MAXD
// one-hop neighbours and of its MAXD2 strict two-hop neighbours, so the
// chosen color differs from every color within graph distance 2.
// Inactive rows get 0.
//
// What bounds it on an H100: it reads the (rows, MAXD) and (rows, MAXD2)
// int32 tiles once and writes one int32 per row, a few operations per byte
// read, so it is bound by device-memory bytes (3.35 TB/s).  Design: the
// distance-1 kernel's, one warp per row, with both rows ORed into the same
// shared-memory bitset before the one selection tail; no second bitset
// and no second pass.  This tile form takes tiles gathered beforehand
// (view[nbr[rows]], view[nbr2[rows]]); it serves ops.select_colors_d2.
// The coloring loops go through its fused run form, select_run_d2.cu,
// which gathers from the view itself and colors a whole run of tiles in
// order in one launch.
#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

using namespace repro_select;

__global__ void color_select_d2_kernel(const int* __restrict__ nbr,
                                       const int* __restrict__ nbr2,
                                       const int* __restrict__ active,
                                       const int* __restrict__ rand_bits,
                                       const int* __restrict__ offset,
                                       int* __restrict__ out,
                                       long long n_rows, int maxd, int maxd2,
                                       int n_words, int x, int staggered) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n_rows) return;  // warp-uniform
  if (active[row] == 0) {     // warp-uniform
    if (lane == 0) out[row] = 0;
    return;
  }
  unsigned* words = smem + warp * n_words;

  clear_bitset(words, n_words, lane);
  __syncwarp();
  or_row(words, nbr + row * (long long)maxd, maxd, n_words, lane);
  or_row(words, nbr2 + row * (long long)maxd2, maxd2, n_words, lane);
  __syncwarp();

  const int color = select_from_bitset(
      words, n_words, x, staggered, staggered ? offset[row] : 0,
      x ? static_cast<unsigned>(rand_bits[row]) : 0u, lane);
  if (lane == 0) out[row] = color;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_color_select_d2(const void* nbr, const void* nbr2,
                                     const void* active,
                                     const void* rand_bits,
                                     const void* offset, void* out,
                                     long long n_rows, int maxd, int maxd2,
                                     int n_words, int x, int staggered,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * n_words * sizeof(unsigned);
  err = set_dynamic_smem(color_select_d2_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  color_select_d2_kernel<<<static_cast<unsigned>(blocks),
                           kWarpsPerBlock * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const int*>(nbr2),
      static_cast<const int*>(active), static_cast<const int*>(rand_bits),
      static_cast<const int*>(offset), static_cast<int*>(out), n_rows, maxd,
      maxd2, n_words, x, staggered);
  return static_cast<int>(cudaGetLastError());
}
