// Bitset color selection for one tile of vertices (First Fit, Staggered
// First Fit, Random-X Fit), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// color_select_pallas / _select_kernel (with _forbidden_words,
// _find_first_zero, _set_bits, _mask_below_rows and select_from_words).
//
// Contract: select_common.cuh; row v's bitset holds the colors of its MAXD
// neighbours.  Inactive rows get 0.
//
// What bounds it on an H100: it reads the (rows, MAXD) int32 neighbour-color
// tile once and writes one int32 per row, a few operations per byte read,
// so it is bound by device-memory bytes (3.35 TB/s).  Design: one warp per
// row; the 32 lanes read the row's MAXD colors coalesced (128 contiguous
// bytes per step) and OR bits into the warp's W-word bitset in shared
// memory; find-first-zero is one __ballot_sync/__ffs per 32 words.  No
// TILE_V padding: the kernel masks the ragged edge itself.  This tile
// form takes a tile gathered beforehand (view[nbr[rows]]); it serves
// ops.select_colors.  The coloring loops go through its fused run form,
// select_run.cu, which gathers from the view itself and colors a whole
// run of tiles in order in one launch.
#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

using namespace repro_select;

__global__ void color_select_kernel(const int* __restrict__ nbr,
                                    const int* __restrict__ active,
                                    const int* __restrict__ rand_bits,
                                    const int* __restrict__ offset,
                                    int* __restrict__ out, long long n_rows,
                                    int maxd, int n_words, int x,
                                    int staggered) {
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
  __syncwarp();

  const int color = select_from_bitset(
      words, n_words, x, staggered, staggered ? offset[row] : 0,
      x ? static_cast<unsigned>(rand_bits[row]) : 0u, lane);
  if (lane == 0) out[row] = color;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_color_select(const void* nbr, const void* active,
                                  const void* rand_bits, const void* offset,
                                  void* out, long long n_rows, int maxd,
                                  int n_words, int x, int staggered,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * n_words * sizeof(unsigned);
  err = set_dynamic_smem(color_select_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  color_select_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                        smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const int*>(active),
      static_cast<const int*>(rand_bits), static_cast<const int*>(offset),
      static_cast<int*>(out), n_rows, maxd, n_words, x, staggered);
  return static_cast<int>(cudaGetLastError());
}
