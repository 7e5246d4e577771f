// Bitset color selection for one tile of vertices (First Fit, Staggered
// First Fit, Random-X Fit), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/firstfit.py:
// color_select_pallas / _select_kernel (with _forbidden_words,
// _find_first_zero, _set_bits, _mask_below_rows and select_from_words).
//
// Contract (kernels/ops.py, kernels/ref.py): row v ORs the colors of its
// MAXD neighbours into a W-word bitset (bit 0 always set; colors <= 0 or
// >= 32W ignored); bit 32W-1 is reserved, so 32W-1 means "no color free".
// First Fit takes the lowest zero bit; Staggered the lowest zero bit at or
// above offset[v], falling back to First Fit; Random-X runs X rounds of
// find-first-zero + set-bit into cands[], then picks
// cands[rand % max(1, #cands below 32W-1)] in uint32.  Inactive rows get 0.
//
// What bounds it on an H100: it reads the (rows, MAXD) int32 neighbour-color
// tile once and writes one int32 per row, a few operations per byte read,
// so it is bound by device-memory bytes (3.35 TB/s).  Design: one warp per
// row; the 32 lanes read the row's MAXD colors coalesced (128 contiguous
// bytes per step) and OR bits into the warp's W-word bitset in shared
// memory; find-first-zero is one __ballot_sync/__ffs per 32 words.  No
// TILE_V padding: the kernel masks the ragged edge itself.  The gather
// that builds the tile (view[nbr[rows]]) stays outside this kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// Lowest zero bit of the bitset below the reserved top bit, with every bit
// below `off` also counted as taken (off <= 0 masks nothing).  Returns
// 32W-1 when no bit is free.  Called by all 32 lanes; warp-uniform result.
__device__ int find_first_zero(const unsigned* words, int n_words, int off,
                               int lane) {
  const int off_word = off >> 5;  // arithmetic shift: negative off -> < 0
  for (int base = 0; base < n_words; base += 32) {
    const int w = base + lane;
    unsigned free_bits = 0u;
    if (w < n_words) {
      unsigned taken = words[w];
      if (w == n_words - 1) taken |= 0x80000000u;
      if (w < off_word) {
        taken = kFullMask;
      } else if (w == off_word) {
        taken |= (1u << (off & 31)) - 1u;
      }
      free_bits = ~taken;
    }
    const unsigned has = __ballot_sync(kFullMask, free_bits != 0u);
    if (has) {
      const int src = __ffs(has) - 1;
      const unsigned word = __shfl_sync(kFullMask, free_bits, src);
      return (base + src) * 32 + (__ffs(word) - 1);
    }
  }
  return n_words * 32 - 1;
}

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
  unsigned* words = smem + warp * (n_words + x);
  int* cands = reinterpret_cast<int*>(words + n_words);
  const int mc = n_words * 32;

  for (int w = lane; w < n_words; w += 32) words[w] = (w == 0) ? 1u : 0u;
  __syncwarp();
  const int* r = nbr + row * (long long)maxd;
  for (int k = lane; k < maxd; k += 32) {
    const int c = r[k];
    if (c > 0 && c < mc) atomicOr(&words[c >> 5], 1u << (c & 31));
  }
  __syncwarp();

  int color;
  if (staggered) {
    color = find_first_zero(words, n_words, offset[row], lane);
    if (color >= mc - 1) color = find_first_zero(words, n_words, 0, lane);
  } else if (x == 0) {
    color = find_first_zero(words, n_words, 0, lane);
  } else {
    for (int k = 0; k < x; ++k) {
      const int c = find_first_zero(words, n_words, 0, lane);
      if (lane == 0) {
        cands[k] = c;
        words[c >> 5] |= 1u << (c & 31);
      }
      __syncwarp();
    }
    unsigned n_free = 0u;
    for (int k = 0; k < x; ++k) n_free += (cands[k] < mc - 1) ? 1u : 0u;
    if (n_free == 0u) n_free = 1u;
    color = cands[static_cast<unsigned>(rand_bits[row]) % n_free];
  }
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
      static_cast<size_t>(kWarpsPerBlock) * (n_words + x) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(color_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  color_select_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                        smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const int*>(active),
      static_cast<const int*>(rand_bits), static_cast<const int*>(offset),
      static_cast<int*>(out), n_rows, maxd, n_words, x, staggered);
  return static_cast<int>(cudaGetLastError());
}
