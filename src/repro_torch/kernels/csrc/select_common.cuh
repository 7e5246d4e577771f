// Device code shared by the color-select kernels (color_select.cu,
// color_select_d2.cu): one warp per row builds the row's forbidden-color
// bitset in shared memory and picks a color from it.
//
// Contract (kernels/ops.py, kernels/ref.py): a row's W-word bitset holds
// the colors of its neighbours (bit 0 always set; colors <= 0 or >= 32W
// ignored); bit 32W-1 is reserved, so 32W-1 means "no color free".  First
// Fit takes the lowest zero bit; Staggered the lowest zero bit at or above
// the row's offset, falling back to First Fit; Random-X runs X rounds of
// find-first-zero + set-bit into cands[], then picks
// cands[rand % max(1, #cands below 32W-1)] in uint32.
#pragma once

#include <cuda_runtime.h>

namespace repro_select {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// Lowest zero bit of the bitset below the reserved top bit, with every bit
// below `off` also counted as taken (off <= 0 masks nothing).  Returns
// 32W-1 when no bit is free.  Called by all 32 lanes; warp-uniform result.
__device__ __forceinline__ int find_first_zero(const unsigned* words,
                                               int n_words, int off,
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

// Empty bitset (bit 0 set).  All lanes; the caller syncs the warp.
__device__ __forceinline__ void clear_bitset(unsigned* words, int n_words,
                                             int lane) {
  for (int w = lane; w < n_words; w += 32) words[w] = (w == 0) ? 1u : 0u;
}

// OR one tile row's `len` colors into the bitset: the lanes read the row
// coalesced (128 contiguous bytes per step).  The caller syncs the warp.
__device__ __forceinline__ void or_row(unsigned* words, const int* r,
                                       int len, int n_words, int lane) {
  const int mc = n_words * 32;
  for (int k = lane; k < len; k += 32) {
    const int c = r[k];
    if (c > 0 && c < mc) atomicOr(&words[c >> 5], 1u << (c & 31));
  }
}

// The row's color from its built bitset (First Fit, Staggered from `off`,
// or Random-X with `x` candidates and the uint32 draw `rand`).  All lanes;
// warp-uniform result.  Random-X marks its candidates in `words`.
__device__ __forceinline__ int select_from_bitset(unsigned* words,
                                                  int* cands, int n_words,
                                                  int x, int staggered,
                                                  int off, unsigned rand,
                                                  int lane) {
  const int mc = n_words * 32;
  if (staggered) {
    const int color = find_first_zero(words, n_words, off, lane);
    return color >= mc - 1 ? find_first_zero(words, n_words, 0, lane)
                           : color;
  }
  if (x == 0) return find_first_zero(words, n_words, 0, lane);
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
  return cands[rand % n_free];
}

// Dynamic shared memory of one block: W bitset words + X candidates per
// warp.  Raises the kernel's limit past the default 48 KB when needed.
template <typename Kernel>
cudaError_t set_select_smem(Kernel kernel, int n_words, int x,
                            size_t* smem) {
  *smem = static_cast<size_t>(kWarpsPerBlock) * (n_words + x) *
          sizeof(unsigned);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace repro_select
