// Device code shared by the color-select kernels (color_select.cu,
// color_select_d2.cu and their run forms select_run.cu, select_run_d2.cu):
// one warp per row builds the row's forbidden-color bitset in shared
// memory and picks a color from it.
//
// Contract (kernels/ops.py, kernels/ref.py): a row's W-word bitset holds
// the colors of its neighbours (bit 0 always set; colors <= 0 or >= 32W
// ignored); bit 32W-1 is reserved, so 32W-1 means "no color free".  First
// Fit takes the lowest zero bit; Staggered the lowest zero bit at or above
// the row's offset, falling back to First Fit; Random-X takes the
// (rand % n_free)-th smallest free color in uint32, n_free = max(1,
// min(X, #free colors below 32W-1)), and 32W-1 when none is free.
#pragma once

#include <cuda_runtime.h>

namespace repro_select {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// The free bits of word w of the bitset (the reserved top bit counted as
// taken; 0 past the end).
__device__ __forceinline__ unsigned free_word(const unsigned* words,
                                              int n_words, int w) {
  if (w >= n_words) return 0u;
  unsigned taken = words[w];
  if (w == n_words - 1) taken |= 0x80000000u;
  return ~taken;
}

// Lowest zero bit of the bitset below the reserved top bit, with every bit
// below `off` also counted as taken (off <= 0 masks nothing).  Returns
// 32W-1 when no bit is free.  Called by all 32 lanes; warp-uniform result.
__device__ __forceinline__ int find_first_zero(const unsigned* words,
                                               int n_words, int off,
                                               int lane) {
  const int off_word = off >> 5;  // arithmetic shift: negative off -> < 0
  for (int base = 0; base < n_words; base += 32) {
    const int w = base + lane;
    unsigned free_bits = free_word(words, n_words, w);
    if (w < off_word) {
      free_bits = 0u;
    } else if (w == off_word) {
      free_bits &= ~((1u << (off & 31)) - 1u);
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

// Random-X: the (rand % n_free)-th smallest free color.  The warp counts
// the free bits (lane l holds word base+l), then finds the rank-th one by
// a prefix sum over the lanes; everything stays in registers, with no
// candidate list in shared memory and no __syncwarp per candidate.  All
// lanes; warp-uniform result.
__device__ __forceinline__ int random_x_pick(const unsigned* words,
                                             int n_words, int x,
                                             unsigned rand, int lane) {
  unsigned n_free = 0u;
  for (int base = 0; base < n_words && n_free < static_cast<unsigned>(x);
       base += 32) {
    n_free += __reduce_add_sync(
        kFullMask, static_cast<unsigned>(
                       __popc(free_word(words, n_words, base + lane))));
  }
  if (n_free == 0u) return n_words * 32 - 1;
  if (n_free > static_cast<unsigned>(x)) n_free = x;
  unsigned rank = rand % n_free;  // 0-based among the free colors
  for (int base = 0; base < n_words; base += 32) {
    const unsigned bits = free_word(words, n_words, base + lane);
    const unsigned count = __popc(bits);
    unsigned incl = count;  // inclusive prefix sum of the lanes' counts
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += y;
    }
    const unsigned total = __shfl_sync(kFullMask, incl, 31);
    if (rank < total) {
      const int src = __ffs(__ballot_sync(kFullMask, incl > rank)) - 1;
      unsigned word = __shfl_sync(kFullMask, bits, src);
      for (unsigned k = rank - __shfl_sync(kFullMask, incl - count, src);
           k; --k) {
        word &= word - 1u;  // drop the lowest free bit
      }
      return (base + src) * 32 + (__ffs(word) - 1);
    }
    rank -= total;
  }
  return n_words * 32 - 1;  // not reached: rank < n_free <= #free
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
// warp-uniform result.  Reads the bitset only.
__device__ __forceinline__ int select_from_bitset(const unsigned* words,
                                                  int n_words, int x,
                                                  int staggered, int off,
                                                  unsigned rand, int lane) {
  const int mc = n_words * 32;
  if (staggered) {
    const int color = find_first_zero(words, n_words, off, lane);
    return color >= mc - 1 ? find_first_zero(words, n_words, 0, lane)
                           : color;
  }
  if (x == 0) return find_first_zero(words, n_words, 0, lane);
  return random_x_pick(words, n_words, x, rand, lane);
}

// Raises the kernel's dynamic shared-memory limit past the default 48 KB
// when `smem` bytes need it.
template <typename Kernel>
cudaError_t set_dynamic_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace repro_select
