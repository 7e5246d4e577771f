// Device code of the sequential kernels (greedy_run.cu, greedy_run_d2.cu):
// one launch colors, for every shard at once, a run of sequential
// supersteps up to the next boundary exchange, one vertex at a time.
//
// Semantics (kernels/ref.py:greedy_run, the reference's _greedy_chunk):
// positions pos0 … pos1 - 1 of the visit order `rows` (order_pad) of
// shard p, strictly in order; position i colors its vertex v iff its entry
// is >= 0 and view[p, v] is 0, reading view[p] as position i - 1 left it.
// The colors of v's ELL row nbr[p, v] (and, at distance 2, its two-hop row
// nbr2[p, v]) form its forbidden bitset; First Fit, Staggered (from the
// shard's offset) or Random-X (the draw rand[p, v]) pick from it through
// select_common.cuh, or Least-Used through least_used_pick below; the
// color, capped at max_colors - 1, is written to view[p, v] and counted in
// usage[p, color].
//
// Design: one block of one warp per shard (a shard's local rows change
// only through its own writes, and its ghosts only at an exchange between
// launches).  The warp walks the positions: each lane loads one order
// entry of the next 32 and the warp takes them one by one with a shuffle;
// per vertex the lanes stride over the ELL ids up to the first sentinel
// (or_neighbours of select_run.cuh), OR the colors into the bitset in
// shared memory and pick.  Lane 0 writes the color, then __syncwarp()
// orders that write before the next vertex's reads of the view.  The
// shard's usage row (max_colors int32) lives in shared memory for the
// whole launch and goes back to device memory at its end.  The view is
// read through a plain pointer (never __ldg), as in select_run.cuh.
#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "select_run.cuh"

namespace repro_select {

struct GreedyArgs {
  int* view;              // (P, n_slots), updated in place
  int* usage;             // (P, max_colors), updated in place
  const int* rows;        // (P, rows_len) order_pad
  const int* nbr;         // (P, n_local_max, maxd)
  const int* nbr2;        // (P, n_local_max, maxd2), distance 2 only
  const int* rand_bits;   // (P, n_local_max) uint32 draws, Random-X only
  const int* offset;      // (P,) Staggered start colors, or null
  long long n_slots;
  int rows_len, n_local_max, maxd, maxd2;
  int pos0, pos1;         // positions [pos0, pos1) of the visit order
  int n_words, x, staggered;
};

// Least-Used: the free color with the smallest positive usage, ties to the
// smaller color, never the reserved top color; First Fit when no open
// color is free.  Lane l looks at colors l, 32 + l, … (bit l of each word,
// a conflict-free column of the usage row); an argmin over the lanes by
// (usage, color) decides.  All lanes; warp-uniform result.
__device__ __forceinline__ int least_used_pick(const unsigned* words,
                                               const int* usage,
                                               int n_words, int lane) {
  const int mc = n_words * 32;
  int best_u = INT_MAX, best_c = mc;
  for (int w = 0; w < n_words; ++w) {
    const int c = w * 32 + lane;
    const int u = usage[c];
    const bool free_bit = ((words[w] >> lane) & 1u) == 0u;
    if (free_bit && u > 0 && c != mc - 1 && u < best_u) {
      best_u = u;
      best_c = c;  // colors rise with w: strict < keeps the smaller
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const int ou = __shfl_xor_sync(kFullMask, best_u, d);
    const int oc = __shfl_xor_sync(kFullMask, best_c, d);
    if (ou < best_u || (ou == best_u && oc < best_c)) {
      best_u = ou;
      best_c = oc;
    }
  }
  return best_c < mc ? best_c : find_first_zero(words, n_words, 0, lane);
}

template <bool kD2, bool kLeastUsed>
__device__ __forceinline__ void greedy_run_body(const GreedyArgs& a) {
  extern __shared__ unsigned smem[];
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const int mc = a.n_words * 32;
  const int sentinel = static_cast<int>(a.n_slots) - 1;
  unsigned* words = smem;
  int* usage = reinterpret_cast<int*>(smem + a.n_words);
  int* view = a.view + p * a.n_slots;
  int* usage_g = a.usage + static_cast<long long>(p) * mc;
  const int* rows = a.rows + static_cast<long long>(p) * a.rows_len;
  for (int c = lane; c < mc; c += 32) usage[c] = usage_g[c];
  const int off = a.staggered ? __ldg(a.offset + p) : 0;
  __syncwarp();
  for (int base = a.pos0; base < a.pos1; base += 32) {
    const int mine = base + lane < a.pos1 ? __ldg(rows + base + lane) : -1;
    const int n = min(32, a.pos1 - base);
    for (int j = 0; j < n; ++j) {
      const int v = __shfl_sync(kFullMask, mine, j);
      if (v < 0 || view[v] != 0) continue;  // warp-uniform
      const long long r = static_cast<long long>(p) * a.n_local_max + v;
      const unsigned rand =
          a.x ? static_cast<unsigned>(__ldg(a.rand_bits + r)) : 0u;
      clear_bitset(words, a.n_words, lane);
      __syncwarp();
      or_neighbours(words, view, a.nbr + r * a.maxd, a.maxd,
                    kD2 ? a.nbr2 + r * a.maxd2 : nullptr, kD2 ? a.maxd2 : 0,
                    sentinel, mc, lane);
      __syncwarp();
      int color;
      if (kLeastUsed) {
        color = least_used_pick(words, usage, a.n_words, lane);
      } else {
        color = select_from_bitset(words, a.n_words, a.x, a.staggered, off,
                                   rand, lane);
      }
      color = min(color, mc - 1);
      __syncwarp();  // every lane is done with the bitset and the usage
      if (lane == 0) {
        view[v] = color;
        usage[color] += 1;
      }
      __syncwarp();  // the write is in before the next vertex reads
    }
  }
  for (int c = lane; c < mc; c += 32) usage_g[c] = usage[c];
}

// Builds the arguments and launches `kernel` with one warp per shard.
template <typename Kernel>
int launch_greedy(Kernel kernel, void* view, void* usage, const void* rows,
                  const void* nbr, const void* nbr2, const void* rand_bits,
                  const void* offset, int n_shards, long long n_slots,
                  int rows_len, int n_local_max, int maxd, int maxd2,
                  int pos0, int pos1, int n_words, int x, int staggered,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_words) * 33 * sizeof(unsigned);
  err = set_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  GreedyArgs a;
  a.view = static_cast<int*>(view);
  a.usage = static_cast<int*>(usage);
  a.rows = static_cast<const int*>(rows);
  a.nbr = static_cast<const int*>(nbr);
  a.nbr2 = static_cast<const int*>(nbr2);
  a.rand_bits = static_cast<const int*>(rand_bits);
  a.offset = static_cast<const int*>(offset);
  a.n_slots = n_slots;
  a.rows_len = rows_len;
  a.n_local_max = n_local_max;
  a.maxd = maxd;
  a.maxd2 = maxd2;
  a.pos0 = pos0;
  a.pos1 = pos1;
  a.n_words = n_words;
  a.x = x;
  a.staggered = staggered;
  kernel<<<n_shards, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_select
