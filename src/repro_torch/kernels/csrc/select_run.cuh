// Device code of the run kernels (select_run.cu, select_run_d2.cu): one
// launch colors, for every shard at once, a whole run of tiles in their
// sequential order, straight from the view.
//
// Semantics (kernels/ref.py:select_run / recolor_run, the loops they
// replace): for each tile in order, on each shard p,
//   - every row of the tile reads view[p] as it stood before the tile:
//     its own color (speculative rows are active only while uncolored) and
//     the colors of its ELL neighbours nbr[p, v] (and nbr2[p, v]);
//   - the row's color comes from the select tail of select_common.cuh,
//     capped at max_colors - 1;
//   - then, and only then, the tile's active rows write their colors into
//     view[p]; the next tile sees those writes.
// Speculative mode walks supersteps [first, last] of the visit order
// `rows` (order_pad), each as ceil(superstep / tile) tiles starting at
// min(si * superstep + ti * tile, rows_len - tile); a row is active iff its
// entry is >= 0 and its color is 0.  Recolor mode walks classes [first,
// last], class t as class_chunks[l, t] chunks of `tile` rows of the
// step-sorted rows (sorted_pad) from min(start[p, t] + j * tile,
// n_local_max), where l = p / lane_shards is the shard's lane (the graph
// of a batch it belongs to: each lane has its own chunk counts); a row is
// active iff j * tile + i < sizes[p, t].
//
// Design: one block per shard and a loop over the run's tiles inside it (a
// shard's local rows change only through its own writes, and its ghosts
// only at an exchange between launches, so the shards need nothing of each
// other).  One warp per row with its bitset in shared memory; rows stride
// over the block's warps.  A block barrier separates a tile's selection
// from its write-back, and the write-back from the next tile.  The tile's
// colors wait in `scratch` (one int per row, written and read back by the
// same lane).  The view is read and written through a plain pointer: not
// const, not __restrict__, never __ldg — the read-only path could hand back
// a color from before the previous tile's writes.  The index arrays (rows,
// nbr, nbr2, rand, offset, the recolor schedule) do not change during the
// launch and are read through __ldg.  The sentinel slot holds color 0 and
// no run writes it, so sentinel entries are not gathered; and an ELL
// row's sentinel padding follows all of its ids, so a row wider than one
// round of loads is read up to its first sentinel and no further: a row of
// a heavy-tailed graph costs about its degree, not the ELL width.
#pragma once

#include <cuda_runtime.h>

#include "select_common.cuh"

namespace repro_select {

constexpr int kRunMaxWarps = 32;

struct RunArgs {
  int* view;                // (P, n_slots), updated in place
  const int* rows;          // (P, rows_len): order_pad or sorted_pad
  const int* nbr;           // (P, n_local_max, maxd)
  const int* nbr2;          // (P, n_local_max, maxd2), distance 2 only
  const int* rand_bits;     // (P, n_local_max) uint32 draws, Random-X only
  const int* offset;        // (P,) Staggered start colors, or null
  const int* start;         // recolor: (P, n_cls) first sorted row of t
  const int* sizes;         // recolor: (P, n_cls) rows of class t
  const int* class_chunks;  // recolor: (P / lane_shards, n_cls) chunks of
                            // class t per lane
  int* scratch;             // (P, tile) colors of the current tile
  long long n_slots;
  int rows_len, n_local_max, maxd, maxd2, n_cls, lane_shards;
  int first, last;          // supersteps or classes, both inclusive
  int superstep, tile, recolor, n_words, x, staggered;
};

constexpr int kGatherBatch = 8;  // id loads in flight per lane

__device__ __forceinline__ void or_color(unsigned* words, int c, int mc) {
  if (c > 0 && c < mc) atomicOr(&words[c >> 5], 1u << (c & 31));
}

// OR the colors of one row's neighbours into the warp's bitset: the `len1`
// ids of `row1` and the `len2` ids of `row2` (distance 2).  When one round
// of kGatherBatch 32-id batches per lane covers both rows (up to 256 ids:
// the 26 + 98 of the 27-point stencil's two ELL rows), they are read as
// one sequence in that round: each lane starts its coalesced id loads,
// then their gathers from the view.  Wider rows (the ELL of a
// heavy-tailed graph) are read only up to their first sentinel, since an
// ELL row holds its ids first and then sentinel padding: a first round of
// one batch of each row, which ends most rows, then rounds of
// kGatherBatch batches shared by the rows still open.  The caller syncs
// the warp.
__device__ __forceinline__ void or_neighbours(unsigned* words,
                                              const int* view,
                                              const int* row1, int len1,
                                              const int* row2, int len2,
                                              int sentinel, int mc,
                                              int lane) {
  if (len1 + len2 <= 32 * kGatherBatch) {
    int u[kGatherBatch];
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) {
      const int k = q * 32 + lane;
      u[q] = k < len1          ? __ldg(row1 + k)
             : k < len1 + len2 ? __ldg(row2 + (k - len1))
                               : sentinel;
    }
    int c[kGatherBatch];
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) {
      c[q] = u[q] != sentinel ? view[u[q]] : 0;
    }
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) or_color(words, c[q], mc);
    return;
  }
  int pos1 = 0, pos2 = 0;
  bool open1 = len1 > 0, open2 = len2 > 0;
  int per = 1;  // batches per open row in this round
  while (open1 || open2) {
    const int n1 = open1 ? per : 0;
    const int n2 = open2 ? n1 + per : n1;  // row2's batches are [n1, n2)
    int u[kGatherBatch];
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) {
      const int k1 = pos1 + q * 32 + lane;
      const int k2 = pos2 + (q - n1) * 32 + lane;
      u[q] = q < n1 ? (k1 < len1 ? __ldg(row1 + k1) : sentinel)
             : q < n2 && k2 < len2 ? __ldg(row2 + k2)
                                   : sentinel;
    }
    int c[kGatherBatch];
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) {
      c[q] = u[q] != sentinel ? view[u[q]] : 0;
    }
    bool end1 = false, end2 = false;  // a sentinel (or the row's end) seen
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) {
      or_color(words, c[q], mc);
      end1 |= q < n1 && u[q] == sentinel;
      end2 |= q >= n1 && q < n2 && u[q] == sentinel;
    }
    pos1 += n1 * 32;
    pos2 += (n2 - n1) * 32;
    end1 = __any_sync(kFullMask, end1);
    end2 = __any_sync(kFullMask, end2);
    open1 = open1 && !end1 && pos1 < len1;
    open2 = open2 && !end2 && pos2 < len2;
    per = open1 && open2 ? kGatherBatch / 2 : kGatherBatch;
  }
}

// One tile of shard p: `rows` points at its first row; in recolor mode the
// rows at positions < n_active are active.
template <bool kD2>
__device__ __forceinline__ void color_tile(const RunArgs& a, int p,
                                           int* view, const int* rows,
                                           int n_active, unsigned* words,
                                           int* scratch, int warp,
                                           int n_warps, int lane) {
  const int mc = a.n_words * 32;
  const int sentinel = static_cast<int>(a.n_slots) - 1;
  for (int i = warp; i < a.tile; i += n_warps) {
    bool active;
    int v;
    if (a.recolor) {
      active = i < n_active;
      v = active ? __ldg(rows + i) : 0;
    } else {
      v = __ldg(rows + i);
      active = v >= 0 && view[v] == 0;  // warp-uniform
    }
    int color = -1;
    if (active) {
      const long long r = static_cast<long long>(p) * a.n_local_max + v;
      // the draw and the offset go out before the gathers
      const int off = a.staggered ? __ldg(a.offset + p) : 0;
      const unsigned rand =
          a.x ? static_cast<unsigned>(__ldg(a.rand_bits + r)) : 0u;
      clear_bitset(words, a.n_words, lane);
      __syncwarp();
      or_neighbours(words, view, a.nbr + r * a.maxd, a.maxd,
                    kD2 ? a.nbr2 + r * a.maxd2 : nullptr, kD2 ? a.maxd2 : 0,
                    sentinel, mc, lane);
      __syncwarp();
      color = min(select_from_bitset(words, a.n_words, a.x, a.staggered, off,
                                     rand, lane),
                  mc - 1);
      __syncwarp();  // every lane is done with the bitset
    }
    if (lane == 0) scratch[i] = color;
  }
  __syncthreads();  // the whole tile has read the view
  for (int i = warp; i < a.tile; i += n_warps) {
    if (lane == 0) {
      const int color = scratch[i];
      if (color >= 0) view[__ldg(rows + i)] = color;
    }
  }
  __syncthreads();  // the tile's writes are in before the next tile reads
}

template <bool kD2>
__device__ __forceinline__ void select_run_body(const RunArgs& a) {
  extern __shared__ unsigned smem[];
  const int p = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  unsigned* words = smem + warp * a.n_words;
  int* view = a.view + p * a.n_slots;
  const int* rows = a.rows + static_cast<long long>(p) * a.rows_len;
  int* scratch = a.scratch + static_cast<long long>(p) * a.tile;
  if (a.recolor) {
    const long long sched = static_cast<long long>(p) * a.n_cls;
    const int* chunks =
        a.class_chunks + static_cast<long long>(p / a.lane_shards) * a.n_cls;
    for (int t = a.first; t <= a.last; ++t) {
      const int n_chunks = __ldg(chunks + t);
      const int start = __ldg(a.start + sched + t);
      const int size = __ldg(a.sizes + sched + t);
      for (int j = 0; j < n_chunks; ++j) {
        const int pos = min(start + j * a.tile, a.n_local_max);
        color_tile<kD2>(a, p, view, rows + pos, size - j * a.tile, words,
                        scratch, warp, n_warps, lane);
      }
    }
  } else {
    const int n_tiles = (a.superstep + a.tile - 1) / a.tile;
    const int last = a.rows_len - a.tile;
    for (int si = a.first; si <= a.last; ++si) {
      for (int ti = 0; ti < n_tiles; ++ti) {
        const int s0 = min(si * a.superstep + ti * a.tile, last);
        color_tile<kD2>(a, p, view, rows + s0, 0, words, scratch, warp,
                        n_warps, lane);
      }
    }
  }
}

// Builds the arguments and launches `kernel` with one block per shard.
template <typename Kernel>
int launch_run(Kernel kernel, void* view, const void* rows, const void* nbr,
               const void* nbr2, const void* rand_bits, const void* offset,
               const void* start, const void* sizes,
               const void* class_chunks, void* scratch, int n_shards,
               long long n_slots, int rows_len, int n_local_max, int maxd,
               int maxd2, int n_cls, int lane_shards, int first, int last,
               int superstep,
               int tile, int recolor, int n_words, int x, int staggered,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_warps = tile < kRunMaxWarps ? tile : kRunMaxWarps;
  const size_t smem = static_cast<size_t>(n_warps) * n_words * sizeof(unsigned);
  err = set_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  RunArgs a;
  a.view = static_cast<int*>(view);
  a.rows = static_cast<const int*>(rows);
  a.nbr = static_cast<const int*>(nbr);
  a.nbr2 = static_cast<const int*>(nbr2);
  a.rand_bits = static_cast<const int*>(rand_bits);
  a.offset = static_cast<const int*>(offset);
  a.start = static_cast<const int*>(start);
  a.sizes = static_cast<const int*>(sizes);
  a.class_chunks = static_cast<const int*>(class_chunks);
  a.scratch = static_cast<int*>(scratch);
  a.n_slots = n_slots;
  a.rows_len = rows_len;
  a.n_local_max = n_local_max;
  a.maxd = maxd;
  a.maxd2 = maxd2;
  a.n_cls = n_cls;
  a.lane_shards = lane_shards > 0 ? lane_shards : n_shards;
  a.first = first;
  a.last = last;
  a.superstep = superstep;
  a.tile = tile;
  a.recolor = recolor;
  a.n_words = n_words;
  a.x = x;
  a.staggered = staggered;
  kernel<<<n_shards, n_warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_select
