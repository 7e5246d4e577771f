// Device code of the frontier conflict kernels (conflict_frontier.cu,
// conflict_frontier_d2.cu): one launch runs a speculative round's whole
// repair, on every shard at once, reading the visit order, the ELL ids,
// the view and the priorities itself.
//
// Semantics (kernels/ref.py:detect_conflicts_frontier, the chunk loop it
// replaces; the reference's repro/core/speculative.py:
// _detect_conflicts_frontier): for shard p and position i < n_pos of the
// visit order `rows`, the row r = rows[p, i] is active iff r >= 0 and
// i < n_need[p].  An active row with view[p, r] > 0 loses iff some id k of
// its nbr row (and, at distance 2, of its nbr2 row) has view[p, k] ==
// view[p, r] and prio[p, k] > prio[p, r].  Every row reads the view as it
// stood before the repair: losers are set to 0 in new_view (the caller's
// copy of view), and view is only read.  The shards form lanes of
// lane_shards each (the graphs of a batch; one lane for one graph), and
// the counts are per lane: for shard p of lane l = p / lane_shards,
// counts[l, 0] gets the number of its losers added, counts[l, 1] is ORed
// with 1 iff one of them has is_internal[p, r] false.
//
// Design: one warp per frontier position, over a grid that fills the
// card's SMs and strides over the positions of all shards (the rows need
// nothing of each other, so there is no order to keep).  A row that
// cannot lose (inactive or uncolored) is left after reading two ints, its
// order entry and its color, warp-uniformly.  A live row's lanes read its
// ids as an ELL row lays them out — its ids first, then sentinel padding
// (the sentinel slot n_slots - 1 holds color 0) — and gather each id's
// color, and the id's priority only where the colors match; one
// __any_sync gives the row's verdict.  Rows that one round of kBatch
// 32-id loads per lane covers (up to 256 ids: the 26 + 98 of the
// 27-point stencil's two ELL rows) are read in that round as one
// sequence; wider rows (the ELL of a heavy-tailed graph) only up to their
// first sentinel, in rounds as select_run.cuh reads them, and a row that
// has lost stops there.  Each warp counts its losers in registers, for
// one lane at a time (a warp's positions run up the shard axis, so its
// lane only grows), and adds them into the block's per-lane counts in
// shared memory when its lane changes and at the end; then the block
// makes one atomicAdd and one atomicOr per lane it counted into.  view, prio and the index
// arrays do not change during the launch and are read through __ldg.
#pragma once

#include <cuda_runtime.h>

namespace repro_conflict {

constexpr int kWarpsPerBlock = 8;
constexpr int kBatch = 8;  // id loads in flight per lane
constexpr unsigned kFullMask = 0xffffffffu;

struct FrontierArgs {
  const int* view;                   // (P, n_slots), read only
  const int* prio;                   // (P, n_slots) int32
  const unsigned char* is_internal;  // (P, n_local_max) bool
  const int* rows;                   // (P, rows_len) visit order, -1 = skip
  const int* nbr;                    // (P, n_local_max, maxd)
  const int* nbr2;                   // (P, n_local_max, maxd2), distance 2
  const long long* n_need;           // (P,) rows to rescan per shard
  int* new_view;                     // (P, n_slots), losers set to 0
  unsigned long long* counts;        // (n_lanes, 2): losers, boundary loser
  long long n_slots;
  int n_shards, rows_len, n_pos, n_local_max, maxd, maxd2;
  int lane_shards, n_lanes;
};

// Whether one of the ids u[] (sentinel entries skipped) holds color myc
// with a priority above myp.  This lane only.
__device__ __forceinline__ bool batch_loses(const int* view, const int* prio,
                                            const int (&u)[kBatch],
                                            int sentinel, int myc, int myp) {
  int c[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    c[q] = u[q] != sentinel ? __ldg(view + u[q]) : 0;
  }
  bool lose = false;
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (c[q] == myc && __ldg(prio + u[q]) > myp) lose = true;
  }
  return lose;
}

// Whether the row of color myc > 0 and priority myp loses against one of
// the `len1` ids of `row1` or the `len2` ids of `row2` (distance 2).  All
// lanes; warp-uniform result.
__device__ __forceinline__ bool row_loses(const int* view, const int* prio,
                                          const int* row1, int len1,
                                          const int* row2, int len2,
                                          int sentinel, int myc, int myp,
                                          int lane) {
  int u[kBatch];
  if (len1 + len2 <= 32 * kBatch) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k = q * 32 + lane;
      u[q] = k < len1          ? __ldg(row1 + k)
             : k < len1 + len2 ? __ldg(row2 + (k - len1))
                               : sentinel;
    }
    return __any_sync(kFullMask,
                      batch_loses(view, prio, u, sentinel, myc, myp));
  }
  int pos1 = 0, pos2 = 0;
  bool open1 = len1 > 0, open2 = len2 > 0;
  int per = 1;  // batches per open row in this round
  while (open1 || open2) {
    const int n1 = open1 ? per : 0;
    const int n2 = open2 ? n1 + per : n1;  // row2's batches are [n1, n2)
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k1 = pos1 + q * 32 + lane;
      const int k2 = pos2 + (q - n1) * 32 + lane;
      u[q] = q < n1 ? (k1 < len1 ? __ldg(row1 + k1) : sentinel)
             : q < n2 && k2 < len2 ? __ldg(row2 + k2)
                                   : sentinel;
    }
    if (__any_sync(kFullMask,
                   batch_loses(view, prio, u, sentinel, myc, myp))) {
      return true;
    }
    bool end1 = false, end2 = false;  // a sentinel (or the row's end) seen
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      end1 |= q < n1 && u[q] == sentinel;
      end2 |= q >= n1 && q < n2 && u[q] == sentinel;
    }
    pos1 += n1 * 32;
    pos2 += (n2 - n1) * 32;
    end1 = __any_sync(kFullMask, end1);
    end2 = __any_sync(kFullMask, end2);
    open1 = open1 && !end1 && pos1 < len1;
    open2 = open2 && !end2 && pos2 < len2;
    per = open1 && open2 ? kBatch / 2 : kBatch;
  }
  return false;
}

// Adds one warp's loser count and boundary flag of lane `l` into the
// block's per-lane counts (lane 0 of the warp; warp-uniform call).
__device__ __forceinline__ void flush_lane(int* block_counts, int l,
                                           int losers, bool bnd, int lane) {
  if (l >= 0 && lane == 0) {
    if (losers) atomicAdd(block_counts + 2 * l, losers);
    if (bnd) atomicOr(block_counts + 2 * l + 1, 1);
  }
}

template <bool kD2>
__device__ __forceinline__ void frontier_body(const FrontierArgs& a) {
  extern __shared__ int block_counts[];  // (n_lanes, 2)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sentinel = static_cast<int>(a.n_slots) - 1;
  const long long n_warps = static_cast<long long>(a.n_shards) * a.n_pos;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (int k = threadIdx.x; k < 2 * a.n_lanes; k += blockDim.x) {
    block_counts[k] = 0;
  }
  __syncthreads();
  int cur = -1;  // the lane the registers count for
  int losers = 0;
  bool bnd = false;
  for (long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                     warp;
       w < n_warps; w += stride) {
    const int p = static_cast<int>(w / a.n_pos);
    const int i = static_cast<int>(w - static_cast<long long>(p) * a.n_pos);
    if (i >= __ldg(a.n_need + p)) continue;  // warp-uniform from here on
    const int r = __ldg(a.rows + static_cast<long long>(p) * a.rows_len + i);
    if (r < 0) continue;
    const long long vbase = static_cast<long long>(p) * a.n_slots;
    const int myc = __ldg(a.view + vbase + r);
    if (myc <= 0) continue;
    const int myp = __ldg(a.prio + vbase + r);
    const long long rr = static_cast<long long>(p) * a.n_local_max + r;
    const bool lose =
        row_loses(a.view + vbase, a.prio + vbase, a.nbr + rr * a.maxd,
                  a.maxd, kD2 ? a.nbr2 + rr * a.maxd2 : nullptr,
                  kD2 ? a.maxd2 : 0, sentinel, myc, myp, lane);
    if (lose) {
      const int l = p / a.lane_shards;
      if (l != cur) {
        flush_lane(block_counts, cur, losers, bnd, lane);
        cur = l;
        losers = 0;
        bnd = false;
      }
      ++losers;
      bnd = bnd || __ldg(a.is_internal + rr) == 0;
      if (lane == 0) a.new_view[vbase + r] = 0;
    }
  }
  flush_lane(block_counts, cur, losers, bnd, lane);
  __syncthreads();
  for (int l = threadIdx.x; l < a.n_lanes; l += blockDim.x) {
    const int n = block_counts[2 * l];
    if (n) atomicAdd(a.counts + 2 * l, static_cast<unsigned long long>(n));
    if (block_counts[2 * l + 1]) atomicOr(a.counts + 2 * l + 1, 1ull);
  }
}

// Builds the arguments and launches `kernel` over at most as many blocks
// as the card holds at once (fewer when the frontier is smaller), each
// with 8 B of shared memory per lane for its counts.
template <typename Kernel>
int launch_frontier(Kernel kernel, const void* view, const void* prio,
                    const void* is_internal, const void* rows,
                    const void* nbr, const void* nbr2, const void* n_need,
                    void* new_view, void* counts, int n_shards,
                    long long n_slots, int rows_len, int n_pos,
                    int n_local_max, int maxd, int maxd2, int lane_shards,
                    int device, void* stream) {
  if (lane_shards <= 0 || n_shards % lane_shards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_lanes = n_shards / lane_shards;
  const size_t smem = static_cast<size_t>(2 * n_lanes) * sizeof(int);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kWarpsPerBlock * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need =
      (static_cast<long long>(n_shards) * n_pos + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  const long long fit = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(need < fit ? need : fit);
  FrontierArgs a;
  a.view = static_cast<const int*>(view);
  a.prio = static_cast<const int*>(prio);
  a.is_internal = static_cast<const unsigned char*>(is_internal);
  a.rows = static_cast<const int*>(rows);
  a.nbr = static_cast<const int*>(nbr);
  a.nbr2 = static_cast<const int*>(nbr2);
  a.n_need = static_cast<const long long*>(n_need);
  a.new_view = static_cast<int*>(new_view);
  a.counts = static_cast<unsigned long long*>(counts);
  a.n_slots = n_slots;
  a.n_shards = n_shards;
  a.rows_len = rows_len;
  a.n_pos = n_pos;
  a.n_local_max = n_local_max;
  a.maxd = maxd;
  a.maxd2 = maxd2;
  a.lane_shards = lane_shards;
  a.n_lanes = n_lanes;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kWarpsPerBlock * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_conflict
