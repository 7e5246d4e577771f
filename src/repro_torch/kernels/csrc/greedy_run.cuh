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
// select_common.cuh, or Least-Used (the free color with the smallest
// positive usage, ties to the smaller color, never the reserved top color;
// First Fit when no open color is free); the color, capped at
// max_colors - 1, is written to view[p, v] and counted in usage[p, color].
//
// What changes inside one launch, and what the design rests on: only the
// launch's own writes, each to a local slot [0, n_local_max) of its own
// shard.  Ghost colors, the ELL and two-hop ids, the order entries and the
// Random-X draws are constant; a local color goes from 0 to a color once.
// So only the colors of a vertex's *local* neighbours have to be read at
// its turn in the order; everything else can be read ahead.
//
// Design: one block per shard, warp-specialised.
//  - Producer warps (kGreedyProducers) walk the launch's positions ahead of
//    the consumers, position k on warp k % kGreedyProducers, into a ring of
//    `ring` slots (position k in slot k % ring).  A position whose entry is
//    -1 or whose vertex is already colored is marked dropped.  For a live
//    one the warp reads the vertex's rows up to their first sentinel
//    (scan_ids, the batching of select_run.cuh's or_neighbours), gathers
//    the ghost ids' colors from device memory into the slot's bitset, lists
//    the local ids in the slot (up to `list_cap`; the count goes beside
//    them) and stores the Random-X draw.
//  - The consumers are kTurnWarps = K turn warps: the live positions, in
//    order, are numbered t = 0, 1, …, and turn warp t % K takes t.  While
//    the K - 1 vertices before it take their turns it prepares t (its own
//    color, its listed local ids' colors ORed into the slot's bitset, and
//    the pick's candidates: the K first free colors, from the Staggered
//    offset too, or Least-Used's K best by (usage, color)).  Then it waits
//    for turn t.  Between its preparation and its turn only those K - 1
//    writes can have changed what it read, and each is in a log in shared
//    memory (vertex, color, usage of the color after it): a write of v
//    itself means v is colored; a write of a listed neighbour whose color
//    was not in the bitset takes that color; a write changes the usage of
//    its color.  K - 1 changes leave one of K candidates standing, so the
//    pick comes from the candidates (Random-X picks afresh when a color
//    was taken, and a row with more local ids than the slot lists is read
//    afresh at its turn: exact, never truncated).  The first K - 2 writes
//    are taken in while turn t - 1 runs, so a turn handles one write, the
//    pick, the write of the color and the log entry, and passes the turn
//    on (a release store; the next turn warp's load acquires it).  The
//    usage row lives in shared memory.
//  - Producers and turn warps hand slots over with a full/empty flag pair
//    per slot (volatile flags, __threadfence_block on both sides).  The
//    full flag carries its position (2k, or 2k + 1 when live), the empty
//    flag the next position the slot may take, so a slot cannot be taken
//    out of turn.  The turn warps read 32 positions' flags at a time (a
//    lane per slot); the last of them done with the 32 gives the slots
//    back.
//  - kLocalSmem: the shard's local colors live in shared memory for the
//    whole launch, as 16-bit values (colors are below max_colors <
//    65536): copied in at the start, with every color <= 0 or >=
//    max_colors stored as max_colors (the pick ignores both alike, and a
//    nonzero own color means "colored" alike); every local read of the
//    launch goes there, so the in-order part reads shared memory only.
//    Each write also goes through to the view after the turn is passed
//    on (no write-back pass).
//  - !kLocalSmem (the wrapper's choice when n_local_max does not fit
//    beside the ring): the same pipeline, the local colors read and
//    written in device memory.
// The view is read through a plain pointer (never __ldg): the launch
// writes it.
#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "select_run.cuh"

namespace repro_select {

constexpr int kGreedyProducers = 12;
constexpr int kTurnWarps = 4;   // the consumers, taking turns (K)
constexpr int kGreedyThreads = (kGreedyProducers + kTurnWarps) * 32;
constexpr int kSlotHeader = 5;  // full, empty, vertex, local count, draw
constexpr int kIdsPerLane = 4;  // a slot lists at most 128 local ids
constexpr int kDoneSlots = 8;   // groups the turn warps can be apart, + 1
// the turn warps' state, in int32 words: the log of the last kTurnWarps
// writes (vertex, color, usage after it, padding), the turn counter, the
// groups' done counts and the highest open color but the reserved one
constexpr int kControl = 4 * kTurnWarps + 1 + kDoneSlots + 1;

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
  int ring, list_cap;     // slots of the ring, local ids per slot
};

// Shared memory of one block, in bytes: the usage row, the ring (per slot
// its header, bitset and local-id list) and, when kLocalSmem, the local
// colors as 16-bit values.  ops.py:_greedy_layout mirrors this.
__host__ __device__ inline size_t greedy_smem_bytes(int n_words, int ring,
                                                    int list_cap,
                                                    int n_local_max,
                                                    bool local_smem) {
  const size_t words = static_cast<size_t>(n_words) * 32 + kControl +
                       static_cast<size_t>(ring) *
                           (kSlotHeader + n_words + list_cap);
  const size_t local = local_smem ? (static_cast<size_t>(n_local_max) + 1) / 2
                                  : 0;
  return (words + local) * sizeof(unsigned);
}

// Calls visit(u) (all lanes) on the ids of `row1` (`len1`) and `row2`
// (`len2`, distance 2), kGatherBatch ids per lane at a time, in the rounds
// of or_neighbours (select_run.cuh): up to 256 ids in one round, read
// whole; wider rows up to their first sentinel.  Entries past a row's end
// are the sentinel.
template <typename Visit>
__device__ __forceinline__ void scan_ids(const int* row1, int len1,
                                         const int* row2, int len2,
                                         int sentinel, int lane,
                                         Visit&& visit) {
  int u[kGatherBatch];
  if (len1 + len2 <= 32 * kGatherBatch) {
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) {
      const int k = q * 32 + lane;
      u[q] = k < len1          ? __ldg(row1 + k)
             : k < len1 + len2 ? __ldg(row2 + (k - len1))
                               : sentinel;
    }
    visit(u);
    return;
  }
  int pos1 = 0, pos2 = 0;
  bool open1 = len1 > 0, open2 = len2 > 0;
  int per = 1;  // batches per open row in this round
  while (open1 || open2) {
    const int n1 = open1 ? per : 0;
    const int n2 = open2 ? n1 + per : n1;  // row2's batches are [n1, n2)
    bool end1 = false, end2 = false;  // a sentinel (or the row's end) seen
#pragma unroll
    for (int q = 0; q < kGatherBatch; ++q) {
      const int k1 = pos1 + q * 32 + lane;
      const int k2 = pos2 + (q - n1) * 32 + lane;
      u[q] = q < n1 ? (k1 < len1 ? __ldg(row1 + k1) : sentinel)
             : q < n2 && k2 < len2 ? __ldg(row2 + k2)
                                   : sentinel;
      end1 |= q < n1 && u[q] == sentinel;
      end2 |= q >= n1 && q < n2 && u[q] == sentinel;
    }
    visit(u);
    pos1 += n1 * 32;
    pos2 += (n2 - n1) * 32;
    end1 = __any_sync(kFullMask, end1);
    end2 = __any_sync(kFullMask, end2);
    open1 = open1 && !end1 && pos1 < len1;
    open2 = open2 && !end2 && pos2 < len2;
    per = open1 && open2 ? kGatherBatch / 2 : kGatherBatch;
  }
}

// A local color: shared memory (kLocalSmem) or the view.
template <bool kLocalSmem>
__device__ __forceinline__ int local_color(const unsigned short* cols,
                                           const int* view, int u) {
  return kLocalSmem ? static_cast<int>(cols[u]) : view[u];
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// Acquire load and release store of a flag in shared memory, block scope.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               :
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
                 "r"(v)
               : "memory");
}

// The slots of the ring, carved from shared memory after the usage row.
struct Ring {
  int* full;        // (ring,) 2k, or 2k + 1 when live: position k is in
  int* empty;       // (ring,) the next position the slot may take
  int* vertex;      // (ring,)
  int* n_local;     // (ring,) local ids of the rows (may pass list_cap)
  unsigned* draw;   // (ring,) Random-X draws
  unsigned* words;  // (ring, n_words) bitsets: ghost colors, then local
  int* ids;         // (ring, list_cap) local ids
  int* log;         // (kTurnWarps, 4) the last writes: vertex, color,
                    // usage after it (Least-Used), padding
  int* turn;        // the live position whose turn it is
  int* done;        // (kDoneSlots,) turn warps done with a group
  int* top;         // the highest open color but the reserved one
};

// One producer warp: positions w, w + kGreedyProducers, … of the launch.
template <bool kD2, bool kLocalSmem>
__device__ __forceinline__ void greedy_produce(const GreedyArgs& a,
                                               const Ring& r, int p,
                                               const int* view,
                                               const unsigned short* cols,
                                               int w, int lane) {
  const int n_pos = a.pos1 - a.pos0;
  const int mc = a.n_words * 32;
  const int sentinel = static_cast<int>(a.n_slots) - 1;
  const int* rows = a.rows + static_cast<long long>(p) * a.rows_len + a.pos0;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = w; base < n_pos; base += 32 * kGreedyProducers) {
    // this warp's next 32 order entries, one per lane
    const int mine_k = base + lane * kGreedyProducers;
    const int mine = mine_k < n_pos ? __ldg(rows + mine_k) : -1;
    const int n = min(32, (n_pos - base + kGreedyProducers - 1) /
                              kGreedyProducers);
    for (int j = 0; j < n; ++j) {
      const int k = base + j * kGreedyProducers;
      const int v = __shfl_sync(kFullMask, mine, j);
      const int s = k % a.ring;
      while (load_volatile(r.empty + s) != k) __nanosleep(64);
      __threadfence_block();
      const bool live =
          v >= 0 &&
          (kLocalSmem ? *reinterpret_cast<const volatile unsigned short*>(
                            cols + v)
                      : load_volatile(view + v)) == 0;
      if (live) {  // warp-uniform
        const long long row = static_cast<long long>(p) * a.n_local_max + v;
        unsigned* words = r.words + static_cast<long long>(s) * a.n_words;
        int* ids = r.ids + static_cast<long long>(s) * a.list_cap;
        if (lane == 0) {
          r.vertex[s] = v;
          r.draw[s] = a.x ? static_cast<unsigned>(__ldg(a.rand_bits + row))
                          : 0u;
        }
        clear_bitset(words, a.n_words, lane);
        __syncwarp();
        int n_local = 0;
        scan_ids(a.nbr + row * a.maxd, a.maxd,
                 kD2 ? a.nbr2 + row * a.maxd2 : nullptr, kD2 ? a.maxd2 : 0,
                 sentinel, lane, [&](const int (&u)[kGatherBatch]) {
                   int c[kGatherBatch];
#pragma unroll
                   for (int q = 0; q < kGatherBatch; ++q) {
                     const bool ghost =
                         u[q] != sentinel && u[q] >= a.n_local_max;
                     c[q] = ghost ? view[u[q]] : 0;
                   }
#pragma unroll
                   for (int q = 0; q < kGatherBatch; ++q) {
                     or_color(words, c[q], mc);
                     const bool local =
                         u[q] != sentinel && u[q] < a.n_local_max;
                     const unsigned m = __ballot_sync(kFullMask, local);
                     const int at = n_local + __popc(m & lt);
                     if (local && at < a.list_cap) ids[at] = u[q];
                     n_local += __popc(m);
                   }
                 });
        if (lane == 0) r.n_local[s] = n_local;
      }
      __threadfence_block();  // the slot's contents before its flag
      __syncwarp();
      if (lane == 0) store_volatile(r.full + s, 2 * k + (live ? 1 : 0));
    }
  }
}

// The K = kTurnWarps smallest free colors at or above `off` (below the
// reserved top color; off <= 0 masks nothing), in order, padded with
// mc - 1: out[0] is find_first_zero(words, n_words, off).  The words are
// read one at a time from the offset's word on, the same by every lane
// (the first word or two hold them unless the row is nearly saturated).
__device__ __forceinline__ void first_zeros(const unsigned* words,
                                            int n_words, int off,
                                            int (&out)[kTurnWarps]) {
  const int mc = n_words * 32;
  const int off_word = off >> 5;  // arithmetic shift: negative off -> < 0
#pragma unroll
  for (int q = 0; q < kTurnWarps; ++q) out[q] = mc - 1;
  int found = 0;
  for (int w = max(off_word, 0); w < n_words && found < kTurnWarps; ++w) {
    unsigned bits = free_word(words, n_words, w);
    if (w == off_word) bits &= ~((1u << (off & 31)) - 1u);
    for (; bits && found < kTurnWarps; bits &= bits - 1u, ++found) {
      const int c = w * 32 + (__ffs(bits) - 1);
#pragma unroll
      for (int q = 0; q < kTurnWarps; ++q) {
        if (q == found) out[q] = c;
      }
    }
  }
}

// Least-Used's K best candidates: the free colors with positive usage
// (never the reserved top color) by (usage, color), best first; padded with
// (INT_MAX, mc).  Only the first `n_scan` words are looked at (the colors
// above have no usage).  Lane l keeps its own K best of colors l, 32 + l,
// …; K rounds of a warp argmin then take them in order.  All lanes;
// warp-uniform result.
__device__ __forceinline__ void least_used_top(const unsigned* words,
                                               const int* usage, int n_words,
                                               int n_scan, int lane,
                                               int (&bu)[kTurnWarps],
                                               int (&bc)[kTurnWarps]) {
  const int mc = n_words * 32;
  constexpr int kBatch = 8;  // loads in flight per lane
  int lu[kTurnWarps], lc[kTurnWarps];
#pragma unroll
  for (int q = 0; q < kTurnWarps; ++q) {
    lu[q] = INT_MAX;
    lc[q] = mc;
  }
  for (int w0 = 0; w0 < n_scan; w0 += kBatch) {
    int u[kBatch];
    unsigned bits[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int w = w0 + q;
      u[q] = w < n_scan ? usage[w * 32 + lane] : 0;
      bits[q] = w < n_scan ? words[w] : ~0u;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      int nu = u[q], nc = (w0 + q) * 32 + lane;
      if (((bits[q] >> lane) & 1u) == 0u && nu > 0 && nc != mc - 1) {
#pragma unroll
        for (int i = 0; i < kTurnWarps; ++i) {  // sorted insert; colors
          if (nu < lu[i]) {                     // rise, so ties keep the
            const int tu = lu[i], tc = lc[i];   // smaller one first
            lu[i] = nu;
            lc[i] = nc;
            nu = tu;
            nc = tc;
          }
        }
      }
    }
  }
  // (usage, color) packed into 32 bits when every usage here fits 16
  // (colors are below 65536): then one min-reduction per round
  bool wide = false;
#pragma unroll
  for (int q = 0; q < kTurnWarps; ++q) {
    wide |= lu[q] != INT_MAX && lu[q] > 0xfffe;
  }
  wide = __any_sync(kFullMask, wide);
#pragma unroll
  for (int q = 0; q < kTurnWarps; ++q) {
    int best_u = lu[0], best_c = lc[0];
    if (!wide) {
      const unsigned key = __reduce_min_sync(
          kFullMask, best_c < mc ? (static_cast<unsigned>(best_u) << 16) |
                                       static_cast<unsigned>(best_c)
                                 : 0xffffffffu);
      best_u = key == 0xffffffffu ? INT_MAX : static_cast<int>(key >> 16);
      best_c = key == 0xffffffffu ? mc : static_cast<int>(key & 0xffffu);
    } else {
      for (int d = 16; d > 0; d >>= 1) {
        const int ou = __shfl_xor_sync(kFullMask, best_u, d);
        const int oc = __shfl_xor_sync(kFullMask, best_c, d);
        if (ou < best_u || (ou == best_u && oc < best_c)) {
          best_u = ou;
          best_c = oc;
        }
      }
    }
    bu[q] = best_u;
    bc[q] = best_c;
    if (best_c < mc && lc[0] == best_c) {  // the owner lane pops its head
#pragma unroll
      for (int i = 0; i + 1 < kTurnWarps; ++i) {
        lu[i] = lu[i + 1];
        lc[i] = lc[i + 1];
      }
      lu[kTurnWarps - 1] = INT_MAX;
      lc[kTurnWarps - 1] = mc;
    }
  }
}

// Whether `c` is one of `list` (-1 entries hold no color).
__device__ __forceinline__ bool in_list(const int (&list)[kTurnWarps - 2],
                                        int c) {
  bool hit = false;
#pragma unroll
  for (int j = 0; j < kTurnWarps - 2; ++j) hit |= list[j] == c;
  return hit;
}

// The first two of `cand` (K colors, in order) not in `taken` (at most
// K - 2 colors, so two remain).
__device__ __forceinline__ void two_not_taken(
    const int (&cand)[kTurnWarps], const int (&taken)[kTurnWarps - 2],
    int& a1, int& a2) {
  bool have1 = false, have2 = false;
  a1 = a2 = cand[kTurnWarps - 1];
#pragma unroll
  for (int q = 0; q < kTurnWarps; ++q) {
    if (!in_list(taken, cand[q])) {
      if (!have1) {
        a1 = cand[q];
        have1 = true;
      } else if (!have2) {
        a2 = cand[q];
        have2 = true;
      }
    }
  }
}

// A logged write e (vertex e.x, -1 for none; color e.y): whether it
// colored one of the vertex's listed local ids (any lane's), and in
// `in_set` whether its color is in the vertex's bitset already (the
// reserved top color always counts as taken).  All lanes.
__device__ __forceinline__ bool write_hits(int4 e,
                                           const int (&id)[kIdsPerLane],
                                           const unsigned* words, int mc,
                                           int lane, bool& in_set) {
  bool hit = false;
#pragma unroll
  for (int q = 0; q < kIdsPerLane; ++q) hit |= id[q] == e.x;
  const int c = e.y;
  in_set = e.x >= 0 &&
           (c == mc - 1 || ((words[c >> 5] >> (c & 31)) & 1u) != 0u);
  return __any_sync(kFullMask, hit && e.x >= 0);
}

// One turn warp: the live vertices t = w, w + K, w + 2K, … of the launch
// (t counts live positions in order), K = kTurnWarps.  For each: a
// preparation while the K - 1 vertices before it take their turns (its
// own color, its listed local ids' colors ORed into the slot's bitset,
// and the pick's candidates: the K first free colors, for Staggered also
// from the offset, for Least-Used its K best), then its turn: the log of
// those K - 1 writes (vertex, color, usage of the color after it) says
// what changed since; the pick is then taken from the candidates
// (Random-X, and rows with more local ids than the list, pick afresh).
// The turn writes the color, logs it and passes the turn on.
template <bool kD2, bool kLeastUsed, bool kLocalSmem>
__device__ __forceinline__ void greedy_turns(const GreedyArgs& a,
                                             const Ring& r, int p, int* view,
                                             unsigned short* cols,
                                             int* usage, int w, int lane) {
  const int n_pos = a.pos1 - a.pos0;
  const int mc = a.n_words * 32;
  const int sentinel = static_cast<int>(a.n_slots) - 1;
  const int off = a.staggered ? __ldg(a.offset + p) : 0;
  const int group = min(32, a.ring);
  int t0 = 0;  // live positions before this group
  for (int k0 = 0, g = 0; k0 < n_pos; k0 += group, ++g) {
    const int n = min(group, n_pos - k0);
    const int s_mine = (k0 + lane) % a.ring;
    int tag = 0;
    if (lane < n) {
      while ((tag = load_volatile(r.full + s_mine)) >> 1 != k0 + lane) {
      }
    }
    __threadfence_block();
    const unsigned live = __ballot_sync(kFullMask, lane < n && (tag & 1));
    // this warp's live positions of the group: ranks i with t0 + i = w mod K
    unsigned mine = 0u;
    {
      unsigned m = live;
      for (int i = 0; m; ++i, m &= m - 1u) {
        if ((t0 + i) % kTurnWarps == w) mine |= m & (~m + 1u);
      }
    }
    for (; mine; mine &= mine - 1u) {
      const int bit = __ffs(mine) - 1;
      const int t = t0 + __popc(live & ((1u << bit) - 1u));
      const int s = (k0 + bit) % a.ring;
      // -- preparation --
      const int v = r.vertex[s];
      const int n_local = r.n_local[s];
      const bool colored = local_color<kLocalSmem>(cols, view, v) != 0;
      unsigned* words = r.words + static_cast<long long>(s) * a.n_words;
      int id[kIdsPerLane];
      int fz[kTurnWarps], sz[kTurnWarps], lu_u[kTurnWarps],
          lu_c[kTurnWarps];
      int pick0 = 0;
      if (!colored) {  // warp-uniform
        const int* ids = r.ids + static_cast<long long>(s) * a.list_cap;
        const int nl = min(n_local, a.list_cap);
        int c[kIdsPerLane];
#pragma unroll
        for (int q = 0; q < kIdsPerLane; ++q) {
          const int i = q * 32 + lane;
          id[q] = i < nl ? ids[i] : -1;
        }
#pragma unroll
        for (int q = 0; q < kIdsPerLane; ++q) {
          c[q] = id[q] >= 0 ? local_color<kLocalSmem>(cols, view, id[q]) : 0;
        }
#pragma unroll
        for (int q = 0; q < kIdsPerLane; ++q) or_color(words, c[q], mc);
        __syncwarp();
        if (n_local <= a.list_cap) {  // else the turn picks afresh
          if (kLeastUsed) {
            // colors above the highest open one have no usage (a color
            // opened since is in the log of the turn)
            const int top = load_volatile(r.top);
            least_used_top(words, usage, a.n_words, min(a.n_words,
                           (top >> 5) + 1), lane, lu_u, lu_c);
            first_zeros(words, a.n_words, 0, fz);
          } else if (a.x) {
            pick0 = random_x_pick(words, a.n_words, a.x, r.draw[s], lane);
          } else {
            first_zeros(words, a.n_words, 0, fz);
            if (a.staggered) first_zeros(words, a.n_words, off, sz);
          }
        }
      }
      // -- the turn --
      // The writes since the preparation are turns t - K + 1 … t - 1: the
      // first K - 2 are taken in while turn t - 1 runs, so that the turn
      // itself handles one write.  A write matters to this vertex if it
      // colored v itself, if it colored a listed neighbour with a color
      // not yet in the bitset (`tk`: taken now), or (Least-Used) by the
      // usage of its color (`ch`: changed colors, usage after the write).
      const int4* log4 = reinterpret_cast<const int4*>(r.log);
      bool seen = false;
      int tk[kTurnWarps - 2], ch_c[kTurnWarps - 2], ch_u[kTurnWarps - 2];
      bool ch_in[kTurnWarps - 2];
      while (load_acquire(r.turn) < t - 1) {
      }
#pragma unroll
      for (int j = 0; j < kTurnWarps - 2; ++j) {
        const int tj = t - kTurnWarps + 1 + j;
        const int4 e =
            tj >= 0 ? log4[tj % kTurnWarps] : make_int4(-1, 0, 0, 0);
        seen |= e.x == v;
        bool in_set = false;
        const bool adjacent =
            !colored && write_hits(e, id, words, mc, lane, in_set);
        tk[j] = adjacent && !in_set ? e.y : -1;
        ch_c[j] = e.x >= 0 ? e.y : -1;
        ch_u[j] = e.z;
        ch_in[j] = in_set;
      }
      // the answers before the last write: the first two candidates not
      // taken (First Fit, Staggered), the best two (Least-Used)
      int a1 = mc - 1, a2 = mc - 1, s1 = mc - 1, s2 = mc - 1;
      int b1u = INT_MAX, b1c = mc, b2u = INT_MAX, b2c = mc;
      if (!colored && n_local <= a.list_cap) {
        if (kLeastUsed || !a.x) two_not_taken(fz, tk, a1, a2);
        if (!kLeastUsed && !a.x && a.staggered) two_not_taken(sz, tk, s1, s2);
        if (kLeastUsed) {
          const auto offer = [&](int u, int c) {
            if (u < b1u || (u == b1u && c < b1c)) {
              b2u = b1u;
              b2c = b1c;
              b1u = u;
              b1c = c;
            } else if (u < b2u || (u == b2u && c < b2c)) {
              b2u = u;
              b2c = c;
            }
          };
#pragma unroll
          for (int q = 0; q < kTurnWarps; ++q) {
            bool changed = false;
#pragma unroll
            for (int j = 0; j < kTurnWarps - 2; ++j) {
              changed |= ch_c[j] == lu_c[q];
            }
            if (!changed && lu_c[q] < mc) offer(lu_u[q], lu_c[q]);
          }
#pragma unroll
          for (int j = 0; j < kTurnWarps - 2; ++j) {
            bool stale = false;  // a later write of the same color
#pragma unroll
            for (int k = j + 1; k < kTurnWarps - 2; ++k) {
              stale |= ch_c[k] == ch_c[j];
            }
            if (ch_c[j] >= 0 && !stale && ch_c[j] != mc - 1 && !ch_in[j] &&
                !in_list(tk, ch_c[j])) {
              offer(ch_u[j], ch_c[j]);
            }
          }
        }
      }
      while (load_acquire(r.turn) != t) {
      }
      const int4 e = t >= 1 ? log4[(t - 1) % kTurnWarps]
                            : make_int4(-1, 0, 0, 0);
      seen |= e.x == v;
      int color = -1;
      if (!colored && !seen) {
        bool in_set = false;
        const bool adjacent = write_hits(e, id, words, mc, lane, in_set);
        const bool newly = adjacent && !in_set;  // e.y taken now
        if (n_local > a.list_cap) {  // every local id afresh
          const long long row =
              static_cast<long long>(p) * a.n_local_max + v;
          scan_ids(a.nbr + row * a.maxd, a.maxd,
                   kD2 ? a.nbr2 + row * a.maxd2 : nullptr, kD2 ? a.maxd2 : 0,
                   sentinel, lane, [&](const int (&u)[kGatherBatch]) {
#pragma unroll
                     for (int q = 0; q < kGatherBatch; ++q) {
                       if (u[q] != sentinel && u[q] < a.n_local_max) {
                         or_color(words,
                                  local_color<kLocalSmem>(cols, view, u[q]),
                                  mc);
                       }
                     }
                   });
          __syncwarp();
          if (kLeastUsed) {  // the best open free color, else First Fit
            least_used_top(words, usage, a.n_words, a.n_words, lane, lu_u,
                           lu_c);
            color = lu_c[0] < mc ? lu_c[0]
                                 : find_first_zero(words, a.n_words, 0, lane);
          } else {
            color = select_from_bitset(words, a.n_words, a.x, a.staggered,
                                       off, r.draw[s], lane);
          }
        } else {
          const int fa = newly && a1 == e.y ? a2 : a1;  // First Fit
          if (kLeastUsed) {
            int bu = b1u, bc = b1c;  // the last write's color at its usage
            if (e.x >= 0 && b1c == e.y) {
              bu = b2u;
              bc = b2c;
            }
            if (e.x >= 0 && e.y != mc - 1 && !adjacent && !in_set &&
                !in_list(tk, e.y) &&
                (e.z < bu || (e.z == bu && e.y < bc))) {
              bu = e.z;
              bc = e.y;
            }
            color = bc < mc ? bc : fa;
          } else if (a.x) {
            bool any = newly;
#pragma unroll
            for (int j = 0; j < kTurnWarps - 2; ++j) any |= tk[j] >= 0;
            if (any) {  // pick afresh with the taken colors in
              if (lane == 0) {
#pragma unroll
                for (int j = 0; j < kTurnWarps - 2; ++j) {
                  if (tk[j] >= 0) or_color(words, tk[j], mc);
                }
                if (newly) or_color(words, e.y, mc);
              }
              __syncwarp();
              color = random_x_pick(words, a.n_words, a.x, r.draw[s], lane);
            } else {
              color = pick0;
            }
          } else if (a.staggered) {
            const int sa = newly && s1 == e.y ? s2 : s1;
            color = sa >= mc - 1 ? fa : sa;
          } else {
            color = fa;
          }
        }
        color = min(color, mc - 1);
      }
      __syncwarp();  // every lane is done with the bitset and the usage
      if (lane == 0) {
        int4* mine_e = reinterpret_cast<int4*>(r.log) + t % kTurnWarps;
        if (color >= 0) {
          if (kLocalSmem) {
            cols[v] = static_cast<unsigned short>(color);
          } else {
            view[v] = color;  // read by the next turns
          }
          int u = 0;
          if (kLeastUsed) {  // read by the next turns
            u = usage[color] + 1;
            usage[color] = u;
            if (u == 1 && color != mc - 1 && color > *r.top) *r.top = color;
          }
          *mine_e = make_int4(v, color, u, 0);
        } else {
          *mine_e = make_int4(-1, 0, 0, 0);
        }
        store_release(r.turn, t + 1);  // the write and its log before it
        if (color >= 0) {  // read by no turn
          if (kLocalSmem) view[v] = color;
          if (!kLeastUsed) atomicAdd(usage + color, 1);
        }
      }
      __syncwarp();
    }
    t0 += __popc(live);
    // the last turn warp done with the group gives its slots back
    __threadfence_block();
    int done = 0;
    if (lane == 0) done = atomicAdd(r.done + g % kDoneSlots, 1) + 1;
    done = __shfl_sync(kFullMask, done, 0);
    if (done == kTurnWarps) {
      if (lane == 0) r.done[g % kDoneSlots] = 0;
      __threadfence_block();
      if (lane < n) store_volatile(r.empty + s_mine, k0 + lane + a.ring);
    }
  }
}

template <bool kD2, bool kLeastUsed, bool kLocalSmem>
__device__ __forceinline__ void greedy_run_body(const GreedyArgs& a) {
  extern __shared__ unsigned smem[];
  const int p = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mc = a.n_words * 32;
  int* usage = reinterpret_cast<int*>(smem);
  Ring r;
  r.log = usage + mc;  // 16-byte aligned: mc is a multiple of 32
  r.turn = r.log + 4 * kTurnWarps;
  r.done = r.turn + 1;
  r.top = r.done + kDoneSlots;
  r.full = r.top + 1;
  r.empty = r.full + a.ring;
  r.vertex = r.empty + a.ring;
  r.n_local = r.vertex + a.ring;
  r.draw = reinterpret_cast<unsigned*>(r.n_local + a.ring);
  r.words = r.draw + a.ring;
  r.ids = reinterpret_cast<int*>(r.words +
                                 static_cast<long long>(a.ring) * a.n_words);
  unsigned short* cols = reinterpret_cast<unsigned short*>(
      r.ids + static_cast<long long>(a.ring) * a.list_cap);
  int* view = a.view + p * a.n_slots;
  int* usage_g = a.usage + static_cast<long long>(p) * mc;
  for (int i = threadIdx.x; i < kControl; i += blockDim.x) {
    r.log[i] = i < 4 * kTurnWarps && i % 4 == 0 ? -1 : 0;  // no writes yet
  }
  __syncthreads();
  for (int c = threadIdx.x; c < mc; c += blockDim.x) {
    const int u = usage_g[c];
    usage[c] = u;
    if (kLeastUsed && u > 0 && c != mc - 1) atomicMax(r.top, c);
  }
  for (int s = threadIdx.x; s < a.ring; s += blockDim.x) {
    r.full[s] = -1;
    r.empty[s] = s;
  }
  if (kLocalSmem) {  // kCopy loads in flight per thread, then the stores
    constexpr int kCopy = 8;
    for (int base = threadIdx.x; base < a.n_local_max;
         base += kCopy * blockDim.x) {
      int c[kCopy];
#pragma unroll
      for (int q = 0; q < kCopy; ++q) {
        const int i = base + q * blockDim.x;
        c[q] = i < a.n_local_max ? view[i] : 0;
      }
#pragma unroll
      for (int q = 0; q < kCopy; ++q) {
        const int i = base + q * blockDim.x;
        if (i < a.n_local_max) {
          cols[i] = static_cast<unsigned short>(
              c[q] == 0 ? 0 : c[q] > 0 && c[q] < mc ? c[q] : mc);
        }
      }
    }
  }
  __syncthreads();
  if (warp < kTurnWarps) {
    greedy_turns<kD2, kLeastUsed, kLocalSmem>(a, r, p, view, cols, usage,
                                              warp, lane);
  } else {
    greedy_produce<kD2, kLocalSmem>(a, r, p, view, cols, warp - kTurnWarps,
                                    lane);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < mc; c += blockDim.x) usage_g[c] = usage[c];
}

// Builds the arguments and launches `kernel` (kGreedyThreads threads per
// shard) with the shared memory of greedy_smem_bytes.
template <typename Kernel>
int launch_greedy(Kernel kernel, void* view, void* usage, const void* rows,
                  const void* nbr, const void* nbr2, const void* rand_bits,
                  const void* offset, int n_shards, long long n_slots,
                  int rows_len, int n_local_max, int maxd, int maxd2,
                  int pos0, int pos1, int n_words, int x, int staggered,
                  int ring, int list_cap, bool local_smem, int device,
                  void* stream) {
  if (list_cap > 32 * kIdsPerLane || ring < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      greedy_smem_bytes(n_words, ring, list_cap, n_local_max, local_smem);
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
  a.ring = ring;
  a.list_cap = list_cap;
  kernel<<<n_shards, kGreedyThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_select
