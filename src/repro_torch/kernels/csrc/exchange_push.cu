// The recoloring loop's boundary exchange as a push, hand-written for
// Hopper (sm_90a): after a run of recolor classes, every vertex the run
// recolored stores its new color at its ghost copies on the other shards,
// and nothing else is copied.
//
// Replaces no TPU kernel: the reference's exchange
// (src/repro/core/comm.py: exchange_boundary, exchange_sparse) is a plain
// gather that re-copies every ghost of the due rounds, which XLA runs.
// The port's pull form (core/comm.py FlatExchange.__call__, one gather and
// one scatter over the flat view) does the same; at distance 1 on a
// 64-shard R-MAT of 2^20 vertices that is about 10 M entries an exchange,
// most of them colors that did not change since the last one.
//
// Inputs: the fan-out CSR of the exchange (fan_ptr (S, n_local_max + 1):
// offsets into fan_dst of each shard's local rows; fan_dst: the flat view
// index of each ghost copy, grouped by source row), and the recoloring
// schedule's own arrays: rows (S, rows_len) step-sorted local rows,
// start/sizes (S, n_cls) first sorted position and rows of each class.
// Shard p's recolored rows are the positions [start[p, first],
// start[p, last] + sizes[p, last]) of rows[p]; lane_on (nullable, one int
// a lane of lane_shards shards) skips a frozen lane.  wire16 sends each
// color through int16, as the pull's payload does.
//
// What bounds it on an H100: per recolored row it reads one row id, one
// color and two offsets and writes its fan-out (about ten 4-byte ids read
// and ten colors written at distance 1): a few hundred KB to a few MB a
// launch, scattered stores, so device-memory latency and the launch
// itself, not bandwidth.  Design: a grid-stride loop over each shard's
// window (no host-known window size, so no read), enough blocks a shard
// to fill the card's 132 SMs whatever the shard count, one thread a row
// walking its fan-out; no synchronize and no allocation.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksToFill = 132 * 4;  // 4 resident blocks on each SM

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    exchange_push_kernel(int* view, const Idx* __restrict__ fan_ptr,
                         const Idx* __restrict__ fan_dst,
                         const int* __restrict__ rows,
                         const int* __restrict__ start,
                         const int* __restrict__ sizes,
                         const int* __restrict__ lane_on, long long n_slots,
                         int rows_len, int n_local_max, int n_cls,
                         int lane_shards, int first, int last, int wire16,
                         int blocks_per_shard) {
  const int p = blockIdx.x / blocks_per_shard;
  const int part = blockIdx.x % blocks_per_shard;
  if (lane_on != nullptr && lane_on[p / lane_shards] == 0) return;
  const long long s = static_cast<long long>(p) * n_cls;
  const int a = start[s + first];
  const int b = start[s + last] + sizes[s + last];
  const int* prow = rows + static_cast<long long>(p) * rows_len;
  const int* pview = view + static_cast<long long>(p) * n_slots;
  const Idx* pptr = fan_ptr + static_cast<long long>(p) * (n_local_max + 1);
  const int stride = blocks_per_shard * kThreads;
  for (int i = a + part * kThreads + threadIdx.x; i < b; i += stride) {
    const int v = prow[i];
    int c = pview[v];
    if (wire16) c = static_cast<int>(static_cast<short>(c));
    const Idx end = pptr[v + 1];
    for (Idx e = pptr[v]; e < end; ++e) view[fan_dst[e]] = c;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Allocates nothing;
// returns the cudaError_t of the launch (0 = launched).  `idx64`: fan_ptr
// and fan_dst are int64 (a view of 2^31 entries or more), else int32.
extern "C" int repro_exchange_push(
    void* view, const void* fan_ptr, const void* fan_dst, const void* rows,
    const void* start, const void* sizes, const void* lane_on, int n_shards,
    long long n_slots, int rows_len, int n_local_max, int n_cls,
    int lane_shards, int first, int last, int wire16, int idx64, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int by_rows = (n_local_max + kThreads - 1) / kThreads;
  const int to_fill = (kBlocksToFill + n_shards - 1) / n_shards;
  const int per_shard = by_rows < to_fill ? (by_rows > 0 ? by_rows : 1)
                                          : to_fill;
  const long long blocks = static_cast<long long>(per_shard) * n_shards;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64) {
    exchange_push_kernel<long long><<<static_cast<unsigned>(blocks),
                                      kThreads, 0, st>>>(
        static_cast<int*>(view), static_cast<const long long*>(fan_ptr),
        static_cast<const long long*>(fan_dst), static_cast<const int*>(rows),
        static_cast<const int*>(start), static_cast<const int*>(sizes),
        static_cast<const int*>(lane_on), n_slots, rows_len, n_local_max,
        n_cls, lane_shards, first, last, wire16, per_shard);
  } else {
    exchange_push_kernel<int><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(
        static_cast<int*>(view), static_cast<const int*>(fan_ptr),
        static_cast<const int*>(fan_dst), static_cast<const int*>(rows),
        static_cast<const int*>(start), static_cast<const int*>(sizes),
        static_cast<const int*>(lane_on), n_slots, rows_len, n_local_max,
        n_cls, lane_shards, first, last, wire16, per_shard);
  }
  return static_cast<int>(cudaGetLastError());
}
