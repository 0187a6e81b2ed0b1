// Confusion counts for ConfusionMatrix, multiclass and multilabel.
//
// confusion_counts replaces metrics_tpu/ops/confusion_counts.py
// `_confusion_kernel` (wrapper `_confusion_counts_pallas`):
//   confmat[t, p] = #{n : target[n] = t, preds[n] = p}, indices outside [0, C)
//   dropped. The indices are int32 or int64, read as given.
//   Bound on an H100: bytes. It reads two index vectors once and the wrapper
//   zero-fills the int64 [C, C] output (at N = 16,777,216 int64 and C = 20:
//   268 MB read, 80 us at 3.35 TB/s; at N = 8192, C = 1000 the 8 MB fill
//   dominates, 2.4 us); the work is N adds.
//   The TPU kernel built one-hot tiles in VMEM and contracted them on the
//   MXU because a TPU has no scatter hardware; that is not carried over.
//   Two routes, picked by C (the wrapper's `_confusion_route`):
//   1. Shared (C * C * 4 bytes <= 232,448, the 227 KB of dynamic shared
//      memory an H100 block may opt into: C <= 241, since 241^2 * 4 =
//      232,324 and 242^2 * 4 = 234,256). The first design gave every sample
//      a 64-bit global atomicAdd; on segmentation labels (C = 20, a third of
//      the pixels on the road cell) some 5.6 million of them per call landed
//      on one L2 address and serialized: 4.70 ms at N = 16,777,216, 4x
//      torch.bincount and 59x the byte bound. Now each block of 512 threads
//      keeps `copies` private C * C histograms of 32-bit counters in shared
//      memory, warp w adding to copy w % copies, so warps do not contend
//      for one cell; the wrapper gives 16 copies (one per warp), halved
//      until they fit half an SM's shared memory (two blocks resident),
//      and at least one. Each sample adds 1 to its cell with a shared-memory
//      atomicAdd. The warp aggregation first planned (lanes of one key
//      found with __match_any_sync, the lowest adding __popc of the group
//      once) is built with -DMT_CC_MERGE=1 and timed against this (a
//      second library: the flag added to ops/_build.py's NVCC_FLAGS, with
//      _build._LIB reset, both timed in one process): with a copy per warp
//      the loop waits on device memory and the shared atomics' conflicts
//      hide behind it, so the merge saves nothing on
//      segmentation runs and costs more than the atomics it saves on
//      uniform keys, where nothing merges (PERF.md has the times). So it
//      is off.
//      The grid covers the SMs (as many blocks as are resident, fewer for
//      small N, each taking an equal number of chunks); a chunk is 4 loads
//      of each input per thread, all in flight before any is used, 16
//      bytes each (2 int64 or 4 int32) where both inputs are 16-byte
//      aligned, else one index; the last N % 2 or N % 4 samples of the
//      16-byte route go to block 0's first threads. When a block is done it
//      adds each nonzero cell, summed over its copies, to the caller-zeroed
//      int64 output with one 64-bit atomicAdd: at most C * C global atomics
//      per block, not one per sample.
//      Exact with 32-bit counters: a counter counts at most the samples of
//      its block, and a block takes ceil(chunks / resident) chunks of 2048 *
//      V samples (plus block 0's tail of fewer than V). An H100 holds at
//      least 132 resident blocks (one per SM), so a block passes 2^31 - 1
//      samples only once N is about 132 * 2^31 = 2.8e11 indices per input:
//      2.3 TB of int32 or 4.5 TB of int64, against the card's 80 GB. The
//      launch refuses such an N (cudaErrorInvalidValue) rather than wrap.
//      Integer sums are exact in any order, so every launch gives the same
//      counts. The launch is a plain one, so a CUDA graph captures it; the
//      shared-memory limit is raised once per device, outside any stream.
//   2. Global (C > 241, as ImageNet's 1000): each thread takes one sample
//      (grid-stride loop, coalesced reads) and adds 1 to its cell with a
//      64-bit atomicAdd. Cells are spread over C * C addresses, so contention
//      stays low unless the data is skewed; at C = 1000, N = 8192 the kernel
//      is at the launch floor.
//
// Class windows (the sharded state plane): a process whose ConfusionMatrix
//   state is split over classes counts only its rows. The multiclass
//   kernels take a row window [r0, r0 + rows) of the target classes and
//   write the [rows, C] counts of the pairs whose target falls in it,
//   out[(t - r0) * C + p]; other pairs are dropped like out-of-range ones,
//   and the shared route's histograms are [rows, C] (the wrapper's route
//   decides by 4 * rows * C bytes), so no [C, C] is built. The whole matrix
//   is the window (0, C), the same instructions as before. This is the
//   TPU kernel's grid turned into an argument: `_confusion_kernel` is
//   gridded over tiles of 128 target rows, the class-axis sharding unit.
//   The multilabel kernel reads a column window of the [N, ld] inputs in
//   place (the wrapper offsets the pointers by c0 columns and passes the
//   row stride ld), writing the [W, 2, 2] counts of columns [c0, c0 + W).
//
// multilabel_counts replaces metrics_tpu/ops/confusion_counts.py
// `_multilabel_kernel` (wrapper `_multilabel_counts_pallas`):
//   per class c: tp = sum p*t, sum p and sum t over int32 [N, C] inputs (0/1
//   in use; any int32 values give the exact int64 sums), written as the
//   int64 [C, 2, 2] [[tn, fp], [fn, tp]], tn = N - sum p - sum t + tp,
//   fp = sum p - tp, fn = sum t - tp.
//   Bound on an H100: bytes (both [N, C] inputs read once: 1.57 us at
//   [8192, 80] at 3.35 TB/s).
//   Design (the first design gave a thread one column and 64 rows, with one
//   4-byte load per input in flight, on 10,240 threads at [8192, 80], and
//   the wrapper zero-filled the sums and finished them with six more device
//   operations: 8.53 us of kernel, 0.199 ms of wrapper):
//   a block covers a tile of W <= 16 columns and a chunk of rows. Its lanes
//   (L per row, a power of 2) each own E columns: E = 4 with 16-byte loads
//   where C is a multiple of 4 and both inputs are 16-byte aligned (the
//   wrapper's route decides), else E = 1; 256 / L rows per step, with eight
//   steps' loads of both inputs in flight before any is used (one trip at
//   [8192, 80]). The three sums stay in 64-bit registers; a warp folds them
//   over its rows with shuffles, the block over its warps in shared memory.
//   The chunks of one tile (at most 16) run as one cluster (a non-portable
//   size above 8): every block stores its sums into block 0's shared memory
//   (distributed shared memory, after a barrier wait that proves all blocks
//   started, whose arrive was the kernel's first instruction), and after one
//   more cluster barrier block 0 adds them up and writes the final counts.
//   One launch writes the whole output: no zero-fill, no scratch, no atomics.
//   The tiles give a grid of C / W clusters (80 blocks at C = 80). Integer
//   sums are exact in any order, so every launch gives the same counts.
//   A probe (scratch, not kept) also ran the other route: per-block partials
//   in a scratch, folded after a cooperative grid barrier on every SM. It
//   was slower at [8192, 80] and no faster at [200000, 80], so it did not
//   ship. The probe's first version, which read the other blocks' sums in
//   a loop between two cluster barriers, was slower than this one.
//
// The kernels allocate nothing and launch on the caller's stream and device;
// every C entry returns cudaGetLastError() so a refused launch is reported.
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM is plenty for a grid-stride loop
constexpr int kSmThreads = 512;       // shared route: 16 warps a block
constexpr int kSmWarps = kSmThreads / 32;
constexpr int kSmUnroll = 4;  // loads of each input in flight per thread before any is used
#ifndef MT_CC_MERGE
#define MT_CC_MERGE 0  // 1: warp-aggregated increments (__match_any_sync), for timing against the default
#endif
constexpr int kMlThreads = 256;
constexpr int kMlTile = 16;       // columns per block: 4 lanes of 4, or up to 16 lanes of 1
constexpr int kMlUnroll = 8;      // row steps whose loads are in flight before any is used
constexpr int kMlMaxCluster = 16;  // chunks of a tile, one cluster (more than 8 is not portable)

// Sets `attr` of `kernel` to `value` once per device (bit `device` of
// `done`): each call costs host time on every launch of a path that is
// host-bound.
template <typename K>
cudaError_t set_once(K* kernel, cudaFuncAttribute attr, int value, int device, std::atomic<unsigned long long>& done) {
  const unsigned long long bit = 1ULL << (device & 63);
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, attr, value);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <typename I>
__global__ void confusion_counts_kernel(const I* __restrict__ target, const I* __restrict__ preds, int64_t n,
                                        int64_t c, int64_t r0, int64_t rows, unsigned long long* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t t = static_cast<int64_t>(target[i]) - r0;
    const int64_t p = preds[i];
    if (t >= 0 && t < rows && p >= 0 && p < c) {
      atomicAdd(out + t * c + p, 1ULL);
    }
  }
}

// V consecutive indices: one 16-byte load (V = 16 / sizeof(I)) or one index.
template <int V>
__device__ __forceinline__ void load_indices(const int64_t* p, int64_t i, int64_t (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[i];
  } else {
    static_assert(V == 2, "16 bytes hold 2 int64");
    const longlong2 q = reinterpret_cast<const longlong2*>(p)[i];
    v[0] = q.x, v[1] = q.y;
  }
}
template <int V>
__device__ __forceinline__ void load_indices(const int32_t* p, int64_t i, int32_t (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[i];
  } else {
    static_assert(V == 4, "16 bytes hold 4 int32");
    const int4 q = reinterpret_cast<const int4*>(p)[i];
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
}

// The cell (t - r0) * c + p, or -1 where t is outside the window
// [r0, r0 + rows) or p outside [0, c).
template <typename I>
__device__ __forceinline__ int cell_of(I t, I p, int c, int r0, int rows) {
  return (t >= static_cast<I>(r0) && t < static_cast<I>(r0 + rows) && p >= 0 && p < c)
             ? static_cast<int>(t - static_cast<I>(r0)) * c + static_cast<int>(p)
             : -1;
}

// The shared route: `copies` (a power of 2, at most kSmWarps) private
// [rows * c] histograms in dynamic shared memory; V indices per load.
template <typename I, int V>
__global__ void __launch_bounds__(kSmThreads) confusion_shared_kernel(
    const I* __restrict__ target, const I* __restrict__ preds, int64_t n, int c, int r0, int rows, int copies,
    unsigned long long* __restrict__ out) {
  extern __shared__ unsigned hist[];  // [copies][rows * c]
  const int cells = rows * c;
  const int tid = threadIdx.x;
  for (int i = tid; i < copies * cells; i += kSmThreads) hist[i] = 0;
  __syncthreads();
  unsigned* mine = hist + ((tid >> 5) & (copies - 1)) * cells;
  const int64_t nvec = n / V;
  if (V > 1 && blockIdx.x == 0 && tid < n - nvec * V) {
    const int key = cell_of(target[nvec * V + tid], preds[nvec * V + tid], c, r0, rows);
    if (key >= 0) atomicAdd(mine + key, 1u);
  }
  constexpr int64_t step = int64_t{kSmThreads} * kSmUnroll;  // loads of each input per chunk
  const int64_t chunks = (nvec + step - 1) / step;
  for (int64_t ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    I t[kSmUnroll][V], p[kSmUnroll][V];
#pragma unroll
    for (int u = 0; u < kSmUnroll; ++u) {
      const int64_t i = ch * step + u * kSmThreads + tid;
      if (i < nvec) {
        load_indices<V>(target, i, t[u]);
        load_indices<V>(preds, i, p[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) t[u][e] = p[u][e] = -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kSmUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int key = cell_of(t[u][e], p[u][e], c, r0, rows);
#if MT_CC_MERGE
        // every lane of the warp is here (the chunk loop is the same for the whole block)
        const unsigned group = __match_any_sync(0xFFFFFFFFu, key);
        if (key >= 0 && (tid & 31) == __ffs(group) - 1) atomicAdd(mine + key, static_cast<unsigned>(__popc(group)));
#else
        if (key >= 0) atomicAdd(mine + key, 1u);
#endif
      }
    }
  }
  // each nonzero cell, summed over the copies, into the output
  __syncthreads();
  for (int i = tid; i < cells; i += kSmThreads) {
    unsigned long long sum = 0;
    for (int k = 0; k < copies; ++k) sum += hist[k * cells + i];
    if (sum) atomicAdd(out + i, sum);
  }
}

template <typename I, int V>
cudaError_t launch_shared(int device, const I* target, const I* preds, int64_t n, int c, int r0, int rows,
                          int copies, unsigned long long* out, cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};
  static std::atomic<unsigned long long> resident_on[64];  // smem bytes << 32 | resident blocks; 0: not yet known
  auto* kernel = confusion_shared_kernel<I, V>;
  // the caller's route picks copies that fit; a request past the device's
  // opt-in limit fails at the launch
  const int64_t bytes = int64_t{copies} * rows * c * static_cast<int64_t>(sizeof(unsigned));
  if (bytes > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const unsigned smem = static_cast<unsigned>(bytes);
  cudaError_t err = cudaSuccess;
  if (!(raised.load() & (1ULL << (device & 63)))) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = set_once(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit, device, raised);
    if (err != cudaSuccess) return err;
  }
  unsigned long long known = resident_on[device & 63].load();
  if (known >> 32 != smem || (known & 0xFFFFFFFFu) == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSmThreads, smem);
    if (err != cudaSuccess) return err;
    known = static_cast<unsigned long long>(smem) << 32 | static_cast<unsigned>(sms * (per_sm > 0 ? per_sm : 1));
    resident_on[device & 63].store(known);
  }
  const int64_t resident = static_cast<int64_t>(known & 0xFFFFFFFFu);
  const int64_t step = int64_t{kSmThreads} * kSmUnroll;
  const int64_t chunks = (n / V + step - 1) / step;
  // blocks of an equal number of chunks each, no more than are resident
  const int64_t per_block = chunks > resident ? (chunks + resident - 1) / resident : 1;
  // no 32-bit counter may pass 2^31 - 1: a block counts at most this many samples
  if (per_block * step * V + (V - 1) > 0x7FFFFFFF) return cudaErrorInvalidValue;
  int64_t blocks = (chunks + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kSmThreads, smem, stream>>>(target, preds, n, c, r0, rows, copies, out);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_confusion(int device, const I* target, const I* preds, int64_t n, int64_t c, int64_t r0,
                             int64_t rows, int copies, unsigned long long* out, cudaStream_t stream) {
  if (copies == 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    confusion_counts_kernel<I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(target, preds, n, c, r0, rows,
                                                                                       out);
    return cudaGetLastError();
  }
  constexpr int V = 16 / sizeof(I);
  const bool vec = (reinterpret_cast<uintptr_t>(target) | reinterpret_cast<uintptr_t>(preds)) % 16 == 0;
  const int ci = static_cast<int>(c), r0i = static_cast<int>(r0), rowsi = static_cast<int>(rows);
  return vec ? launch_shared<I, V>(device, target, preds, n, ci, r0i, rowsi, copies, out, stream)
             : launch_shared<I, 1>(device, target, preds, n, ci, r0i, rowsi, copies, out, stream);
}

// 4 or 1 consecutive int32 of one row.
__device__ __forceinline__ void load_cols(const int32_t* p, int32_t (&v)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_cols(const int32_t* p, int32_t (&v)[1]) { v[0] = *p; }

// One (column tile, row chunk) block; the grid's y dimension spans the
// chunks of a tile, launched as one cluster.
template <int E>
__global__ void __launch_bounds__(kMlThreads) multilabel_counts_kernel(
    const int32_t* __restrict__ preds, const int32_t* __restrict__ target, int64_t n, int64_t c, int64_t ld,
    int lanes, int64_t rows_chunk, long long* __restrict__ out) {
  namespace cg = cooperative_groups;
  __shared__ long long warp_part[kMlThreads / 32][3 * kMlTile];
  __shared__ long long gathered[kMlMaxCluster][3 * kMlTile];  // block 0's: every block's sums
  // arrive early at the barrier whose wait proves every block of the
  // cluster has started (before any block writes to another's shared memory)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = tid & (lanes - 1);
  const int rs = kMlThreads / lanes;  // rows per step
  const int w = lanes * E;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * w;
  const int64_t col = c0 + static_cast<int64_t>(l) * E;
  const bool mine = col < c;  // E = 4 only when C % 4 == 0: all four columns are then in range
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_chunk;
  const int64_t r1 = r0 + rows_chunk < n ? r0 + rows_chunk : n;
  long long tp[E], sp[E], st[E];
#pragma unroll
  for (int e = 0; e < E; ++e) tp[e] = sp[e] = st[e] = 0;
  for (int64_t r = r0 + tid / lanes; r < r1; r += static_cast<int64_t>(kMlUnroll) * rs) {
    int32_t p[kMlUnroll][E], t[kMlUnroll][E];
#pragma unroll
    for (int u = 0; u < kMlUnroll; ++u) {
      const int64_t ru = r + static_cast<int64_t>(u) * rs;
      if (mine && ru < r1) {
        load_cols(preds + ru * ld + col, p[u]);
        load_cols(target + ru * ld + col, t[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) p[u][e] = t[u][e] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kMlUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        tp[e] += static_cast<long long>(p[u][e]) * t[u][e];
        sp[e] += p[u][e];
        st[e] += t[u][e];
      }
    }
  }
  // lanes with the same l hold the same columns: fold them over the warp
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      tp[e] += __shfl_xor_sync(0xFFFFFFFFu, tp[e], off);
      sp[e] += __shfl_xor_sync(0xFFFFFFFFu, sp[e], off);
      st[e] += __shfl_xor_sync(0xFFFFFFFFu, st[e], off);
    }
  }
  if (lane < lanes) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      long long* v = warp_part[warp] + 3 * (lane * E + e);
      v[0] = tp[e], v[1] = sp[e], v[2] = st[e];
    }
  }
  __syncthreads();
  long long block_sum = 0;  // the block's value tid
  if (tid < 3 * w) {
#pragma unroll
    for (int k = 0; k < kMlThreads / 32; ++k) block_sum += warp_part[k][tid];
  }
  // every block stores its sums into block 0's shared memory (once all
  // blocks have started, as a cluster's shared memory requires), one
  // barrier, and block 0 adds them up and writes the counts
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int ranks = static_cast<int>(cl.num_blocks());
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid < 3 * w) cl.map_shared_rank(&gathered[0][0], 0)[rank * 3 * kMlTile + tid] = block_sum;
  cl.sync();
  if (rank == 0 && tid < w && c0 + tid < c) {
    long long tps = 0, sps = 0, sts = 0;
    for (int q = 0; q < ranks; ++q) {
      tps += gathered[q][3 * tid], sps += gathered[q][3 * tid + 1], sts += gathered[q][3 * tid + 2];
    }
    long long* o = out + 4 * (c0 + tid);
    o[0] = n - sps - sts + tps, o[1] = sps - tps, o[2] = sts - tps, o[3] = tps;
  }
}

}  // namespace

extern "C" {

const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// target, preds: int32 (index_bytes 4) or int64 (8) [n]; the row window
// [r0, r0 + rows) of [0, c) (the whole matrix: 0, c); copies: 0 for the
// global route, else the shared route's histograms per block (a power of
// 2, at most 16, with copies * rows * c * 4 bytes within the device's
// opt-in shared memory); out: int64 [rows, c], zeroed by the caller.
int mt_confusion_counts(int device, const void* target, const void* preds, int64_t n, int64_t c, int64_t r0,
                        int64_t rows, int index_bytes, int copies, void* out, void* stream) {
  const bool shared_ok =
      copies > 0 && copies <= kSmWarps && !(copies & (copies - 1)) && c <= 46340 && rows * c <= 0x1FFFFFFF;
  if (n < 0 || c < 1 || r0 < 0 || rows < 0 || r0 + rows > c || (index_bytes != 4 && index_bytes != 8) ||
      (copies != 0 && !shared_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0 || rows == 0) return static_cast<int>(cudaGetLastError());
  auto* o = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      index_bytes == 8
          ? launch_confusion(device, static_cast<const int64_t*>(target), static_cast<const int64_t*>(preds), n, c,
                             r0, rows, copies, o, s)
          : launch_confusion(device, static_cast<const int32_t*>(target), static_cast<const int32_t*>(preds), n, c,
                             r0, rows, copies, o, s);
  return static_cast<int>(err);
}

// preds, target: int32, c columns of n rows at a row stride of ld (a
// column window of a row-major [n, ld] input: the pointers at its first
// column); lanes: lanes per row (a power of 2, at most 16, or at most 4
// with vec); vec: 16-byte loads of 4 columns (c and ld multiples of 4,
// both inputs 16-byte aligned); out: int64 [c, 2, 2] [[tn, fp], [fn, tp]],
// fully written.
int mt_multilabel_counts(int device, const void* preds, const void* target, int64_t n, int64_t c, int64_t ld,
                         int lanes, int vec, void* out, void* stream) {
  const int e = vec ? 4 : 1;
  if (n < 0 || c < 0 || ld < c || lanes < 1 || lanes * e > kMlTile || (lanes & (lanes - 1)) ||
      (vec && (c % 4 || ld % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (c == 0) return static_cast<int>(cudaGetLastError());
  const int64_t tiles = (c + lanes * e - 1) / (lanes * e);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t step = kMlThreads / lanes * kMlUnroll;  // rows a block reads per loop trip
  int64_t chunks = (n + step - 1) / step;
  if (chunks > kMlMaxCluster) chunks = kMlMaxCluster;
  if (chunks < 1) chunks = 1;
  const int64_t rows = (n + chunks - 1) / chunks;
  static std::atomic<unsigned long long> clusters_allowed[2];
  auto* kernel = vec ? multilabel_counts_kernel<4> : multilabel_counts_kernel<1>;
  // clusters of more than 8 blocks
  const cudaError_t prep =
      set_once(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1, device, clusters_allowed[vec]);
  if (prep != cudaSuccess) return static_cast<int>(prep);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  cfg.blockDim = dim3(kMlThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(chunks);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = chunks > 1;  // one block per tile needs no cluster, and launches sooner without the attribute
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int32_t*>(preds),
                                                static_cast<const int32_t*>(target), n, c, ld, lanes, rows,
                                                static_cast<long long*>(out));
  return static_cast<int>(launch != cudaSuccess ? launch : cudaGetLastError());
}

}  // extern "C"
