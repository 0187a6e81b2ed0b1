// Streaming binned counters for the curve and calibration metrics.
//
// binned_counts replaces metrics_tpu/ops/binned_counts.py
// `_binned_counts_kernel` (wrapper `_binned_counts_pallas`):
//   TP[c, t] = #{n : preds[n, c] >= th[t], target[n, c] > 0}
//   FP[c, t] = #{n : preds[n, c] >= th[t], target[n, c] <= 0}
//   FN = pos - TP, TN = (N - pos) - FP, pos[c] = #{n : target[n, c] > 0}.
//   The compare runs in the type the wrapper gives (float32, or float64 when
//   preds or thresholds are float64), so a NaN pred is below every threshold,
//   and thresholds may come in any order, repeat, or be NaN or infinite.
//   Bound on an H100: bytes. With s the thresholds sorted, each (n, c) needs
//   one binary search, ceil(log2(T + 1)) compares, and each count follows
//   from a suffix sum; at [8192, 80], T = 200, that is 5.2M compares against
//   5.76 MB read and written (1.72 us at 3.35 TB/s). The N*C*T compares of
//   the first design (131M, 3.9 us of CUDA-core time) are no longer its floor.
//   The identity: with s holding the non-NaN thresholds ascending and the
//   NaN ones after them, u(p) = #{j : s[j] <= p} (0 for a NaN pred) and
//   lb[t] = #{j : th[j] < th[t]} (T for a NaN threshold),
//       p >= th[t]  exactly when  u(p) > lb[t].
//   So a histogram over the T + 1 values of u, per class and split into
//   positives and negatives, gives TP[c, t] = sum of its positive bins
//   above lb[t], a suffix sum, and FP likewise.
//   Design (what held the first design back was latency: one thread per
//   class and 4 thresholds walked 512 rows with two dependent 4-byte loads
//   each, about 128 round trips to memory per thread, and the wrapper added
//   five device operations: 71 us at [8192, 80] on an H100):
//   1. binned_hist_kernel: blocks cover a tile of up to 16 classes and a
//      chunk of rows (at least 4096 elements). A block takes the thresholds
//      as they are when they ascend strictly with no NaN (any linspace grid:
//      s = th, lb[t] = t), else ranks them in shared memory when T <= 256
//      (rank counting, one warp per threshold); past that
//      rank_thresholds_kernel ranks them once into the scratch. Threads load
//      16 bytes of preds and of target at a time where the layout allows it
//      (a class tile of a multiple of 4 classes, or the single column of a
//      binary input), 8 elements in flight before any is used. Each bin
//      starts from a guess that takes s as evenly spaced, moved by one where
//      a compare says so and checked against its two neighbours in s; only
//      a warp with a lane whose guess fails runs the exact search (binary
//      lifting over s in shared memory, in lockstep over the 8 elements).
//      Each element adds (positive << 16 | negative) to the block's
//      histogram: a 32-bit word per (class, bin); a chunk has at most 65,532
//      rows, so neither half can carry. A warp whose elements all share one
//      bin (equal preds, scores piled into a few bins) adds once
//      (`redux.sync` min and max of the keys agree); other lanes add their
//      own: merging arbitrary groups with __match_any_sync took longer on
//      the card than the shared atomics' conflicts it saved, even on skewed
//      scores.
//   2. Finishing, where the rows fit 16 chunks of at most 8192 rows (both
//      path shapes): the grid is launched in clusters of one class tile's
//      chunks (16 blocks, a non-portable cluster size that Hopper allows).
//      After a cluster barrier, the block of rank r sums class r of every
//      block's histogram through distributed shared memory, takes the
//      suffix sums and writes TP, FP, FN and TN of each original threshold
//      from lb[t]. One launch per call, no scratch written, no atomics in
//      device memory: the counts are exact and deterministic.
//      Otherwise (more rows, or a card that refuses the cluster launch)
//      each block stores its histogram, zero bins too, as one row of a
//      partials array in the scratch (plain stores), and
//      binned_finish_kernel, one block per class, sums the rows, takes the
//      suffix sums (in shared memory up to 1024 bins) and writes the counts.
//   The wrapper allocates outputs and scratch in one torch.empty; the C
//   entry zeroes nothing on these paths.
//   Fallback: where one class's histogram and the sorted thresholds do not
//   fit in a block's shared memory (past about 19,000 thresholds in float32,
//   14,000 in float64), or the rows need more than 65,535 chunks, the blocks
//   add their counts straight to a 64-bit [2, C, T + 1] histogram in the
//   scratch (zeroed by one cudaMemsetAsync; lanes with one key merge first
//   with __match_any_sync, since conflicting global atomics serialize in
//   L2), after rank_thresholds_kernel; the finish kernel then reads that
//   histogram.
//
// binned_calibration replaces metrics_tpu/ops/binned_counts.py
// `_binned_calibration_kernel` (wrapper `_binned_calibration_pallas`):
//   per-bin (count, conf_sum, acc_sum) over B bins of sorted boundaries b:
//   bin i holds b[i] < conf <= b[i+1]; conf <= b[0] falls in no bin; conf above
//   b[B] and NaN land in the last bin (the rule of the JAX package's XLA
//   composition, which its users run; its Pallas body drops such values).
//   Bound on an H100: bytes (two float32 vectors read once: 0.02 us at
//   N = 8192, 10 us at N = 4,194,304).
//   Design (the first design made three shared atomics per element, which
//   serialize when the confidences share a bin: 4x slower on an
//   over-confident classifier's top-1 scores; then up to 3 B global atomics
//   per block, float ones, so the sums changed in their last bits from run
//   to run; and the wrapper zero-filled three outputs):
//   calibration_private_kernel<K>, for B up to K = 16, 32 or 64 (the
//   wrapper's route picks the smallest that holds B). Each thread owns 3 B
//   words of shared memory (a count, a confidence sum and an accuracy sum
//   per bin), word j of thread t at j * 256 + t, so a thread's adds hit its
//   own bank whatever bins its elements fall in: no atomics, no conflicts,
//   a time that does not depend on how the confidences fall. The bin is a
//   branch-free binary search over the boundaries in shared memory, 8
//   elements in lockstep (16-byte loads of 4 where both inputs are
//   aligned; the next 8 in flight meanwhile). A fixed assignment of
//   elements to threads and a fixed folding order make the sums
//   bit-identical from launch to launch: each thread loads its 3 K words
//   into registers and the warp folds them by halving (each step a lane
//   keeps half the values and adds its partner's copy of them: 3 K
//   shuffles in all, not the 15 K of a butterfly over every value), the
//   block folds its warps in shared memory in order, and the blocks fold
//   either as one cluster of up to 16 blocks (up to 32,768 elements; each
//   block stores its values into block 0's shared memory, which adds them
//   in block order) or, past that, as a cooperative grid of every SM's
//   resident blocks, which store their values in the scratch and meet at a
//   grid barrier; block j then folds value j over the blocks in a fixed
//   tree. One launch writes the three outputs in full (count int64, the
//   sums float32): no zero-fill.
//   Probes (scratch, not kept) ran two designs before this one and did not
//   ship them: the bins in registers, every element added to every bin under
//   a predicate (3 K instructions an element, slower than the first design
//   at N = 8192), and the private words folded lane by lane in shared memory
//   (a long chain of dependent loads); and blocks of 1024 threads, so that
//   N = 8192 needs one block and no cluster, were slower too. A binary
//   search whose loads sat under `&&` branches took more of the kernel's
//   time than anything else: a load under a branch waits for the one before
//   it.
//   Past 64 bins the first design's kernel stays (binned_calibration_kernel:
//   a block histogram in shared memory with shared atomics, added to the
//   outputs with global atomics, or straight to the outputs past about
//   14,000 bins), after a memset of the outputs: two device operations, sums
//   within 1e-5 relative of the plain version but not bit-identical from run
//   to run.
//
// The kernels allocate nothing and launch on the caller's stream and device,
// and every C entry returns cudaGetLastError() so a refused launch is reported.
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 512;
constexpr int kFinishThreads = 1024;
constexpr int kRankThreads = 256;
constexpr int kRankInBlock = 256;   // up to this many thresholds, each block ranks them itself
constexpr int kUnroll = 2;          // 16-byte loads in flight per thread before any is used
constexpr int kMaxTile = 16;        // classes per block
constexpr int64_t kMaxChunkRows = 65532;  // a 16-bit half of a bin cannot carry (multiple of 4)
constexpr int64_t kMinBlockElems = 4096;
constexpr int64_t kTargetBlocks = 2 * 132;
constexpr int64_t kMaxRowChunks = 65535;  // gridDim.y limit
constexpr int kMaxFinishBlocks = 8 * 132;
constexpr int kMaxCluster = 16;             // blocks of a cluster (more than 8 is not portable)
constexpr int64_t kClusterMaxRows = 8192;   // rows per block past which the partials path has more parallelism
constexpr size_t kTileSmem = 64 * 1024;   // a class tile is narrowed until its block fits this
constexpr int kCalThreads = 256;
constexpr int kCalMaxBlocks = 132 * 4;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kMaxHistSmem = kMaxSmem - 1024;  // dynamic, beside the histogram kernel's static shared memory
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

// The order thresholds are sorted in: ascending, NaN after every number;
// -0.0 and 0.0 are equal (either may come first, no pred tells them apart).
template <typename T>
__device__ __forceinline__ bool th_less(T a, T b) {
  return !is_nan(a) && (is_nan(b) || a < b);
}

// Adds threshold u (at index j) to the rank of threshold v (at index i):
// `below` counts the thresholds less than v, `ties` the equal ones before i,
// so v's slot in s is below + ties.
template <typename T>
__device__ __forceinline__ void rank_step(T u, int j, T v, int i, int& below, int& ties) {
  const bool lt = th_less(u, v);
  below += lt;
  ties += (j < i) & !lt & !th_less(v, u);
}

// Every rank, for T past what a block ranks itself: the identity for a
// strictly ascending grid, else the O(T^2) count.
template <typename T>
__global__ void __launch_bounds__(kRankThreads) rank_thresholds_kernel(const T* __restrict__ ths, int t,
                                                                       T* __restrict__ sorted,
                                                                       int32_t* __restrict__ lb) {
  __shared__ T tile[kRankThreads];
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  const T v = i < t ? ths[i] : T(0);
  bool ascending = true;  // strictly, and no NaN (a linspace grid): every slot is its index
  for (int j = threadIdx.x; j < t; j += kRankThreads) ascending &= j + 1 < t ? ths[j] < ths[j + 1] : !is_nan(ths[j]);
  if (__syncthreads_and(ascending)) {
    if (i < t) sorted[i] = v, lb[i] = i;
    return;
  }
  int below = 0, ties = 0;
  for (int j0 = 0; j0 < t; j0 += kRankThreads) {
    __syncthreads();
    if (j0 + threadIdx.x < t) tile[threadIdx.x] = ths[j0 + threadIdx.x];
    __syncthreads();
    const int m = t - j0 < kRankThreads ? t - j0 : kRankThreads;
    for (int j = 0; j < m; ++j) rank_step(tile[j], j0 + j, v, i, below, ties);
  }
  if (i < t) {
    sorted[below + ties] = v;
    lb[i] = is_nan(v) ? t : below;
  }
}

// One element per lane into the block's packed histogram, adding
// (positive << 16 | negative). A warp whose elements all fall in one bin
// (equal preds, or scores piled into a few bins as a CTR model's are) adds
// once, with the warp's counts; otherwise each lane adds its own, since
// merging arbitrary groups (__match_any_sync) cost more than the shared
// atomics' conflicts it saves. All 32 lanes call it; a lane without an
// element passes valid = false.
__device__ __forceinline__ void add_shared(uint32_t* hist, bool valid, uint32_t key, bool y) {
  const uint32_t lo = __reduce_min_sync(0xFFFFFFFFu, valid ? key : 0xFFFFFFFFu);
  const uint32_t hi = __reduce_max_sync(0xFFFFFFFFu, valid ? key : 0u);
  if (lo == hi) {
    const unsigned ys = __ballot_sync(0xFFFFFFFFu, valid && y);
    const unsigned vs = __ballot_sync(0xFFFFFFFFu, valid);
    if ((threadIdx.x & 31) == 0) atomicAdd(hist + lo, (__popc(ys) << 16) | (__popc(vs) - __popc(ys)));
  } else if (valid) {
    atomicAdd(hist + key, y ? 0x10000u : 1u);
  }
}

// The same into the 64-bit histogram in device memory: lanes with the same
// key merge first (__match_any_sync), since conflicting global atomics
// serialize in L2.
__device__ __forceinline__ void add_global(unsigned long long* pos_g, unsigned long long* neg_g, bool valid,
                                           unsigned long long key, bool y) {
  const unsigned group = __match_any_sync(0xFFFFFFFFu, valid ? key : ~0ULL);
  const unsigned ys = __ballot_sync(0xFFFFFFFFu, valid && y);
  if (valid && static_cast<int>(threadIdx.x & 31) == __ffs(group) - 1) {
    const unsigned pos = __popc(group & ys);
    const unsigned neg = __popc(group) - pos;
    if (pos) atomicAdd(pos_g + key, static_cast<unsigned long long>(pos));
    if (neg) atomicAdd(neg_g + key, static_cast<unsigned long long>(neg));
  }
}

// 4 consecutive values from a 16-byte aligned address.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(const int32_t* p, bool* y) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  y[0] = q.x > 0, y[1] = q.y > 0, y[2] = q.z > 0, y[3] = q.w > 0;
}

enum LoadMode : int {
  kScalar = 0,  // one element per load; any layout
  kQuads = 1,   // 4 classes of a row per load: C and the tile a multiple of 4, 16-byte aligned
  kColumn = 2,  // 4 rows of a single column per load: C == 1, 16-byte aligned
};

constexpr int kBatch = 4 * kUnroll;  // elements a thread holds at once

// Inclusive prefix sums of (a, b) over the block's threads, in thread order.
__device__ __forceinline__ void block_scan2(unsigned long long& a, unsigned long long& b,
                                            unsigned long long (*warp_sums)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long oa = __shfl_up_sync(0xFFFFFFFFu, a, off);
    const unsigned long long ob = __shfl_up_sync(0xFFFFFFFFu, b, off);
    if (lane >= off) a += oa, b += ob;
  }
  if (lane == 31) warp_sums[0][warp] = a, warp_sums[1][warp] = b;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    unsigned long long wa = lane < warps ? warp_sums[0][lane] : 0ULL;
    unsigned long long wb = lane < warps ? warp_sums[1][lane] : 0ULL;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long oa = __shfl_up_sync(0xFFFFFFFFu, wa, off);
      const unsigned long long ob = __shfl_up_sync(0xFFFFFFFFu, wb, off);
      if (lane >= off) wa += oa, wb += ob;
    }
    warp_sums[0][lane] = wa, warp_sums[1][lane] = wb;
  }
  __syncthreads();
  if (warp > 0) a += warp_sums[0][warp - 1], b += warp_sums[1][warp - 1];
  __syncthreads();
}

// One class's per-bin totals P and Q (shared memory, or device memory read
// through L2 only when kL2: the block wrote them, so not by the read-only
// path) turned into suffix sums in place, top bin first, then TP, FP, FN
// and TN of class `cls` for each threshold from lb. lb0 is this thread's
// first lb, loaded early. Every thread of the block calls it.
template <typename W, bool kL2>
__device__ __forceinline__ void suffix_counts(W* P, W* Q, int t, const int32_t* lb, int lb0, int64_t c, int64_t cls,
                                              long long* __restrict__ out) {
  __shared__ unsigned long long warp_sums[2][32];
  __shared__ unsigned long long carry[2];
  auto ld = [](const W* q) -> unsigned long long {
    if constexpr (kL2) {
      return __ldcg(q);
    } else {
      return *q;
    }
  };
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int bins = t + 1;
  if (tid == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int hi = bins; hi > 0; hi -= threads) {  // chunks of one bin per thread
    const int lo = hi - threads > 0 ? hi - threads : 0;
    const int b = hi - 1 - tid;
    unsigned long long a = b >= lo ? ld(P + b) : 0ULL;
    unsigned long long d = b >= lo ? ld(Q + b) : 0ULL;
    block_scan2(a, d, warp_sums);
    if (b >= lo) P[b] = static_cast<W>(carry[0] + a), Q[b] = static_cast<W>(carry[1] + d);
    __syncthreads();
    if (tid == threads - 1) carry[0] += a, carry[1] += d;
    __syncthreads();
  }
  const unsigned long long pos = ld(P), neg = ld(Q);
  const int64_t ct = c * t;
  for (int i = tid; i < t; i += threads) {
    const int k = (i == tid ? lb0 : lb[i]) + 1;
    const unsigned long long tp = k < bins ? ld(P + k) : 0ULL;
    const unsigned long long fp = k < bins ? ld(Q + k) : 0ULL;
    const int64_t at = cls * t + i;
    out[at] = static_cast<long long>(tp);
    out[ct + at] = static_cast<long long>(fp);
    out[2 * ct + at] = static_cast<long long>(pos - tp);
    out[3 * ct + at] = static_cast<long long>(neg - fp);
  }
  __syncthreads();
}

// The cluster's histograms of a tile summed, and its counts written: the
// cluster spans every row chunk of class tile blockIdx.x, and its block of
// rank r finishes the tile's classes r, r + ranks, ... Each sums the
// class's row of every block's packed histogram through distributed shared
// memory into `tot` (2 x bins words), takes the suffix sums, and writes
// TP, FP, FN and TN of each threshold from lb. The last cluster barrier
// keeps every block's histogram alive until all have read it.
__device__ __forceinline__ void finish_in_cluster(uint32_t* hist, uint32_t* tot, const int32_t* lb, int64_t c,
                                                  int64_t c0, int tile, int t, long long* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int tid = threadIdx.x;
  const int bins = t + 1;
  const int ranks = static_cast<int>(cl.num_blocks());
  const int lb0 = tid < t ? lb[tid] : 0;
  uint32_t* tp_ = tot;
  uint32_t* tn_ = tot + bins;
  for (int cc = static_cast<int>(cl.block_rank()); cc < tile; cc += ranks) {
    for (int b = tid; b < bins; b += kHistThreads) {
      uint32_t sp = 0, sn = 0;
#pragma unroll 4
      for (int q = 0; q < ranks; ++q) {
        const uint32_t v = cl.map_shared_rank(hist, q)[cc * bins + b];
        sp += v >> 16;
        sn += v & 0xFFFFu;
      }
      tp_[b] = sp, tn_[b] = sn;
    }
    __syncthreads();
    suffix_counts<uint32_t, false>(tp_, tn_, t, lb, lb0, c, c0 + cc, out);
  }
  cl.sync();
}

// Histogram of one (class tile, row chunk). kShared: the block's histogram
// in shared memory, then either stored as partials row blockIdx.y (classes
// c0 .. c0 + tile), or, when the grid is launched in clusters that span
// the rows (`cluster`), summed across the cluster's shared memory and
// finished in this kernel. !kShared: adds to the 64-bit histogram.
// `sorted` is null when the block ranks the thresholds itself (kShared only).
template <typename T, bool kShared>
__global__ void __launch_bounds__(kHistThreads, 2) binned_hist_kernel(
    const T* __restrict__ preds, const int32_t* __restrict__ target, const T* __restrict__ ths,
    const T* __restrict__ sorted, int64_t n, int64_t c, int t, int ct, int64_t rows_chunk, int mode, int cluster,
    int32_t* __restrict__ lb, uint32_t* __restrict__ partials, unsigned long long* pos_g,
    unsigned long long* neg_g, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char hist_smem[];
  const int tid = threadIdx.x;
  const int bins = t + 1;
  const T* s = sorted;
  const int32_t* lbs = lb;  // lb as this block sees it
  uint32_t* hist = nullptr;
  if (kShared) {
    T* s_sm = reinterpret_cast<T*>(hist_smem);
    size_t off = align16(sizeof(T) * t);
    if (sorted == nullptr) {
      T* raw = reinterpret_cast<T*>(hist_smem + off);
      off += align16(sizeof(T) * t);
      int32_t* lb_sm = reinterpret_cast<int32_t*>(hist_smem + off);
      off += align16(sizeof(int32_t) * t);
      lbs = lb_sm;
      bool ascending = true;  // strictly, and no NaN: then s is the thresholds as given
      for (int i = tid; i < t; i += kHistThreads) {
        const T v = ths[i];
        raw[i] = v;
        ascending &= i + 1 < t ? v < ths[i + 1] : !is_nan(v);
      }
      ascending = __syncthreads_and(ascending);
      const bool first = blockIdx.x == 0 && blockIdx.y == 0 && !cluster;  // the finish kernel's copy
      if (ascending) {
        s_sm = raw;
        for (int i = tid; i < t; i += kHistThreads) {
          lb_sm[i] = i;
          if (first) lb[i] = i;
        }
      } else {
        // one warp per threshold, its lanes over the others
        const int lane = tid & 31;
        for (int i = tid >> 5; i < t; i += kHistThreads / 32) {
          const T v = raw[i];
          int below = 0, ties = 0;
          for (int j = lane; j < t; j += 32) rank_step(raw[j], j, v, i, below, ties);
          below = __reduce_add_sync(0xFFFFFFFFu, below);
          ties = __reduce_add_sync(0xFFFFFFFFu, ties);
          if (lane == 0) {
            s_sm[below + ties] = v;
            lb_sm[i] = is_nan(v) ? t : below;
            if (first) lb[i] = lb_sm[i];
          }
        }
      }
    } else {
      for (int i = tid; i < t; i += kHistThreads) s_sm[i] = sorted[i];
    }
    hist = reinterpret_cast<uint32_t*>(hist_smem + off);
    for (int i = tid; i < ct * bins; i += kHistThreads) hist[i] = 0;
    __syncthreads();
    s = s_sm;
  }
  const int top = 1 << (31 - __clz(t));  // the largest power of 2 <= t

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * ct;
  const int tile = c - c0 < ct ? static_cast<int>(c - c0) : ct;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_chunk;
  const int64_t r1 = r0 + rows_chunk < n ? r0 + rows_chunk : n;
  // The batch's bins u = #{j : s[j] <= p}. s holds the non-NaN thresholds
  // ascending, then the NaN ones, for which `<=` is false, so the predicate
  // is true on a prefix, and u is right when s[u - 1] <= p < s[u] (the ends
  // taken as true and false). A first guess treats s as evenly spaced
  // (u = floor((p - s[0]) / step) + 1, clamped to [0, T]; a NaN pred gives
  // 0, which is its bin), moved by one where a compare says so; for a
  // linspace grid that is exact. Only when a lane of the warp misses does the warp run
  // the exact search, binary lifting in lockstep so that the searches'
  // shared-memory loads overlap, and keep its result where the guess missed.
  const T first = s[0];
  const T inv_step = static_cast<T>(t - 1) / (s[t - 1] - first);  // inf or NaN for T = 1 or ties: guesses miss
  auto add_batch = [&](const bool* ok, const int* cls, const T* p, const bool* y) {
    int u[kBatch];
    bool miss = false;
    bool missed[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      T g = (p[e] - first) * inv_step + T(1);
      g = g > T(0) ? g : T(0);  // a NaN guess becomes 0
      g = g < static_cast<T>(t) ? g : static_cast<T>(t);
      u[e] = static_cast<int>(g);
      if (u[e] < t && s[u[e]] <= p[e]) {
        ++u[e];  // one low (a pred on a grid point, rounded down)
      } else if (u[e] > 0 && !(s[u[e] - 1] <= p[e])) {
        --u[e];  // one high
      }
      missed[e] = (u[e] > 0 && !(s[u[e] - 1] <= p[e])) || (u[e] < t && s[u[e]] <= p[e]);
      miss |= missed[e];
    }
    if (__any_sync(0xFFFFFFFFu, miss)) {
      int v[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) v[e] = 0;
      for (int b = top; b > 0; b >>= 1) {
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          const int q = v[e] + b;
          if (q <= t && s[q - 1] <= p[e]) v[e] = q;
        }
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) u[e] = missed[e] ? v[e] : u[e];
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (kShared) {
        add_shared(hist, ok[e], static_cast<uint32_t>(cls[e] * bins + u[e]), y[e]);
      } else {
        add_global(pos_g, neg_g, ok[e], static_cast<unsigned long long>(c0 + cls[e]) * bins + u[e], y[e]);
      }
    }
  };

  T p[kBatch];
  bool y[kBatch], ok[kBatch];
  int cls[kBatch];
  if (mode == kColumn) {
    // rows r0 + 4 v .. + 3 for v = tid, tid + threads, ...; r0 is a multiple of 4
    const int64_t steps = (r1 - r0 + 4 * kHistThreads - 1) / (4 * kHistThreads);
#pragma unroll
    for (int e = 0; e < kBatch; ++e) cls[e] = 0;
    for (int64_t k0 = 0; k0 < steps; k0 += kUnroll) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int64_t r = r0 + 4 * (tid + (k0 + i) * kHistThreads);
        if (r + 3 < r1) {
          load4(preds + r, p + 4 * i);
          load4(target + r, y + 4 * i);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[4 * i + e] = r + e < r1 ? preds[r + e] : T(0);
            y[4 * i + e] = r + e < r1 && target[r + e] > 0;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[4 * i + e] = r + e < r1;
      }
      add_batch(ok, cls, p, y);
    }
  } else if (mode == kQuads) {
    // ct / 4 threads per row, each loading 4 classes
    const int quads = ct / 4;
    const int q = tid % quads;
    const int rps = kHistThreads / quads;
    const int rsub = tid / quads;
    const bool mine = rsub < rps && 4 * q < tile;
    const int64_t steps = (r1 - r0 + rps - 1) / rps;
#pragma unroll
    for (int e = 0; e < kBatch; ++e) cls[e] = 4 * q + e % 4;
    for (int64_t k0 = 0; k0 < steps; k0 += kUnroll) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int64_t r = r0 + rsub + (k0 + i) * rps;
        const bool in = mine && k0 + i < steps && r < r1;
        if (in) {
          load4(preds + r * c + c0 + 4 * q, p + 4 * i);
          load4(target + r * c + c0 + 4 * q, y + 4 * i);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[4 * i + e] = T(0), y[4 * i + e] = false;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[4 * i + e] = in;
      }
      add_batch(ok, cls, p, y);
    }
  } else {
    const int cc = tid % ct;
    const int rps = kHistThreads / ct;
    const int rsub = tid / ct;
    const bool mine = rsub < rps && cc < tile;
    const int64_t steps = (r1 - r0 + rps - 1) / rps;
#pragma unroll
    for (int e = 0; e < kBatch; ++e) cls[e] = cc;
    for (int64_t k0 = 0; k0 < steps; k0 += kBatch) {
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int64_t r = r0 + rsub + (k0 + e) * rps;
        ok[e] = mine && k0 + e < steps && r < r1;
        p[e] = ok[e] ? preds[r * c + c0 + cc] : T(0);
        y[e] = ok[e] && target[r * c + c0 + cc] > 0;
      }
      add_batch(ok, cls, p, y);
    }
  }

  if (kShared) {
    __syncthreads();
    if (cluster) {
      finish_in_cluster(hist, reinterpret_cast<uint32_t*>(hist) + ct * bins, lbs, c, c0, tile, t, out);
      return;
    }
    // classes c0 .. c0 + tile of partials row blockIdx.y are contiguous
    uint32_t* row = partials + (static_cast<int64_t>(blockIdx.y) * c + c0) * bins;
    for (int i = tid; i < tile * bins; i += kHistThreads) row[i] = hist[i];
  }
}

constexpr int kFinishSmemBins = 1024;  // totals of up to this many bins stay in shared memory

// Per class: totals per bin (from the partial rows, or already in pos_g /
// neg_g), suffix sums in place, then the four counts of each threshold. The
// totals live in shared memory when there are at most kFinishSmemBins bins,
// else in pos_g / neg_g, which are then read back after this block wrote
// them, so they are neither const nor __restrict__.
template <bool kPartials, bool kSmem>
__global__ void __launch_bounds__(kFinishThreads) binned_finish_kernel(
    const uint32_t* __restrict__ partials, int64_t chunks, int64_t c, int t, const int32_t* __restrict__ lb,
    unsigned long long* pos_g, unsigned long long* neg_g, long long* __restrict__ out) {
  __shared__ unsigned long long red[2][kFinishThreads];
  __shared__ unsigned long long tot[kSmem ? 2 * kFinishSmemBins : 1];
  const int tid = threadIdx.x;
  const int bins = t + 1;
  const int lb0 = tid < t ? lb[tid] : 0;  // the first threshold this thread writes
  for (int64_t cls = blockIdx.x; cls < c; cls += gridDim.x) {
    unsigned long long* P = kSmem ? tot : pos_g + cls * bins;
    unsigned long long* Q = kSmem ? tot + kFinishSmemBins : neg_g + cls * bins;
    if (kPartials) {
      const int span = bins < kFinishThreads ? bins : kFinishThreads;
      const int groups = kFinishThreads / span;
      const int g = tid / span;
      const int bl = tid % span;
      for (int b0 = 0; b0 < bins; b0 += span) {
        const int b = b0 + bl;
        unsigned long long ap = 0, an = 0;
        if (g < groups && b < bins) {
          const uint32_t* col = partials + cls * bins + b;
#pragma unroll 8
          for (int64_t y = g; y < chunks; y += groups) {
            const uint32_t v = col[y * c * bins];
            ap += v >> 16;
            an += v & 0xFFFFu;
          }
        }
        red[0][tid] = ap, red[1][tid] = an;
        __syncthreads();
        if (g == 0 && b < bins) {
          for (int k = 1; k < groups; ++k) ap += red[0][k * span + bl], an += red[1][k * span + bl];
          P[b] = ap, Q[b] = an;
        }
        __syncthreads();
      }
    } else if (kSmem) {
      for (int b = tid; b < bins; b += kFinishThreads) {
        P[b] = __ldcg(pos_g + cls * bins + b);
        Q[b] = __ldcg(neg_g + cls * bins + b);
      }
      __syncthreads();
    }
    suffix_counts<unsigned long long, !kSmem>(P, Q, t, lb, lb0, c, cls, out);
  }
}

// How a call is cut into blocks, and where its scratch goes.
struct Plan {
  bool shared;        // block histograms in shared memory (else the 64-bit histogram in the scratch)
  bool rank_kernel;   // thresholds ranked by rank_thresholds_kernel (else by each block)
  int ct;             // classes per block
  int64_t rows_chunk; // rows per block, a multiple of 4, when the blocks store partial rows
  int64_t chunks;
  size_t smem;
  bool cluster;       // one cluster of cluster_chunks blocks per class tile may finish the counts itself
  int64_t cluster_rows, cluster_chunks;
  size_t cluster_smem;
  size_t off_lb, off_sorted, off_partials, bytes;  // scratch layout; the 64-bit histogram is at 0
};

Plan plan_binned(int64_t n, int64_t c, int64_t t, size_t elem) {
  Plan pl{};
  const int64_t bins = t + 1;
  const size_t s_bytes = align16(elem * t);
  // a block that ranks the thresholds keeps them as given and its own lb
  const size_t rank_bytes = t <= kRankInBlock ? align16(elem * t) + align16(sizeof(int32_t) * t) : 0;
  auto smem = [&](int64_t ct) { return s_bytes + rank_bytes + static_cast<size_t>(ct) * bins * 4; };
  int64_t ct = c < kMaxTile ? c : kMaxTile;
  if (ct < 1) ct = 1;
  while (ct > 1 && smem(ct) > kTileSmem) ct /= 2;
  pl.shared = smem(ct) <= kMaxHistSmem;
  const int64_t tiles = (c + ct - 1) / ct;
  const int64_t min_rows = (kMinBlockElems + ct - 1) / ct;
  int64_t rows = (n * tiles + kTargetBlocks - 1) / kTargetBlocks;
  if (rows < min_rows) rows = min_rows;
  rows = (rows + 3) / 4 * 4;
  if (pl.shared && rows > kMaxChunkRows) rows = kMaxChunkRows;
  if (pl.shared && (n + rows - 1) / rows > kMaxRowChunks) pl.shared = false;
  if (!pl.shared) {
    const int64_t fit = ((n + kMaxRowChunks - 1) / kMaxRowChunks + 3) / 4 * 4;
    if (rows < fit) rows = fit;
  }
  pl.ct = static_cast<int>(ct);
  pl.rows_chunk = rows;
  pl.chunks = n > 0 ? (n + rows - 1) / rows : 0;
  pl.rank_kernel = !pl.shared || t > kRankInBlock;
  pl.smem = pl.shared ? smem(ct) - (pl.rank_kernel ? rank_bytes : 0) : 0;
  // the cluster path: at most kMaxCluster chunks of at most kClusterMaxRows
  // rows, plus 2 x bins words to sum a class into
  int64_t crows = (n + kMaxCluster - 1) / kMaxCluster;
  if (crows < min_rows) crows = min_rows;
  crows = (crows + 3) / 4 * 4;
  pl.cluster_rows = crows;
  pl.cluster_chunks = n > 0 ? (n + crows - 1) / crows : 0;
  pl.cluster_smem = pl.smem + 2 * sizeof(uint32_t) * bins;
  pl.cluster = pl.shared && crows <= kClusterMaxRows && pl.cluster_smem <= kMaxHistSmem;
  pl.off_lb = align16(2 * sizeof(unsigned long long) * c * bins);
  pl.off_sorted = pl.off_lb + align16(sizeof(int32_t) * t);
  pl.off_partials = pl.off_sorted + (pl.rank_kernel ? s_bytes : 0);
  pl.bytes = pl.off_partials + (pl.shared ? align16(sizeof(uint32_t) * pl.chunks * c * bins) : 0);
  return pl;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Lets the shared-memory histogram kernel take up to kMaxSmem of dynamic
// shared memory and run in clusters of more than 8 blocks, once per device
// (each call costs host time on every launch of a path that is host-bound).
// A card that refuses the cluster size refuses the cluster launch later,
// which then falls back to the partials path.
template <typename T>
cudaError_t prepare_hist_kernel(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ULL << (device & 63);
  if (done.load() & bit) return cudaSuccess;
  auto* kernel = binned_hist_kernel<T, true>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // the block's limit holds static and dynamic shared memory together
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem - attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess) {
    cudaGetLastError();
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

template <typename T>
int launch_binned_counts(int device, const void* preds, const void* target, const void* ths, int64_t n,
                         int64_t c, int64_t t, void* out, void* scratch, int64_t scratch_bytes, void* stream) {
  if (t < 1 || t > (1 << 29) || c < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto st = static_cast<cudaStream_t>(stream);
  if (c == 0) return static_cast<int>(cudaGetLastError());
  if (n == 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(long long) * 4 * c * t, st);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const Plan pl = plan_binned(n, c, t, sizeof(T));
  if (scratch_bytes < static_cast<int64_t>(pl.bytes)) return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  auto* pos_g = reinterpret_cast<unsigned long long*>(base);
  auto* neg_g = pos_g + c * (t + 1);
  auto* lb = reinterpret_cast<int32_t*>(base + pl.off_lb);
  T* sorted = pl.rank_kernel ? reinterpret_cast<T*>(base + pl.off_sorted) : nullptr;
  auto* partials = reinterpret_cast<uint32_t*>(base + pl.off_partials);
  const T* p = static_cast<const T*>(preds);
  const auto* y = static_cast<const int32_t*>(target);
  const T* th = static_cast<const T*>(ths);
  auto* o = static_cast<long long*>(out);
  const int ti = static_cast<int>(t);

  if (!pl.shared) {
    const cudaError_t err = cudaMemsetAsync(pos_g, 0, 2 * sizeof(unsigned long long) * c * (t + 1), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (pl.rank_kernel) {
    rank_thresholds_kernel<T><<<static_cast<unsigned>((t + kRankThreads - 1) / kRankThreads), kRankThreads, 0, st>>>(
        th, ti, sorted, lb);
  }
  int mode = kScalar;
  if (aligned16(preds) && aligned16(target)) {
    if (c == 1) {
      mode = kColumn;
    } else if (c % 4 == 0 && pl.ct % 4 == 0) {
      mode = kQuads;
    }
  }
  const int64_t tiles = (c + pl.ct - 1) / pl.ct;
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (!pl.shared) {
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(pl.chunks));
    binned_hist_kernel<T, false><<<grid, kHistThreads, 0, st>>>(p, y, th, sorted, n, c, ti, pl.ct, pl.rows_chunk,
                                                                mode, 0, lb, partials, pos_g, neg_g, o);
  } else {
    auto* kernel = binned_hist_kernel<T, true>;
    const cudaError_t prep = prepare_hist_kernel<T>(device);
    if (prep != cudaSuccess) return static_cast<int>(prep);
    if (pl.cluster) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(pl.cluster_chunks));
      cfg.blockDim = dim3(kHistThreads);
      cfg.dynamicSmemBytes = pl.cluster_smem;
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = static_cast<unsigned>(pl.cluster_chunks);
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaLaunchKernelEx(&cfg, kernel, p, y, th, static_cast<const T*>(sorted), n, c, ti, pl.ct, pl.cluster_rows,
                             mode, 1, lb, partials, pos_g, neg_g, o) == cudaSuccess) {
        return static_cast<int>(cudaGetLastError());
      }
      // a card that refuses the cluster (too large for its resources): clear
      // the error and take the partials path, which needs none
      cudaGetLastError();
    }
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(pl.chunks));
    kernel<<<grid, kHistThreads, pl.smem, st>>>(p, y, th, sorted, n, c, ti, pl.ct, pl.rows_chunk, mode, 0, lb,
                                                partials, pos_g, neg_g, o);
  }
  const unsigned fblocks = static_cast<unsigned>(c < kMaxFinishBlocks ? c : kMaxFinishBlocks);
  const bool small = t + 1 <= kFinishSmemBins;
  if (pl.shared && small) {
    binned_finish_kernel<true, true><<<fblocks, kFinishThreads, 0, st>>>(partials, pl.chunks, c, ti, lb, pos_g, neg_g, o);
  } else if (pl.shared) {
    binned_finish_kernel<true, false><<<fblocks, kFinishThreads, 0, st>>>(partials, pl.chunks, c, ti, lb, pos_g, neg_g, o);
  } else if (small) {
    binned_finish_kernel<false, true><<<fblocks, kFinishThreads, 0, st>>>(partials, pl.chunks, c, ti, lb, pos_g, neg_g, o);
  } else {
    binned_finish_kernel<false, false><<<fblocks, kFinishThreads, 0, st>>>(partials, pl.chunks, c, ti, lb, pos_g, neg_g, o);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kShared>
__global__ void binned_calibration_kernel(const float* __restrict__ conf, const float* __restrict__ acc,
                                          int64_t n, const float* __restrict__ bounds, int bins,
                                          unsigned long long* __restrict__ count, float* __restrict__ conf_sum,
                                          float* __restrict__ acc_sum) {
  extern __shared__ __align__(16) unsigned char cal_smem[];
  float* s_bounds = reinterpret_cast<float*>(cal_smem);  // bins + 1
  float* s_conf = s_bounds + bins + 1;                    // bins
  float* s_acc = s_conf + bins;                           // bins
  int* s_count = reinterpret_cast<int*>(s_acc + bins);    // bins
  const float* b = bounds;
  if (kShared) {
    for (int i = threadIdx.x; i <= bins; i += blockDim.x) s_bounds[i] = bounds[i];
    for (int i = threadIdx.x; i < bins; i += blockDim.x) {
      s_conf[i] = 0.0f;
      s_acc[i] = 0.0f;
      s_count[i] = 0;
    }
    __syncthreads();
    b = s_bounds;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float x = conf[i];
    int bin;
    if (x != x) {
      bin = bins - 1;  // NaN: the last bin
    } else {
      int lo = 0, hi = bins + 1;  // lo ends as the number of boundaries below x
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (b[mid] < x) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      bin = lo - 1;
      if (bin < 0) continue;  // x <= b[0]: no bin
      if (bin > bins - 1) bin = bins - 1;  // x > b[bins]: the last bin
    }
    const float a = acc[i];
    if (kShared) {
      atomicAdd(s_count + bin, 1);
      atomicAdd(s_conf + bin, x);
      atomicAdd(s_acc + bin, a);
    } else {
      atomicAdd(count + bin, 1ULL);
      atomicAdd(conf_sum + bin, x);
      atomicAdd(acc_sum + bin, a);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < bins; i += blockDim.x) {
      if (s_count[i]) {
        atomicAdd(count + i, static_cast<unsigned long long>(s_count[i]));
        atomicAdd(conf_sum + i, s_conf[i]);
        atomicAdd(acc_sum + i, s_acc[i]);
      }
    }
  }
}


constexpr int kCalThreadsPriv = 256;  // at K = 64, 3 x 64 private words per thread: 192 KB of shared memory
constexpr int kCalMaxCluster = 16;
constexpr int kCalBatch = 8;           // elements a thread holds at once (two quads)

// Dynamic shared memory of calibration_private_kernel: every thread's
// private words for `bins` bins.
constexpr size_t cal_private_smem(int bins) { return sizeof(uint32_t) * 3 * bins * kCalThreadsPriv; }

// Steps of the warp fold that halve the live values: while half of them is
// still a whole number of (count, conf, acc) triples, and at most 5 (the
// lane bits).
__host__ __device__ constexpr int cal_halvings(int v) {
  int s = 0;
  while (s < 5 && v % 2 == 0 && (v / 2) % 3 == 0) v /= 2, ++s;
  return s;
}

// The two halves of a cluster barrier: arrive (without ordering memory)
// early, wait later, so that the wait, the proof that every block of the
// cluster has started, seldom stalls. All threads of the block call both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;" ::: "memory"); }

// The sum of two packed values of kind k: 0 a count, else float32 bits.
__device__ __forceinline__ uint32_t cal_add(uint32_t a, uint32_t b, int k) {
  return k == 0 ? a + b : __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
}

// One halving step of the warp fold and the steps after it: the lane whose
// `kBit` is set keeps the upper half of the live values, its partner the
// lower, and each adds the partner's copy of the half it keeps; the live
// values move to the front of v and `lo` tracks where they sit in the
// full array. Every half is a multiple of 3, so a value's kind is i % 3.
template <int kH, int kBit, int kSteps>
__device__ __forceinline__ void cal_halve(uint32_t* v, int lane, int& lo) {
  if constexpr (kSteps > 0) {
    const bool upper = lane & kBit;
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const uint32_t got = __shfl_xor_sync(0xFFFFFFFFu, upper ? v[i] : v[i + kH], kBit);
      v[i] = cal_add(upper ? v[i + kH] : v[i], got, i % 3);
    }
    lo += upper ? kH : 0;
    cal_halve<kH / 2, kBit / 2, kSteps - 1>(v, lane, lo);
  }
}

// Per-bin (count, conf sum, acc sum) of B <= K bins (see the design note
// above). Value j of a thread (bin j / 3, kind j % 3) lives at word
// j * 256 + t of shared memory: a thread's adds touch only its own bank,
// whatever bins its elements fall in. kGrid: the blocks fold through
// `partials` after a grid barrier (a cooperative launch); else the grid is
// one cluster and folds through distributed shared memory.
template <int K, bool kGrid>
__global__ void __launch_bounds__(kCalThreadsPriv) calibration_private_kernel(
    const float* __restrict__ conf, const float* __restrict__ acc, int64_t n, const float* __restrict__ bounds,
    int bins, int vec, long long* __restrict__ count, float* __restrict__ conf_sum, float* __restrict__ acc_sum,
    uint32_t* __restrict__ partials) {
  namespace cg = cooperative_groups;
  constexpr int T = kCalThreadsPriv;
  constexpr int V = 3 * K;
  constexpr int S = cal_halvings(V);
  constexpr int kLive = V >> S;
  extern __shared__ __align__(16) uint32_t cal_priv[];
  __shared__ float s_b[K + 1];
  __shared__ uint32_t warp_part[T / 32][V];
  __shared__ uint32_t gathered[kGrid ? 1 : kCalMaxCluster][V];  // block 0's: every block's values
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int vals = 3 * bins;
  if (!kGrid) cluster_arrive();
  uint32_t* mine = cal_priv + tid;
  for (int j = 0; j < vals; ++j) mine[j * T] = 0u;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * T;
  // two quads a trip, the next trip's loads in flight while this one's
  // elements are added; the first trip's are issued before the boundaries
  // are published
  auto load = [&](int64_t q0, float* x, float* a, bool* ok) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t e0 = 4 * (q0 + h * stride);
      if (vec && e0 + 3 < n) {
        const float4 cx = *reinterpret_cast<const float4*>(conf + e0);
        const float4 ax = *reinterpret_cast<const float4*>(acc + e0);
        x[4 * h] = cx.x, x[4 * h + 1] = cx.y, x[4 * h + 2] = cx.z, x[4 * h + 3] = cx.w;
        a[4 * h] = ax.x, a[4 * h + 1] = ax.y, a[4 * h + 2] = ax.z, a[4 * h + 3] = ax.w;
#pragma unroll
        for (int j = 0; j < 4; ++j) ok[4 * h + j] = true;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ok[4 * h + j] = e0 + j < n;
          x[4 * h + j] = ok[4 * h + j] ? conf[e0 + j] : 0.0f;
          a[4 * h + j] = ok[4 * h + j] ? acc[e0 + j] : 0.0f;
        }
      }
    }
  };
  int64_t q0 = static_cast<int64_t>(blockIdx.x) * T + tid;
  float x[kCalBatch], a[kCalBatch];
  bool ok[kCalBatch];
  load(q0, x, a, ok);
  for (int i = tid; i <= bins; i += T) s_b[i] = bounds[i];
  __syncthreads();
  const int top = 1 << (31 - __clz(bins + 1));  // the largest power of 2 <= bins + 1
  for (; q0 < quads; q0 += 2 * stride) {
    float xn[kCalBatch], an[kCalBatch];
    bool okn[kCalBatch];
    load(q0 + 2 * stride, xn, an, okn);
    // #{i <= B : b[i] < x}, by binary lifting over the sorted boundaries,
    // the batch in lockstep and without branches (a load under a branch
    // waits for the one before it: the search took most of the kernel's time)
    int pos[kCalBatch];
#pragma unroll
    for (int e = 0; e < kCalBatch; ++e) pos[e] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int e = 0; e < kCalBatch; ++e) {
        const int q = pos[e] + step;
        const bool below = s_b[(q <= bins + 1 ? q : bins + 1) - 1] < x[e];
        pos[e] += q <= bins + 1 && below ? step : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < kCalBatch; ++e) {
      // bin pos - 1: none for x <= b[0]; the last for x > b[B] and for NaN
      const int bin = x[e] != x[e] || pos[e] > bins ? bins - 1 : pos[e] - 1;
      if (ok[e] && bin >= 0) {
        uint32_t* v = mine + 3 * bin * T;
        v[0] += 1;
        v[T] = __float_as_uint(__uint_as_float(v[T]) + x[e]);
        v[2 * T] = __float_as_uint(__uint_as_float(v[2 * T]) + a[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kCalBatch; ++e) x[e] = xn[e], a[e] = an[e], ok[e] = okn[e];
  }

  // the thread's words into registers, then the warp's fold by halving:
  // 3 K shuffles in all, not the 15 K of a butterfly over every value
  uint32_t v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = j < vals ? mine[j * T] : 0u;
  int lo = 0;
  cal_halve<V / 2, 16, S>(v, lane, lo);
  // lanes that differ only in the bits below the halvings' hold the same
  // values: add them pairwise (a + b and b + a are the same float)
#pragma unroll
  for (int bit = 16 >> S; bit > 0; bit >>= 1) {
#pragma unroll
    for (int i = 0; i < kLive; ++i) v[i] = cal_add(v[i], __shfl_xor_sync(0xFFFFFFFFu, v[i], bit), i % 3);
  }
  if ((lane & ((32 >> S) - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kLive; ++i) warp_part[warp][lo + i] = v[i];
  }
  __syncthreads();
  uint32_t t_part = 0;  // the block's value tid
  if (tid < vals) {
    t_part = warp_part[0][tid];
#pragma unroll
    for (int w = 1; w < T / 32; ++w) t_part = cal_add(t_part, warp_part[w][tid], tid % 3);
  }
  auto write = [&](int j, unsigned long long c64, float f) {
    const int i = j / 3;
    if (j % 3 == 0) {
      count[i] = static_cast<long long>(c64);
    } else if (j % 3 == 1) {
      conf_sum[i] = f;
    } else {
      acc_sum[i] = f;
    }
  };
  if constexpr (kGrid) {
    __shared__ unsigned long long red_c[T];
    __shared__ float red_f[T];
    cg::grid_group grid = cg::this_grid();
    if (tid < vals) partials[static_cast<int64_t>(blockIdx.x) * vals + tid] = t_part;
    grid.sync();
    // block b folds values b, b + G, ... over the blocks: its threads over
    // strided blocks, then a fixed tree
    for (int j = blockIdx.x; j < vals; j += gridDim.x) {
      unsigned long long c64 = 0;
      float f = 0.0f;
      for (int b = tid; b < static_cast<int>(gridDim.x); b += T) {
        const uint32_t q = __ldcg(partials + static_cast<int64_t>(b) * vals + j);
        c64 += q;
        f += __uint_as_float(q);
      }
      red_c[tid] = c64, red_f[tid] = f;
      __syncthreads();
      for (int off = T / 2; off > 0; off >>= 1) {
        if (tid < off) red_c[tid] += red_c[tid + off], red_f[tid] += red_f[tid + off];
        __syncthreads();
      }
      if (tid == 0) write(j, red_c[0], red_f[0]);
      __syncthreads();
    }
  } else {
    // every block stores its values into block 0's shared memory (once all
    // blocks have started, as a cluster's shared memory requires), one
    // barrier, and block 0 folds them in block order and writes the outputs
    cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    const int ranks = static_cast<int>(cl.num_blocks());
    cluster_wait();
    if (tid < vals) cl.map_shared_rank(&gathered[0][0], 0)[rank * V + tid] = t_part;
    cl.sync();
    if (rank == 0 && tid < vals) {
      unsigned long long c64 = 0;
      float f = __uint_as_float(gathered[0][tid]);
      for (int q = 0; q < ranks; ++q) c64 += gathered[q][tid];
      for (int q = 1; q < ranks; ++q) f += __uint_as_float(gathered[q][tid]);
      write(tid, c64, f);
    }
  }
}

// Lets both instances for K take the dynamic shared memory of K bins, and
// the cluster instance run in clusters of up to 16 blocks, once per device.
template <int K>
cudaError_t prepare_calibration(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ULL << (device & 63);
  if (done.load() & bit) return cudaSuccess;
  const int smem = static_cast<int>(cal_private_smem(K));
  auto* cluster = calibration_private_kernel<K, false>;
  auto* grid = calibration_private_kernel<K, true>;
  cudaError_t err = cudaFuncSetAttribute(cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(grid, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

// Resident blocks of the cooperative instance for `bins` on the device (its
// grid), queried once per device and bin count; 0 on an error.
template <int K>
int cal_grid_blocks(int device, int bins) {
  static std::atomic<int> cached[64][K + 1];
  std::atomic<int>& slot = cached[device & 63][bins];
  int blocks = slot.load();
  if (blocks > 0) return blocks;
  int per_sm = 0, sms = 0;
  if (prepare_calibration<K>(device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, calibration_private_kernel<K, true>, kCalThreadsPriv,
                                                    cal_private_smem(bins)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  blocks = per_sm * sms;
  slot.store(blocks);
  return blocks;
}

int cal_grid_blocks(int device, int regs, int bins) {
  return regs == 16 ? cal_grid_blocks<16>(device, bins)
         : regs == 32 ? cal_grid_blocks<32>(device, bins)
                      : cal_grid_blocks<64>(device, bins);
}

template <int K>
cudaError_t launch_calibration_private(int route, int device, const float* conf, const float* acc, int64_t n,
                                       const float* bounds, int bins, int vec, long long* count, float* conf_sum,
                                       float* acc_sum, uint32_t* partials, int64_t scratch_bytes, cudaStream_t st) {
  const cudaError_t prep = prepare_calibration<K>(device);
  if (prep != cudaSuccess) return prep;
  const int64_t quads = (n + 3) / 4;
  int64_t blocks = (quads + kCalThreadsPriv - 1) / kCalThreadsPriv;  // a quad per thread
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kCalThreadsPriv);
  cfg.dynamicSmemBytes = cal_private_smem(bins);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  if (route == 2) {
    const int resident = cal_grid_blocks<K>(device, bins);
    if (resident < 1) return cudaErrorInvalidValue;
    if (blocks > resident) blocks = resident;
    if (blocks < 1) blocks = 1;
    if (scratch_bytes < static_cast<int64_t>(sizeof(uint32_t)) * 3 * bins * blocks) return cudaErrorInvalidValue;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    return cudaLaunchKernelEx(&cfg, calibration_private_kernel<K, true>, conf, acc, n, bounds, bins, vec, count,
                              conf_sum, acc_sum, partials);
  }
  if (blocks > kCalMaxCluster) blocks = kCalMaxCluster;
  if (blocks < 1) blocks = 1;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.numAttrs = blocks > 1;  // one block is a cluster of its own, and launches sooner without the attribute
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  return cudaLaunchKernelEx(&cfg, calibration_private_kernel<K, false>, conf, acc, n, bounds, bins, vec, count,
                            conf_sum, acc_sum, partials);
}

}  // namespace

extern "C" {

// Bytes of scratch mt_binned_counts_f32 (elem = 4) or _f64 (elem = 8) needs.
int64_t mt_binned_counts_scratch_bytes(int64_t n, int64_t c, int64_t t, int64_t elem) {
  if (n <= 0 || c <= 0 || t < 1) return 0;
  return static_cast<int64_t>(plan_binned(n, c, t, static_cast<size_t>(elem)).bytes);
}

// preds: float32 [n, c] row-major; target: int32 [n, c] (positive means > 0);
// ths: float32 [t], any order; out: int64 [4, c, t] (TP, FP, FN, TN), fully
// written; scratch: mt_binned_counts_scratch_bytes(n, c, t, 4) bytes, 8-byte
// aligned, in any state.
int mt_binned_counts_f32(int device, const void* preds, const void* target, const void* ths, int64_t n,
                         int64_t c, int64_t t, void* out, void* scratch, int64_t scratch_bytes, void* stream) {
  return launch_binned_counts<float>(device, preds, target, ths, n, c, t, out, scratch, scratch_bytes, stream);
}

// As mt_binned_counts_f32, with preds and ths float64.
int mt_binned_counts_f64(int device, const void* preds, const void* target, const void* ths, int64_t n,
                         int64_t c, int64_t t, void* out, void* scratch, int64_t scratch_bytes, void* stream) {
  return launch_binned_counts<double>(device, preds, target, ths, n, c, t, out, scratch, scratch_bytes, stream);
}

// Bytes of scratch mt_binned_calibration needs on `device` for `route`,
// `regs` and `bins` (route 2's partials; none on the other routes); -1 on
// an error.
int64_t mt_binned_calibration_scratch_bytes(int device, int route, int regs, int64_t bins) {
  if (route != 2) return 0;
  if (bins < 1 || bins > regs || (regs != 16 && regs != 32 && regs != 64)) return -1;
  const int blocks = cal_grid_blocks(device, regs, static_cast<int>(bins));
  return blocks < 1 ? -1 : static_cast<int64_t>(sizeof(uint32_t)) * 3 * bins * blocks;
}

// conf, acc: float32 [n]; bounds: float32 [bins + 1], ascending; out: count
// int64 [bins], then conf_sum and acc_sum float32 [bins], fully written.
// route 0: the atomics kernel (any bins; the outputs are zeroed here first);
// 1: calibration_private_kernel as one cluster; 2: as a cooperative grid
// with `scratch` (mt_binned_calibration_scratch_bytes). On routes 1 and 2,
// regs is its K (16, 32 or 64, at least bins) and n below 2^31. vec:
// 16-byte loads (both inputs 16-byte aligned).
int mt_binned_calibration(int device, const void* conf, const void* acc, const void* bounds, int64_t n, int64_t bins,
                          int route, int regs, int vec, void* out, void* scratch, int64_t scratch_bytes,
                          void* stream) {
  if (bins < 1 || bins > 0x7FFFFFF || n < 0 || route < 0 || route > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (route && (bins > regs || (regs != 16 && regs != 32 && regs != 64) || n >= (int64_t{1} << 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const float* cf = static_cast<const float*>(conf);
  const float* ac = static_cast<const float*>(acc);
  const float* bd = static_cast<const float*>(bounds);
  auto* cnt = static_cast<long long*>(out);
  auto* cs = reinterpret_cast<float*>(cnt + bins);
  auto* as = cs + bins;
  const auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(bins);
  if (route) {
    auto* launch = regs == 16   ? launch_calibration_private<16>
                   : regs == 32 ? launch_calibration_private<32>
                                : launch_calibration_private<64>;
    const cudaError_t err = launch(route, device, cf, ac, n, bd, b, vec, cnt, cs, as, static_cast<uint32_t*>(scratch),
                                   scratch_bytes, s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const cudaError_t zero = cudaMemsetAsync(out, 0, 16 * bins, s);
  if (zero != cudaSuccess) return static_cast<int>(zero);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* ucnt = reinterpret_cast<unsigned long long*>(cnt);
  int64_t blocks = (n + kCalThreads - 1) / kCalThreads;
  if (blocks > kCalMaxBlocks) blocks = kCalMaxBlocks;
  const size_t smem = sizeof(float) * (bins + 1) + (2 * sizeof(float) + sizeof(int)) * bins;
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(binned_calibration_kernel<true>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    binned_calibration_kernel<true><<<static_cast<unsigned>(blocks), kCalThreads, smem, s>>>(cf, ac, n, bd, b,
                                                                                          ucnt, cs, as);
  } else {
    binned_calibration_kernel<false><<<static_cast<unsigned>(blocks), kCalThreads, 0, s>>>(cf, ac, n, bd, b,
                                                                                        ucnt, cs, as);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
