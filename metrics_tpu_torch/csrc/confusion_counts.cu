// Confusion counts for ConfusionMatrix, multiclass and multilabel.
//
// confusion_counts replaces metrics_tpu/ops/confusion_counts.py
// `_confusion_kernel` (wrapper `_confusion_counts_pallas`):
//   confmat[t, p] = #{n : target[n] = t, preds[n] = p}, indices outside [0, C)
//   dropped.
//   Bound on an H100: bytes. It reads two int64 index vectors once and the
//   wrapper zero-fills the int64 [C, C] output (at N = 8192, C = 1000: 131 KB
//   read, 8 MB written, about 2.5 us at 3.35 TB/s); the work is N adds.
//   Design: the TPU kernel built one-hot tiles in VMEM and contracted them on
//   the MXU because a TPU has no scatter hardware. Hopper has native global
//   atomics, so each thread takes one sample (grid-stride loop, coalesced
//   reads) and adds 1 to its cell with a 64-bit atomicAdd. Cells are spread
//   over C*C addresses, so contention stays low unless the data is skewed.
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
constexpr int kMlThreads = 256;
constexpr int kMlTile = 16;       // columns per block: 4 lanes of 4, or up to 16 lanes of 1
constexpr int kMlUnroll = 8;      // row steps whose loads are in flight before any is used
constexpr int kMlMaxCluster = 16;  // chunks of a tile, one cluster (more than 8 is not portable)

__global__ void confusion_counts_kernel(const int64_t* __restrict__ target,
                                        const int64_t* __restrict__ preds, int64_t n,
                                        int64_t c, unsigned long long* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t t = target[i];
    const int64_t p = preds[i];
    if (t >= 0 && t < c && p >= 0 && p < c) {
      atomicAdd(out + t * c + p, 1ULL);
    }
  }
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
    const int32_t* __restrict__ preds, const int32_t* __restrict__ target, int64_t n, int64_t c, int lanes,
    int64_t rows_chunk, long long* __restrict__ out) {
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
        load_cols(preds + ru * c + col, p[u]);
        load_cols(target + ru * c + col, t[u]);
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

// Lets `kernel` (instance `which`: 0 or 1) run in clusters of more than 8
// blocks, once per device: each call costs host time on every launch of a
// path that is host-bound.
template <typename K>
cudaError_t allow_large_clusters(K* kernel, int device, int which) {
  static std::atomic<unsigned long long> done[2];
  const unsigned long long bit = 1ULL << (device & 63);
  if (done[which].load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  done[which].fetch_or(bit);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out: int64 [c, c], zeroed by the caller.
int mt_confusion_counts(int device, const void* target, const void* preds, int64_t n, int64_t c,
                        void* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    confusion_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(target), static_cast<const int64_t*>(preds), n, c,
        static_cast<unsigned long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// preds, target: int32 [n, c] row-major; lanes: lanes per row (a power of
// 2, at most 16, or at most 4 with vec); vec: 16-byte loads of 4 columns
// (C % 4 == 0, both inputs 16-byte aligned); out: int64 [c, 2, 2]
// [[tn, fp], [fn, tp]], fully written.
int mt_multilabel_counts(int device, const void* preds, const void* target, int64_t n, int64_t c, int lanes,
                         int vec, void* out, void* stream) {
  const int e = vec ? 4 : 1;
  if (n < 0 || c < 0 || lanes < 1 || lanes * e > kMlTile || (lanes & (lanes - 1)) || (vec && c % 4)) {
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
  auto* kernel = vec ? multilabel_counts_kernel<4> : multilabel_counts_kernel<1>;
  const cudaError_t prep = allow_large_clusters(kernel, device, vec);
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
                                                static_cast<const int32_t*>(target), n, c, lanes, rows,
                                                static_cast<long long*>(out));
  return static_cast<int>(launch != cudaSuccess ? launch : cudaGetLastError());
}

}  // extern "C"
