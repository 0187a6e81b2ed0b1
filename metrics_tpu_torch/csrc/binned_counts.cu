// Streaming binned counters for the curve and calibration metrics.
//
// binned_counts replaces metrics_tpu/ops/binned_counts.py
// `_binned_counts_kernel` (wrapper `_binned_counts_pallas`):
//   TP[c, t] = #{n : preds[n, c] >= th[t], target[n, c] > 0}
//   FP[c, t] = #{n : preds[n, c] >= th[t], target[n, c] <= 0}
//   pos[c]   = #{n : target[n, c] > 0}
//   and the wrapper finishes FN = pos - TP, TN = (N - pos) - FP. The compare
//   runs in the type the wrapper gives (float32, or float64 when preds or
//   thresholds are float64), so a NaN pred is below every threshold, and
//   thresholds may come in any order and repeat.
//   Bound on an H100: operations. N*C*T compares against N*C reads (at
//   [8192, 80], T = 200: 131M compares, 5.3 MB read).
//   Design: the TPU kernel kept four [C, T] accumulators resident in VMEM
//   across a sequential grid. CUDA blocks run in no order, so each thread
//   owns one class and 4 neighbouring thresholds (its "item"), holds those
//   thresholds and its TP/FP counts in registers, and walks rows. A block
//   holds up to 256 items; when there are fewer (one class, T = 200 gives
//   50), several threads share an item and take interleaved rows. The grid's
//   y axis cuts the rows into chunks of at least 512. At the end the block
//   folds its threads' counts in shared memory and adds them to the int64
//   outputs with one 64-bit atomic per (class, threshold) and chunk. Threads
//   of a warp mostly share a class, so each row's pred and target load is one
//   broadcast. A sorted-threshold histogram would need N*C*log T work; that is
//   a later step.
//
// binned_calibration replaces metrics_tpu/ops/binned_counts.py
// `_binned_calibration_kernel` (wrapper `_binned_calibration_pallas`):
//   per-bin (count, conf_sum, acc_sum) over B bins of sorted boundaries b:
//   bin i holds b[i] < conf <= b[i+1]; conf <= b[0] falls in no bin; conf above
//   b[B] and NaN land in the last bin (the rule of the JAX package's XLA
//   composition, which its users run; its Pallas body drops such values).
//   Bound on an H100: bytes (two float32 vectors read once).
//   Design: a grid-stride loop; each thread finds its bin by binary search
//   over the boundaries, held in shared memory, and adds to a block histogram
//   in shared memory (int counts, float sums) with shared atomics; the block
//   then adds its non-empty bins to the outputs with global atomics. When the
//   boundaries and histogram do not fit in shared memory (past about 14,000
//   bins) the same loop adds straight to the outputs. Float atomics add in an
//   order that changes from run to run, so the sums match the plain version
//   within 1e-5 relative, not bit for bit; the counts are exact.
//
// The kernels allocate nothing and launch on the caller's stream and device;
// outputs are zeroed by the caller, and every C entry returns
// cudaGetLastError() so a refused launch is reported.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThPerItem = 4;  // thresholds one thread compares each row against
constexpr int64_t kMinRowsPerChunk = 512;
constexpr int64_t kMaxRowChunks = 65535;  // gridDim.y limit
constexpr int kCalThreads = 256;
constexpr int kCalMaxBlocks = 132 * 4;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__global__ void binned_counts_kernel(const T* __restrict__ preds, const int32_t* __restrict__ target,
                                     const T* __restrict__ ths, int64_t n, int64_t c, int64_t t,
                                     int items_per_block, int64_t rows_per_chunk,
                                     unsigned long long* __restrict__ tp,
                                     unsigned long long* __restrict__ fp,
                                     unsigned long long* __restrict__ pos) {
  // per item: kThPerItem TP counts, kThPerItem FP counts, one positive count
  __shared__ int folded[kThreads * (2 * kThPerItem + 1)];
  const int local = threadIdx.x % items_per_block;
  const int sub = threadIdx.x / items_per_block;
  const int subs = blockDim.x / items_per_block;
  const int64_t groups = (t + kThPerItem - 1) / kThPerItem;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * items_per_block + local;
  const bool active = sub < subs && item < c * groups;

  for (int i = threadIdx.x; i < items_per_block * (2 * kThPerItem + 1); i += blockDim.x) folded[i] = 0;
  __syncthreads();

  if (active) {
    const int64_t cls = item / groups;
    const int64_t t0 = (item % groups) * kThPerItem;
    T th[kThPerItem];
#pragma unroll
    for (int k = 0; k < kThPerItem; ++k) th[k] = ths[t0 + k < t ? t0 + k : t - 1];  // a spare slot is never written
    int tp_n[kThPerItem] = {0};
    int fp_n[kThPerItem] = {0};
    int pos_n = 0;
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
    const int64_t r1 = r0 + rows_per_chunk < n ? r0 + rows_per_chunk : n;
#pragma unroll 4
    for (int64_t r = r0 + sub; r < r1; r += subs) {
      const T p = preds[r * c + cls];
      const int y = target[r * c + cls] > 0;
      pos_n += y;
#pragma unroll
      for (int k = 0; k < kThPerItem; ++k) {
        const int above = p >= th[k];  // false for a NaN pred or threshold
        tp_n[k] += above & y;
        fp_n[k] += above & (y ^ 1);
      }
    }
    int* slot = folded + local * (2 * kThPerItem + 1);
#pragma unroll
    for (int k = 0; k < kThPerItem; ++k) {
      if (tp_n[k]) atomicAdd(slot + k, tp_n[k]);
      if (fp_n[k]) atomicAdd(slot + kThPerItem + k, fp_n[k]);
    }
    if (t0 == 0 && pos_n) atomicAdd(slot + 2 * kThPerItem, pos_n);
  }
  __syncthreads();

  if (active && sub == 0) {
    const int64_t cls = item / groups;
    const int64_t t0 = (item % groups) * kThPerItem;
    const int* slot = folded + local * (2 * kThPerItem + 1);
    for (int k = 0; k < kThPerItem && t0 + k < t; ++k) {
      if (slot[k]) atomicAdd(tp + cls * t + t0 + k, static_cast<unsigned long long>(slot[k]));
      if (slot[kThPerItem + k]) atomicAdd(fp + cls * t + t0 + k, static_cast<unsigned long long>(slot[kThPerItem + k]));
    }
    if (t0 == 0 && slot[2 * kThPerItem]) atomicAdd(pos + cls, static_cast<unsigned long long>(slot[2 * kThPerItem]));
  }
}

template <typename T>
int launch_binned_counts(int device, const void* preds, const void* target, const void* ths, int64_t n,
                         int64_t c, int64_t t, void* tp, void* fp, void* pos, void* stream) {
  if (t < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0 && c > 0) {
    const int64_t items = c * ((t + kThPerItem - 1) / kThPerItem);
    const int items_per_block = items < kThreads ? static_cast<int>(items) : kThreads;
    const int threads = (kThreads / items_per_block) * items_per_block;
    int64_t rows_per_chunk = (n + kMaxRowChunks - 1) / kMaxRowChunks;
    if (rows_per_chunk < kMinRowsPerChunk) rows_per_chunk = kMinRowsPerChunk;
    const int64_t x_blocks = (items + items_per_block - 1) / items_per_block;
    if (x_blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(x_blocks),
                    static_cast<unsigned>((n + rows_per_chunk - 1) / rows_per_chunk));
    binned_counts_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(preds), static_cast<const int32_t*>(target), static_cast<const T*>(ths), n, c,
        t, items_per_block, rows_per_chunk, static_cast<unsigned long long*>(tp),
        static_cast<unsigned long long*>(fp), static_cast<unsigned long long*>(pos));
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

}  // namespace

extern "C" {

// preds: float32 [n, c] row-major; target: int32 [n, c] (positive means > 0);
// ths: float32 [t]; tp, fp: int64 [c, t] and pos: int64 [c], zeroed by the caller.
int mt_binned_counts_f32(int device, const void* preds, const void* target, const void* ths, int64_t n,
                         int64_t c, int64_t t, void* tp, void* fp, void* pos, void* stream) {
  return launch_binned_counts<float>(device, preds, target, ths, n, c, t, tp, fp, pos, stream);
}

// As mt_binned_counts_f32, with preds and ths float64.
int mt_binned_counts_f64(int device, const void* preds, const void* target, const void* ths, int64_t n,
                         int64_t c, int64_t t, void* tp, void* fp, void* pos, void* stream) {
  return launch_binned_counts<double>(device, preds, target, ths, n, c, t, tp, fp, pos, stream);
}

// conf, acc: float32 [n]; bounds: float32 [bins + 1], ascending; count: int64
// [bins], conf_sum and acc_sum: float32 [bins], all zeroed by the caller.
int mt_binned_calibration(int device, const void* conf, const void* acc, const void* bounds, int64_t n,
                          int64_t bins, void* count, void* conf_sum, void* acc_sum, void* stream) {
  if (bins < 1 || bins > 0x7FFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int64_t blocks = (n + kCalThreads - 1) / kCalThreads;
  if (blocks > kCalMaxBlocks) blocks = kCalMaxBlocks;
  const size_t smem = sizeof(float) * (bins + 1) + (2 * sizeof(float) + sizeof(int)) * bins;
  const int b = static_cast<int>(bins);
  const float* cf = static_cast<const float*>(conf);
  const float* ac = static_cast<const float*>(acc);
  const float* bd = static_cast<const float*>(bounds);
  auto* cnt = static_cast<unsigned long long*>(count);
  auto* cs = static_cast<float*>(conf_sum);
  auto* as = static_cast<float*>(acc_sum);
  const auto s = static_cast<cudaStream_t>(stream);
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(binned_calibration_kernel<true>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    binned_calibration_kernel<true><<<static_cast<unsigned>(blocks), kCalThreads, smem, s>>>(cf, ac, n, bd, b,
                                                                                          cnt, cs, as);
  } else {
    binned_calibration_kernel<false><<<static_cast<unsigned>(blocks), kCalThreads, 0, s>>>(cf, ac, n, bd, b,
                                                                                        cnt, cs, as);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
