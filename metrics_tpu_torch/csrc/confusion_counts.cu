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
//   per class c: tp = sum p*t, sum p, sum t over 0/1 int32 [N, C] inputs; the
//   wrapper finishes tn = N - sum p - sum t + tp, fp = sum p - tp,
//   fn = sum t - tp.
//   Bound on an H100: bytes (both [N, C] inputs read once).
//   Design: threads own columns, so a warp reads 32 neighbouring int32 of one
//   row (coalesced); blocks own chunks of rows, counting in registers, and
//   each thread adds its three counts to the [C, 3] output with atomics, one
//   set per block instead of one per element.
//
// The kernels allocate nothing and launch on the caller's stream and device;
// every C entry returns cudaGetLastError() so a refused launch is reported.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM is plenty for a grid-stride loop
constexpr int kColThreads = 128;
constexpr int kRowsPerBlock = 64;
constexpr int kMaxRowBlocks = 65535;  // gridDim.y limit

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

__global__ void multilabel_counts_kernel(const int32_t* __restrict__ preds,
                                         const int32_t* __restrict__ target, int64_t n,
                                         int64_t c, unsigned long long* __restrict__ out) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= c) return;
  long long tp = 0, sum_p = 0, sum_t = 0;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock; row0 < n;
       row0 += static_cast<int64_t>(gridDim.y) * kRowsPerBlock) {
    const int64_t row1 = row0 + kRowsPerBlock < n ? row0 + kRowsPerBlock : n;
    for (int64_t r = row0; r < row1; ++r) {
      const long long p = preds[r * c + col];
      const long long t = target[r * c + col];
      tp += p * t;
      sum_p += p;
      sum_t += t;
    }
  }
  // two's complement: adding the unsigned image of a signed count is exact
  atomicAdd(out + col * 3 + 0, static_cast<unsigned long long>(tp));
  atomicAdd(out + col * 3 + 1, static_cast<unsigned long long>(sum_p));
  atomicAdd(out + col * 3 + 2, static_cast<unsigned long long>(sum_t));
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

// preds, target: int32 [n, c] row-major; out: int64 [c, 3] (tp, sum p, sum t), zeroed by the caller.
int mt_multilabel_counts(int device, const void* preds, const void* target, int64_t n, int64_t c,
                         void* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0 && c > 0) {
    int64_t row_blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (row_blocks > kMaxRowBlocks) row_blocks = kMaxRowBlocks;
    const dim3 grid(static_cast<unsigned>((c + kColThreads - 1) / kColThreads),
                    static_cast<unsigned>(row_blocks));
    multilabel_counts_kernel<<<grid, kColThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(preds), static_cast<const int32_t*>(target), n, c,
        static_cast<unsigned long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
