// Top-k mask for every top_k > 1 classification metric.
//
// Replaces metrics_tpu/ops/select_topk.py `_topk_mask_kernel` (wrapper
// `_topk_mask`): a 0/1 int32 mask of each row's k largest entries of a
// float32 [N, C] matrix, where NaN ranks greatest, -0.0 and 0.0 tie, ties go
// to the lowest column, and -inf entries can still be picked (a row with
// fewer than k finite values still gets k picks).
//
// Bound on an H100: bytes. It reads the f32 row once and writes the int32
// mask once (at [8192, 1000]: 65.5 MB, about 20 us at 3.35 TB/s); the k
// rounds of compares run on shared memory.
//
// Design: one warp per row. The warp loads its row once from device memory
// (coalesced) into shared memory as 32-bit order keys: an unsigned image of
// the float that sorts like the value, with -0.0 folded onto 0.0 and every
// NaN mapped to the largest key. Each of the k rounds is a warp-wide arg-max
// over (key, lowest column) packed into one 64-bit word, reduced with
// shuffles; the winner sets its `taken` byte, which removes it from later
// rounds (a flag, not a sentinel value, so a real -inf stays selectable).
// The mask row is then written from the `taken` bytes. The TPU kernel's k
// full-tile max sweeps over a VMEM block become k passes over shared memory.
//
// float64 rows get their own kernel: a 64-bit order key per column (9 bytes
// of shared memory per column with the flag). One 64-bit word cannot hold
// the key and the column, so each round reduces the pair (key, column),
// key first and the lower column on a tie, with two shuffles per step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kBytesPerColumn = sizeof(uint32_t) + 1;  // key + taken flag
constexpr size_t kBytesPerColumnF64 = sizeof(uint64_t) + 1;

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return 0xFFFFFFFFu;  // NaN ranks greatest
  if ((b & 0x7FFFFFFFu) == 0u) b = 0u;                        // -0.0 ties with 0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void topk_mask_kernel(const float* __restrict__ x, int64_t n, int c, int k,
                                 int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * c;
  unsigned char* taken = smem + static_cast<size_t>(warps) * c * sizeof(uint32_t) +
                         static_cast<size_t>(warp) * c;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * warps) {
    const float* xr = x + row * c;
    for (int j = lane; j < c; j += kWarp) {
      keys[j] = order_key(xr[j]);
      taken[j] = 0;
    }
    __syncwarp();
    for (int round = 0; round < k; ++round) {
      // every real key is > 0 (the smallest, -inf's, is 0x007FFFFF), so 0 means "none"
      unsigned long long best = 0ULL;
      for (int j = lane; j < c; j += kWarp) {
        if (!taken[j]) {
          const unsigned long long cand =
              (static_cast<unsigned long long>(keys[j]) << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(j));
          best = cand > best ? cand : best;
        }
      }
      for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, best, offset);
        best = other > best ? other : best;
      }
      if (lane == 0) taken[~static_cast<uint32_t>(best & 0xFFFFFFFFULL)] = 1;
      __syncwarp();
    }
    int32_t* orow = out + row * c;
    for (int j = lane; j < c; j += kWarp) orow[j] = taken[j];
    __syncwarp();
  }
}

__device__ __forceinline__ uint64_t order_key(double v) {
  uint64_t b = static_cast<uint64_t>(__double_as_longlong(v));
  if ((b & 0x7FFFFFFFFFFFFFFFULL) > 0x7FF0000000000000ULL) return 0xFFFFFFFFFFFFFFFFULL;
  if ((b & 0x7FFFFFFFFFFFFFFFULL) == 0ULL) b = 0ULL;
  return (b & 0x8000000000000000ULL) ? ~b : (b | 0x8000000000000000ULL);
}

__global__ void topk_mask_f64_kernel(const double* __restrict__ x, int64_t n, int c, int k,
                                     int32_t* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem64[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem64) + static_cast<size_t>(warp) * c;
  unsigned char* taken = smem64 + static_cast<size_t>(warps) * c * sizeof(uint64_t) +
                         static_cast<size_t>(warp) * c;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * warps) {
    const double* xr = x + row * c;
    for (int j = lane; j < c; j += kWarp) {
      keys[j] = order_key(xr[j]);
      taken[j] = 0;
    }
    __syncwarp();
    for (int round = 0; round < k; ++round) {
      // every real key is > 0 (-inf's is 0x000FFFFFFFFFFFFF), so key 0 means "none"
      unsigned long long best_key = 0ULL;
      int best_col = 0x7FFFFFFF;
      for (int j = lane; j < c; j += kWarp) {
        if (!taken[j] && keys[j] > best_key) {  // j rises, so a tie keeps the lower column
          best_key = keys[j];
          best_col = j;
        }
      }
      for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        const unsigned long long other_key = __shfl_xor_sync(0xFFFFFFFFu, best_key, offset);
        const int other_col = __shfl_xor_sync(0xFFFFFFFFu, best_col, offset);
        if (other_key > best_key || (other_key == best_key && other_col < best_col)) {
          best_key = other_key;
          best_col = other_col;
        }
      }
      if (lane == 0) taken[best_col] = 1;
      __syncwarp();
    }
    int32_t* orow = out + row * c;
    for (int j = lane; j < c; j += kWarp) orow[j] = taken[j];
    __syncwarp();
  }
}

// Warps per block: halved until `bytes_per_column` for each of the block's
// rows fits; the dynamic shared-memory limit is raised past 48 KB if needed.
template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, size_t bytes_per_column, int64_t n, int64_t c, int* warps_out,
                        size_t* smem_out) {
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * bytes_per_column * c > kDefaultSmem) warps /= 2;
  const size_t smem = warps * bytes_per_column * c;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  *warps_out = warps;
  *smem_out = smem;
  return cudaSuccess;
}

unsigned row_blocks(int64_t n, int warps) {
  int64_t blocks = (n + warps - 1) / warps;
  return static_cast<unsigned>(blocks > 0x7FFFFFFF ? 0x7FFFFFFF : blocks);
}

}  // namespace

extern "C" {

// x: float32 [n, c] row-major; out: int32 [n, c]. Requires 1 <= k <= c.
int mt_topk_mask(int device, const void* x, int64_t n, int64_t c, int k, void* out, void* stream) {
  if (k < 1 || k > c || c > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int warps = 0;
  size_t smem = 0;
  const cudaError_t err = launch_rows(topk_mask_kernel, kBytesPerColumn, n, c, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_mask_kernel<<<row_blocks(n, warps), warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<int>(c), k, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x: float64 [n, c] row-major; out: int32 [n, c]. Requires 1 <= k <= c.
int mt_topk_mask_f64(int device, const void* x, int64_t n, int64_t c, int k, void* out, void* stream) {
  if (k < 1 || k > c || c > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int warps = 0;
  size_t smem = 0;
  const cudaError_t err = launch_rows(topk_mask_f64_kernel, kBytesPerColumnF64, n, c, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_mask_f64_kernel<<<row_blocks(n, warps), warps * kWarp, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), n, static_cast<int>(c), k, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
