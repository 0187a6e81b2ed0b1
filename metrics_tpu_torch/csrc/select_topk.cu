// Top-k mask for every top_k > 1 classification metric.
//
// Replaces metrics_tpu/ops/select_topk.py `_topk_mask_kernel` (wrapper
// `_topk_mask`): a 0/1 int32 mask of each row's k largest entries of a
// float32 [N, C] matrix, where NaN ranks greatest, -0.0 and 0.0 tie, ties go
// to the lowest column, and -inf entries can still be picked (a row with
// fewer than k finite values still gets k picks).
//
// Bound on an H100: bytes. It reads the f32 row once and writes the int32
// mask once (at [8192, 1000]: 65.5 MB, 19.6 us at 3.35 TB/s); the k rounds
// of compares work on data already on the chip.
//
// Order keys: an unsigned image of the float that sorts like the value,
// with -0.0 folded onto 0.0 and every NaN mapped to the largest key. Every
// real key is > 0 (-inf's is 0x007FFFFF), so 0 means "none".
//
// topk_mask_regs_kernel, float32 rows of C <= 1024 (the ImageNet path is
// C = 1000, k = 5): one warp per row, the row held in registers. The first
// design (topk_mask_kernel below) copied the row into shared memory with a
// 4-byte load per column, re-read all C/32 keys of a lane and its `taken`
// bytes in each of the k rounds, and held 40 KB of shared memory per block
// of 8 warps, so at most 5 blocks fit on an SM; its load, rounds and store
// ran one after another with little memory in flight (43.4 us at [8192,
// 1000], k = 5). Here each lane loads its share of the row as order keys in
// registers, a compile-time count per lane (4, 8, 16 or 32 keys, a template
// instance each, so nothing spills), with 16-byte loads all issued before
// any is used where the row allows it (C a multiple of 4, the base 16-byte
// aligned: lane l holds columns 4l .. 4l + 3, then 128 on), else 4-byte
// loads (lane l holds columns l, l + 32, ...). Each lane keeps its largest
// live key (its lowest column on a tie) and a bitmask of the keys still in
// play. A round is two warp reductions, `redux.sync` max over the lanes'
// keys and then min over the columns of the lanes that hold that key; the
// lane that holds the winner clears its bit and rescans its registers. The
// mask row is written from the bitmask, 16 bytes per store where aligned.
// No shared memory. The grid holds as many blocks as fit on the card at
// once, and each warp loads its next row before the current row's rounds,
// so loads, rounds and stores of different rows overlap.
//
// topk_mask_kernel, float32 rows wider than 1024 columns: one warp per row
// through shared memory: keys and a `taken` byte per column, each round a
// warp arg-max over (key << 32) | ~column words, so one unsigned max picks
// the larger value and, on a tie, the lower column (a flag marks a pick,
// not a sentinel value, so a real -inf stays selectable). The TPU kernel's k full-tile max sweeps over a VMEM block
// become k passes over shared memory.
//
// topk_mask_f64_kernel, float64 rows of any width, keeps that shared-memory
// design with a 64-bit order key per column (9 bytes of shared memory per
// column with the flag). One 64-bit word cannot hold the key and the
// column, so each round reduces the pair (key, column), key first and the
// lower column on a tie, with two shuffles per step.
#include <atomic>
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


template <bool kVec>
__device__ __forceinline__ uint32_t reg_column(int lane, int i) {
  return kVec ? static_cast<uint32_t>(4 * (lane + 32 * (i / 4)) + i % 4) : static_cast<uint32_t>(lane + 32 * i);
}

// The lane's largest key among those whose bit is set in `live` (0 if none)
// and its slot; slots rise with the column, so a tie keeps the lower column.
template <int kKeys>
__device__ __forceinline__ uint32_t reg_best(const uint32_t (&key)[kKeys], uint32_t live, int& slot) {
  uint32_t best = 0;
  slot = 0;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    if (((live >> i) & 1u) && key[i] > best) best = key[i], slot = i;
  }
  return best;
}

// Lane `lane`'s values of row `xr`: columns 4 lane .. + 3, then 128 on
// (kVec), or lane, lane + 32, ...; 0 past the row's end.
template <int kKeys, bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ xr, int c, int lane, float (&v)[kKeys]) {
  if (kVec) {
#pragma unroll
    for (int m = 0; m < kKeys / 4; ++m) {
      const int col = 4 * (lane + 32 * m);
      const float4 q = col < c ? *reinterpret_cast<const float4*>(xr + col) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * m] = q.x, v[4 * m + 1] = q.y, v[4 * m + 2] = q.z, v[4 * m + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kKeys; ++i) v[i] = lane + 32 * i < c ? xr[lane + 32 * i] : 0.f;
  }
}

// kKeys keys per lane cover 32 * kKeys columns; kVec: C % 4 == 0 and x
// 16-byte aligned. Each warp walks rows with a stride of the grid's warps
// and loads its next row before the rounds of the current one.
template <int kKeys, bool kVec>
__global__ void __launch_bounds__(256) topk_mask_regs_kernel(const float* __restrict__ x, int64_t n, int c, int k,
                                                             int32_t* __restrict__ out) {
  static_assert(kKeys <= 32 && (!kVec || kKeys % 4 == 0), "one bit of `live` per key");
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  uint32_t all = 0;  // the keys that hold a column of the row
#pragma unroll
  for (int i = 0; i < kKeys; ++i) all |= static_cast<uint32_t>(reg_column<kVec>(lane, i) < static_cast<uint32_t>(c)) << i;
  int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  float v[kKeys];
  if (row < n) load_row<kKeys, kVec>(x + row * c, c, lane, v);
  for (; row < n; row += warps) {
    uint32_t key[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) key[i] = order_key(v[i]);
    if (row + warps < n) load_row<kKeys, kVec>(x + (row + warps) * c, c, lane, v);
    uint32_t live = all;
    int slot;
    uint32_t mine = reg_best<kKeys>(key, live, slot);
    for (int round = 0; round < k; ++round) {
      // the largest key, then the lowest column holding it (every real key is > 0)
      const uint32_t top = __reduce_max_sync(0xFFFFFFFFu, mine);
      const uint32_t col = reg_column<kVec>(lane, slot);
      if (__reduce_min_sync(0xFFFFFFFFu, mine == top ? col : 0xFFFFFFFFu) == col && mine == top) {
        live &= ~(1u << slot);
        mine = reg_best<kKeys>(key, live, slot);
      }
    }
    const uint32_t taken = all & ~live;
    int32_t* orow = out + row * c;
    if (kVec) {
#pragma unroll
      for (int m = 0; m < kKeys / 4; ++m) {
        const int col = 4 * (lane + 32 * m);
        if (col < c) {
          const uint32_t b = taken >> (4 * m);
          *reinterpret_cast<int4*>(orow + col) =
              make_int4(static_cast<int>(b & 1u), static_cast<int>((b >> 1) & 1u), static_cast<int>((b >> 2) & 1u),
                        static_cast<int>((b >> 3) & 1u));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (lane + 32 * i < c) orow[lane + 32 * i] = static_cast<int32_t>((taken >> i) & 1u);
      }
    }
  }
}

// As many blocks as fit on the card at once (each warp then takes several
// rows, so its next row's loads overlap this one's rounds), fewer for few
// rows. The count is worked out once per device and instance.
template <int kKeys, bool kVec>
cudaError_t launch_regs(const float* x, int64_t n, int c, int k, int32_t* out, cudaStream_t stream) {
  static std::atomic<unsigned> resident_on[64];  // 0: not yet known
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  unsigned resident = resident_on[device & 63].load();
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_mask_regs_kernel<kKeys, kVec>,
                                                          kMaxWarpsPerBlock * kWarp, 0);
    }
    if (err != cudaSuccess) return err;
    resident = static_cast<unsigned>(sms) * static_cast<unsigned>(per_sm > 0 ? per_sm : 1);
    resident_on[device & 63].store(resident);
  }
  unsigned blocks = row_blocks(n, kMaxWarpsPerBlock);
  if (blocks > resident) blocks = resident;
  topk_mask_regs_kernel<kKeys, kVec><<<blocks, kMaxWarpsPerBlock * kWarp, 0, stream>>>(x, n, c, k, out);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: float32 [n, c] row-major; out: int32 [n, c], 16-byte aligned rows when
// vec. keys: 4, 8, 16 or 32 with c <= 32 * keys; vec: c % 4 == 0 and x
// 16-byte aligned. Requires 1 <= k <= c.
int mt_topk_mask_regs(int device, const void* x, int64_t n, int64_t c, int k, int keys, int vec, void* out,
                      void* stream) {
  if (k < 1 || k > c || c > 32 * static_cast<int64_t>(keys)) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (c % 4 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto* xs = static_cast<const float*>(x);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int ci = static_cast<int>(c);
  cudaError_t err;
  switch (keys * 2 + (vec ? 1 : 0)) {
    case 8: err = launch_regs<4, false>(xs, n, ci, k, o, s); break;
    case 9: err = launch_regs<4, true>(xs, n, ci, k, o, s); break;
    case 16: err = launch_regs<8, false>(xs, n, ci, k, o, s); break;
    case 17: err = launch_regs<8, true>(xs, n, ci, k, o, s); break;
    case 32: err = launch_regs<16, false>(xs, n, ci, k, o, s); break;
    case 33: err = launch_regs<16, true>(xs, n, ci, k, o, s); break;
    case 64: err = launch_regs<32, false>(xs, n, ci, k, o, s); break;
    case 65: err = launch_regs<32, true>(xs, n, ci, k, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

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
