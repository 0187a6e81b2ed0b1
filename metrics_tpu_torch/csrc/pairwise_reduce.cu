// Row sums of the pairwise euclidean-distance or cosine-similarity matrix,
// without building the matrix.
//
// Replaces metrics_tpu/ops/pairwise_reduce.py `_kernel` (wrapper
// `_fused_row_sums`):
//   out[i] = sum over j < M of  sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0))  (euclidean)
//                          or   x_i.y_j                                    (cosine; rows come in normalized)
//   leaving out the cells i == j (i < min(N, M)) when zero_diag is set. The
//   clamp keeps NaN (a NaN row spoils its sums, as in the JAX package's
//   composition); the expansion is the one both JAX routes compute.
//   Types: float32 in, float32 compute; float64 in, float64 compute;
//   bfloat16 and float16 in, widened to float32 on load. Row sums come out
//   in the compute type; the wrapper casts to the inputs' type.
//   Bound on an H100. Euclidean: operations, N*M*d FMAs on the CUDA cores
//   at 33.5e12/s, since the square root is not linear (In-Shop query x
//   gallery, 14,218 x 12,612 x 512: 9.18e10 FMAs, 2.74 ms). Cosine: bytes,
//   since its row sums are linear, x_i.(sum_j y_j), and need only
//   O((N + M) d) operations (SOP self-similarity, 60,502 x 512 float32 read
//   once: 124 MB at 3.35 TB/s, 0.037 ms). This design spends N*M*d FMAs on
//   cosine too (55.9 ms at SOP), so it sits orders of magnitude above that
//   bound.
//   Design: the TPU kernel walked a sequential grid over column tiles,
//   adding each tile's row sums into one resident output block. Here one
//   block owns 64 rows of x and walks every 128-row tile of y itself, so no
//   other block touches its rows: no atomics, and the result is the same on
//   every run. Each tile is a small SGEMM: d is cut into chunks of 16 (8 for
//   float64) staged transposed through two shared-memory buffers, the next
//   chunk's global loads in flight while the current one is multiplied;
//   each of the 256 threads keeps a 4 x 8 register tile of dot products
//   (FMAs), and the squared norms of the tile's rows and columns are summed
//   from the same staged chunks. The epilogue (norms, clamp, sqrt, the
//   column and diagonal masks) runs in registers and adds each thread's
//   cells to its four row sums, held in float64; at the end the 16 threads
//   that share a row fold their sums with warp shuffles. d is tiled, so
//   there is no cap on it (the TPU kernel's VMEM cap was 4096); N, M and d
//   need not be multiples of a tile.
//   Left for later: the tile on the tensor cores (wgmma or mma.sync in TF32
//   or bf16, which the JAX kernel's bf16 dot and its 2e-2 tolerance already
//   allow; 495 TFLOP/s TF32), the x tile kept in shared memory across the
//   column tiles, and, for cosine, the linearity sum_j x_i.y_j = x_i.(sum_j y_j).
//
// The kernel allocates nothing and launches on the caller's stream and
// device; the C entry returns cudaGetLastError() so a refused launch is reported.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // rows of x a block owns
constexpr int kCols = 128;  // rows of y (matrix columns) per tile
constexpr int kHalf = kCols / 2;
constexpr int kPad = 4;     // keeps 16-byte alignment and spreads the transposed stores over banks

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// T: input type; C: compute type; kDepth: d-chunk staged per step.
template <typename T, typename C, int kDepth, bool kEuclid>
__global__ void __launch_bounds__(kThreads)
    pairwise_rows_kernel(const T* __restrict__ x, const T* __restrict__ y, int64_t n, int64_t m, int64_t d,
                         bool zero_diag, C* __restrict__ out) {
  __shared__ __align__(16) C xs[2][kDepth][kRows + kPad];
  __shared__ __align__(16) C ys[2][kDepth][kCols + kPad];
  __shared__ C x_norm[kRows];
  __shared__ C y_norm[kCols];
  constexpr int kXLoads = kRows * kDepth / kThreads;
  constexpr int kYLoads = kCols * kDepth / kThreads;
  static_assert(kXLoads * kThreads == kRows * kDepth && kYLoads * kThreads == kCols * kDepth, "tile");

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // this thread's rows: tr*4 .. tr*4+3 of the block's 64
  const int tc = tid % 16;  // its columns: tc*4 .. tc*4+3 and 64 + tc*4 .. of each tile
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t chunks = (d + kDepth - 1) / kDepth;
  double row_sum[4] = {0.0, 0.0, 0.0, 0.0};
  C x_reg[kXLoads];
  C y_reg[kYLoads];

  // global -> registers: consecutive threads read consecutive k of one row
  auto fetch = [&](int64_t col0, int64_t k0) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int e = tid + i * kThreads;
      const int64_t r = row0 + e / kDepth;
      const int64_t k = k0 + e % kDepth;
      x_reg[i] = (r < n && k < d) ? static_cast<C>(widen(x[r * d + k])) : C(0);
    }
#pragma unroll
    for (int i = 0; i < kYLoads; ++i) {
      const int e = tid + i * kThreads;
      const int64_t r = col0 + e / kDepth;
      const int64_t k = k0 + e % kDepth;
      y_reg[i] = (r < m && k < d) ? static_cast<C>(widen(y[r * d + k])) : C(0);
    }
  };
  // registers -> shared, transposed to [k][row]
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int e = tid + i * kThreads;
      xs[buf][e % kDepth][e / kDepth] = x_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kYLoads; ++i) {
      const int e = tid + i * kThreads;
      ys[buf][e % kDepth][e / kDepth] = y_reg[i];
    }
  };

  for (int64_t col0 = 0; col0 < m; col0 += kCols) {
    C acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = C(0);
    }
    C xn = C(0), yn = C(0);
    if (chunks > 0) {
      fetch(col0, 0);
      stash(0);
    }
    __syncthreads();
    for (int64_t c = 0; c < chunks; ++c) {
      const int buf = static_cast<int>(c & 1);
      if (c + 1 < chunks) fetch(col0, (c + 1) * kDepth);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        C a[4], b0[4], b1[4];
        load4(&xs[buf][k][tr * 4], a);
        load4(&ys[buf][k][tc * 4], b0);
        load4(&ys[buf][k][kHalf + tc * 4], b1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fma_(a[i], b0[j], acc[i][j]);
            acc[i][4 + j] = fma_(a[i], b1[j], acc[i][4 + j]);
          }
        }
      }
      if (kEuclid) {
        if (tid < kRows) {
#pragma unroll
          for (int k = 0; k < kDepth; ++k) xn = fma_(xs[buf][k][tid], xs[buf][k][tid], xn);
        } else if (tid < kRows + kCols) {
#pragma unroll
          for (int k = 0; k < kDepth; ++k) yn = fma_(ys[buf][k][tid - kRows], ys[buf][k][tid - kRows], yn);
        }
      }
      // the other buffer was last read before the previous barrier
      if (c + 1 < chunks) stash(buf ^ 1);
      __syncthreads();
    }
    if (kEuclid) {
      if (tid < kRows) {
        x_norm[tid] = xn;
      } else if (tid < kRows + kCols) {
        y_norm[tid - kRows] = yn;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = row0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lc = (j < 4 ? 0 : kHalf) + tc * 4 + (j & 3);
        const int64_t col = col0 + lc;
        if (col >= m || (zero_diag && col == r)) continue;
        C v = acc[i][j];
        if (kEuclid) {
          v = (x_norm[tr * 4 + i] + y_norm[lc]) - C(2) * v;
          v = v < C(0) ? C(0) : v;  // a NaN stays NaN
          v = sqrt_(v);
        }
        row_sum[i] += static_cast<double>(v);
      }
    }
  }

  // lanes 0-15 and 16-31 of a warp each hold one group of four rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], off);
  }
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = row0 + tr * 4 + i;
      if (r < n) out[r] = static_cast<C>(row_sum[i]);
    }
  }
}

template <typename T, typename C, int kDepth>
void launch(int op, const void* x, const void* y, int64_t n, int64_t m, int64_t d, bool zero_diag, void* out,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  C* o = static_cast<C*>(out);
  if (op == 0) {
    pairwise_rows_kernel<T, C, kDepth, true><<<blocks, kThreads, 0, stream>>>(xp, yp, n, m, d, zero_diag, o);
  } else {
    pairwise_rows_kernel<T, C, kDepth, false><<<blocks, kThreads, 0, stream>>>(xp, yp, n, m, d, zero_diag, o);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16 (x and y alike), both
// row-major and contiguous; op: 0 euclidean, 1 cosine. out: [n] float64 for
// float64 inputs, else float32; every entry is written.
int mt_pairwise_reduce(int device, int dtype, int op, const void* x, const void* y, int64_t n, int64_t m,
                       int64_t d, int zero_diag, void* out, void* stream) {
  if (dtype < 0 || dtype > 3 || op < 0 || op > 1 || n < 0 || m < 0 || d < 0 ||
      (n + kRows - 1) / kRows > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const bool zd = zero_diag != 0;
    switch (dtype) {
      case 0: launch<float, float, 16>(op, x, y, n, m, d, zd, out, s); break;
      case 1: launch<double, double, 8>(op, x, y, n, m, d, zd, out, s); break;
      case 2: launch<__nv_bfloat16, float, 16>(op, x, y, n, m, d, zd, out, s); break;
      default: launch<__half, float, 16>(op, x, y, n, m, d, zd, out, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
