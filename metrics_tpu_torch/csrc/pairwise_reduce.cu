// Row sums of the pairwise euclidean-distance or cosine-similarity matrix,
// without building the matrix.
//
// Replaces metrics_tpu/ops/pairwise_reduce.py `_kernel` (wrapper
// `_fused_row_sums`):
//   out[i] = sum over j < M of  sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0))  (euclidean)
//                          or   x_i.y_j                                    (cosine; rows come in normalized)
//   leaving out the cells i == j (i < min(N, M)) when zero_diag is set. A
//   NaN spoils the sums it reaches, as in the JAX package's composition.
//   Row sums come out in float32, float64 for float64 inputs.
//
// Cosine, all types: linear order, O((N + M) d) work. Bound on an H100:
//   bytes (SOP self-similarity, 60,502 x 512 float32 read once: 124 MB at
//   3.35 TB/s, 0.037 ms). The row sums are x_i.S with S = sum of the rows
//   of y that hold no NaN, less x_i.y_i when the diagonal is zeroed; NaN
//   columns are counted apart so that a NaN column on the masked diagonal
//   leaves its row finite, as the composition does. Four launches:
//   cosine_nan_rows_kernel flags the NaN rows of y (one warp per row);
//   cosine_col_partials_kernel sums fixed row ranges of y into float64
//   partials [P, d] (threads own columns, coalesced), skipping flagged
//   rows, and counts the flags of each range; cosine_fold_kernel folds the
//   partials in range order into S [d]; cosine_rows_kernel gives each row
//   its dot with S (staged in shared memory) and, on the diagonal, with
//   y_i, in float64, one warp per row, folded by shuffles. No float
//   atomics: two launches give bit-identical sums.
//
// Euclidean, float32 (bfloat16 and float16 widened by the wrapper): the
//   N*M*d products on the tensor cores. Bound: operations, 2 N M d at the
//   TF32 dense rate, 495 TFLOP/s (In-Shop query x gallery, 14,218 x 12,612
//   x 512: 0.371 ms); this design does three products per cell (below), so
//   its own floor is 1.11 ms. Numerics: one TF32 pass keeps about three
//   digits, and the rounding of x_i is shared by its whole row, so each
//   product is taken in split TF32: hi = rna_tf32(v), lo = rna_tf32(v - hi),
//   and hi.hi + hi.lo + lo.hi is accumulated in float32; the low bits of
//   an operand are never left to the tensor core. prep_kernel takes the
//   norms as float32 sums of the untruncated values (one warp per row) and
//   writes y split into y_hi and y_lo (scratch), once for all row tiles.
//   euclid_tf32_kernel: a block owns 192 rows of x and a fixed range of
//   128-row tiles of y. Warpgroup 0 is the producer: one thread keeps TMA
//   loads of x, y_hi and y_lo (128-byte swizzle, k-chunks of 32 floats) in
//   flight in a ring of four stages, completion on mbarriers. Warpgroups
//   1-3 each own 64 rows of x and run on their own: each reads its A
//   fragments of an arrived stage from the swizzled x tile into registers,
//   splits them there, and runs wgmma.m64n128k8 tf32 three times per k-step
//   with B (y_hi, y_lo) from shared memory; it waits for its group before
//   reloading the fragments, while the other warpgroups keep the tensor
//   cores busy (three of them rather than two: more warpgroups to cover
//   each one's fragment loads, and a third fewer loads of y per product). The epilogue (norms, clamp keeping NaN, sqrt, column-count
//   and diagonal masks, as selects) runs on the accumulator fragment, row
//   sums in float64. fold_rows_kernel adds the column ranges' partial row
//   sums in range order. No 64-bit division and no IEEE sqrtf in the
//   kernel: either is a subroutine call, and a call makes ptxas serialize
//   every wgmma.
//   Where trouble lies, and what the design does:
//   1. Filling the card: 14,218 rows make only 75 row tiles for 132 SMs,
//      so the column tiles are cut into a fixed number of ranges, chosen
//      from the shape and the SM count to end on full waves; partial row
//      sums go to scratch [ranges, N] and fold in a fixed order, so two
//      launches give bit-identical sums.
//   2. TMA: row strides must be multiples of 16 bytes and the base 16-byte
//      aligned; the wrapper zero-pads d to a multiple of 4 and copies
//      misaligned views. The tensor maps are encoded per call with
//      cuTensorMapEncodeTiled, looked up at run time (no -lcuda), and
//      passed as __grid_constant__ parameters.
//   3. Ragged tails: TMA zero-fills rows past N or M, but a zero row of y
//      lies at distance |x_i|, so columns >= M are masked by count in the
//      epilogue, never left to the fill.
//   4. The accumulator layout: thread t of warp w in a warpgroup holds, for
//      register i, row 16 w + t/4 + 8 ((i/2) % 2) and column
//      8 (i/4) + 2 (t % 4) + i % 2; the diagonal mask is taken from it.
//
// Euclidean, float64: CUDA cores (pairwise_rows_kernel): one block owns 64
//   rows of x and walks every 128-row tile of y (no atomics); d staged in
//   chunks of 8 through two shared buffers, a 4 x 8 FMA register tile per
//   thread, norms from the same tiles, the epilogue in registers.
//
// The kernels allocate nothing: the wrapper passes scratch of
// mt_pairwise_scratch_bytes() bytes. They launch on the caller's stream and
// device; the C entry returns the first CUDA error so a refused launch is
// reported.
#include <cuda.h>
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

__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

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

// ---------------------------------------------------------------- cosine

constexpr int kCosThreads = 256;
constexpr int kCosCols = 256;        // columns of y a partial-sum block owns
constexpr int kCosRanges = 264;      // most row ranges of y (2 per SM)
constexpr int kCosRowsPerRange = 64; // fewest rows of y in a range
constexpr int kCosRowsPerWarp = 4;   // rows of x per warp in the row pass
constexpr int kCosStage = 1024;      // doubles of S staged in shared memory at a time
constexpr int kCosFoldThreads = 512;

__device__ __forceinline__ bool is_nan(double v) { return v != v; }

int64_t cos_ranges(int64_t m) {
  const int64_t r = (m + kCosRowsPerRange - 1) / kCosRowsPerRange;
  return r < 1 ? 1 : (r > kCosRanges ? kCosRanges : r);
}

// flags[j] = 1 when row j of y holds a NaN; one warp per row.
template <typename T>
__global__ void __launch_bounds__(kCosThreads)
    cosine_nan_rows_kernel(const T* __restrict__ y, int64_t m, int64_t d, uint8_t* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kCosThreads / 32);
  for (int64_t r = blockIdx.x * (kCosThreads / 32) + threadIdx.x / 32; r < m; r += warps) {
    bool nan = false;
    const T* row = y + r * d;
#pragma unroll 4
    for (int64_t k = lane; k < d; k += 32) nan |= is_nan(static_cast<double>(widen(row[k])));
    const bool any = __any_sync(0xffffffffu, nan);
    if (lane == 0) flags[r] = any ? 1 : 0;
  }
}

// partial[p][k] = sum of y[j][k] over the unflagged rows j of range p;
// nan_partial[p] = flagged rows of range p. Grid (column blocks, ranges).
template <typename T>
__global__ void __launch_bounds__(kCosThreads)
    cosine_col_partials_kernel(const T* __restrict__ y, int64_t m, int64_t d, int64_t rows_per_range,
                               const uint8_t* __restrict__ flags, double* __restrict__ partial,
                               int64_t* __restrict__ nan_partial) {
  const int64_t p = blockIdx.y;
  const int64_t r0 = p * rows_per_range;
  const int64_t r1 = r0 + rows_per_range < m ? r0 + rows_per_range : m;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kCosCols + threadIdx.x;
  if (k < d) {
    double acc = 0.0;
#pragma unroll 8
    for (int64_t r = r0; r < r1; ++r) {
      const double v = static_cast<double>(widen(y[r * d + k]));
      acc += flags[r] ? 0.0 : v;
    }
    partial[p * d + k] = acc;
  }
  if (blockIdx.x == 0) {
    __shared__ int count;
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    int mine = 0;
    for (int64_t r = r0 + threadIdx.x; r < r1; r += kCosThreads) mine += flags[r];
    if (mine) atomicAdd(&count, mine);  // integer: the total does not depend on the order
    __syncthreads();
    if (threadIdx.x == 0) nan_partial[p] = count;
  }
}

// col_sum[k] = the partials folded in a fixed order: a block owns 32
// columns, warp w adds the ranges w, w + 16, ... in order, then the 16
// warp sums are added in warp order. Block 0 also totals the flags.
__global__ void __launch_bounds__(kCosFoldThreads)
    cosine_fold_kernel(const double* __restrict__ partial, const int64_t* __restrict__ nan_partial,
                       int64_t ranges, int64_t d, double* __restrict__ col_sum, int64_t* __restrict__ nan_total) {
  constexpr int kWarps = kCosFoldThreads / 32;
  __shared__ double warp_sum[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  double acc = 0.0;
  if (k < d) {
#pragma unroll 4
    for (int64_t p = warp; p < ranges; p += kWarps) acc += partial[p * d + k];
  }
  warp_sum[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && k < d) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w][lane];
    col_sum[k] = total;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t total = 0;
    for (int64_t p = 0; p < ranges; ++p) total += nan_partial[p];
    *nan_total = total;
  }
}

// Adds the kE elements of x (and of y, on the diagonal) from k on to the dots.
template <typename T, int kE>
__device__ __forceinline__ void dot_span(const T* __restrict__ xr, const T* __restrict__ yr, const double* s_sum,
                                         int k, bool on_diag, double& dot, double& diag) {
  alignas(16) T xv[kE];
  alignas(16) T yv[kE];
  if (kE * sizeof(T) == 16) {  // one 16-byte load
    *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(xr + k);
    if (on_diag) *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(yr + k);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      xv[e] = xr[k + e];
      if (on_diag) yv[e] = yr[k + e];
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const double v = static_cast<double>(widen(xv[e]));
    dot = fma(v, s_sum[k + e], dot);
    if (on_diag) diag = fma(v, static_cast<double>(widen(yv[e])), diag);
  }
}

// out[i] = x_i.S, less x_i.y_i on the masked diagonal; NaN when an unmasked
// column is NaN, or x_i holds a NaN; 0 when every column is masked. One warp
// per row at a time; kE elements per lane per load (16 bytes when d and the
// bases allow it, else 1).
template <typename T, typename O, int kE>
__global__ void __launch_bounds__(kCosThreads)
    cosine_rows_kernel(const T* __restrict__ x, const T* __restrict__ y, int64_t n, int64_t m, int64_t d,
                       bool zero_diag, const uint8_t* __restrict__ flags, const double* __restrict__ col_sum,
                       const int64_t* __restrict__ nan_total, O* __restrict__ out) {
  __shared__ double s_sum[kCosStage];
  const int lane = threadIdx.x & 31;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * (kCosThreads / 32) + threadIdx.x / 32) * kCosRowsPerWarp;
  double dot[kCosRowsPerWarp], diag[kCosRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kCosRowsPerWarp; ++q) dot[q] = diag[q] = 0.0;
  for (int64_t c0 = 0; c0 < d; c0 += kCosStage) {
    const int width = d - c0 < kCosStage ? static_cast<int>(d - c0) : kCosStage;
    __syncthreads();
    for (int k = threadIdx.x; k < width; k += kCosThreads) s_sum[k] = col_sum[c0 + k];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kCosRowsPerWarp; ++q) {
      const int64_t r = row0 + q;
      if (r >= n) continue;
      const bool on_diag = zero_diag && r < m && !flags[r];
      const T* xr = x + r * d + c0;
      const T* yr = y + r * d + c0;
#pragma unroll 4
      for (int k = lane * kE; k < width; k += 32 * kE) dot_span<T, kE>(xr, yr, s_sum, k, on_diag, dot[q], diag[q]);
    }
  }
  const int64_t nans = *nan_total;
#pragma unroll
  for (int q = 0; q < kCosRowsPerWarp; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot[q] += __shfl_xor_sync(0xffffffffu, dot[q], off);
      diag[q] += __shfl_xor_sync(0xffffffffu, diag[q], off);
    }
    const int64_t r = row0 + q;
    if (lane == 0 && r < n) {
      const bool masked = zero_diag && r < m;
      const int64_t live = m - (masked ? 1 : 0);
      const int64_t nan_cols = nans - ((masked && flags[r]) ? 1 : 0);
      double v = dot[q] - diag[q];
      if (live == 0) {
        v = 0.0;
      } else if (nan_cols > 0) {
        v = __longlong_as_double(0x7ff8000000000000ll);
      }
      out[r] = static_cast<O>(v);
    }
  }
}

// d[64] += A [64 x 8] . B^T [128 x 8]: A tf32 from registers (this thread's
// fragment a[4]: rows g and g + 8, columns t and t + 4 of its warp's 16
// rows, g = lane / 4, t = lane % 4), B tf32 from shared memory (K-major,
// 128-byte swizzle); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const float* a, uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "l"(b_desc), "r"(scale_d));
}

// ------------------------------------------------------- euclidean, TF32

constexpr int kTcConsumers = 3;                   // consumer warpgroups, after the producer warpgroup 0
constexpr int kTcThreads = 128 * (1 + kTcConsumers);
constexpr int kTcRows = 64 * kTcConsumers;        // rows of x a block owns (64 per consumer warpgroup)
constexpr int kTcCols = 128;                      // rows of y per column tile
constexpr int kTcK = 32;                          // floats per k-chunk: one 128-byte swizzle row
constexpr int kTcStages = 4;                      // ring of stages [x, y hi, y lo], filled by TMA
constexpr int kTcXTile = kTcRows * kTcK * 4;      // bytes of the x tile (24 KB)
constexpr int kTcYTile = kTcCols * kTcK * 4;      // bytes of a y tile (16 KB)
constexpr int kTcStageBytes = kTcXTile + 2 * kTcYTile;
constexpr int kTcSmemBytes = 1024 + kTcStages * kTcStageBytes + 2 * kTcStages * 8;  // 1024: alignment slack
constexpr int kTcMaxRanges = 64;
static_assert(kTcXTile % 1024 == 0 && kTcYTile % 1024 == 0, "tiles start on the swizzle's 1024-byte period");
static_assert(kTcSmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Waits for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle:
// 8-row groups 1024 bytes apart; the tile base is 1024-aligned, and a
// k-step of 8 floats moves the start by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// v rounded to TF32, to nearest with ties away from zero; the low 13 bits
// come out 0, so the tensor core's treatment of them never matters.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// sqrt without the subroutine call of the IEEE sqrtf (a call anywhere in
// the kernel makes ptxas serialize every wgmma); within 1 ulp, 0, inf and
// NaN kept.
__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving a wgmma's registers across the async operation.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Squared norms in float32 from the untruncated values (norms[r]: rows of x,
// then rows of y; one warp per row, a fixed fold), and y split for the
// tensor cores: y_hi = tf32(y), y_lo = tf32(y - y_hi).
__global__ void __launch_bounds__(256)
    prep_kernel(const float* __restrict__ x, const float* __restrict__ y, int64_t n, int64_t m, int64_t d,
                float* __restrict__ norms, float* __restrict__ y_hi, float* __restrict__ y_lo) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * 8;
  for (int64_t r = blockIdx.x * 8 + threadIdx.x / 32; r < n + m; r += warps) {
    const bool is_y = r >= n;
    const int64_t off = (is_y ? r - n : r) * d;
    const float* row = (is_y ? y : x) + off;
    float acc = 0.0f;
#pragma unroll 4
    for (int64_t k = lane; k < d; k += 32) {
      const float v = row[k];
      acc = fmaf(v, v, acc);
      if (is_y) {
        const float hi = tf32_rna(v);
        y_hi[off + k] = hi;
        y_lo[off + k] = tf32_rna(v - hi);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) norms[r] = acc;
  }
}

// partial[range][i] = row sums of row tile blockIdx.x over the column tiles
// [range * tiles_per_range, ...) of y; range = blockIdx.y.
__global__ void __launch_bounds__(kTcThreads, 1)
    euclid_tf32_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap hi_map,
                       const __grid_constant__ CUtensorMap lo_map, const float* __restrict__ x_norm,
                       const float* __restrict__ y_norm, int64_t n, int64_t m, int64_t d, bool zero_diag,
                       int64_t tiles_per_range, double* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* stages = reinterpret_cast<float*>(smem);  // [stage][x, y hi, y lo]
  const uint32_t full0 = smem_addr(smem + kTcStages * kTcStageBytes), empty0 = full0 + 8 * kTcStages;
  constexpr int kStageFloats = kTcStageBytes / 4, kXFloats = kTcXTile / 4, kYFloats = kTcYTile / 4;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTcRows;
  const int64_t col_tiles = (m + kTcCols - 1) / kTcCols;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * tiles_per_range;
  const int64_t t1 = t0 + tiles_per_range < col_tiles ? t0 + tiles_per_range : col_tiles;
  const int chunks = static_cast<int>((d + kTcK - 1) / kTcK);
  const int64_t iters = (t1 - t0) * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lt = threadIdx.x % 128;
  if (wg == 0) {
    // producer: one thread keeps every stage loading. Iteration j: column
    // tile t0 + j / chunks, k-chunk j % chunks, both counted on (a 64-bit
    // division is a subroutine call, and a call makes ptxas serialize wgmma)
    if (lt == 0) {
      int kc = 0;
      int64_t col = t0 * kTcCols;
      for (int64_t j = 0; j < iters; ++j) {
        const int s = static_cast<int>(j % kTcStages);
        if (j >= kTcStages) {  // the stage's last iteration is done
          mbar_wait(empty0 + 8 * s, static_cast<uint32_t>(((j - kTcStages) / kTcStages) & 1));
        }
        const uint32_t bar = full0 + 8 * s;
        float* dst = stages + s * kStageFloats;
        mbar_expect_tx(bar, kTcStageBytes);
        tma_load_2d(smem_addr(dst), &x_map, bar, kc * kTcK, static_cast<int>(row0));
        tma_load_2d(smem_addr(dst + kXFloats), &hi_map, bar, kc * kTcK, static_cast<int>(col));
        tma_load_2d(smem_addr(dst + kXFloats + kYFloats), &lo_map, bar, kc * kTcK, static_cast<int>(col));
        if (++kc == chunks) {
          kc = 0;
          col += kTcCols;
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64 c .. 64 c + 63 of the block's rows,
  // and runs on its own (they meet only at the stages' empty barriers)
  const int c = wg - 1;
  const int warp = lt / 32, lane = lt % 32;
  const int a_row = 64 * c + 16 * warp + lane / 4;  // A fragment rows a_row and a_row + 8 of the x tile
  const int64_t r_lo = row0 + a_row;                // accumulator registers i with (i / 2) % 2 == 0
  const int64_t r_hi = r_lo + 8;                    // the others
  const float xn_lo = r_lo < n ? x_norm[r_lo] : 0.0f;
  const float xn_hi = r_hi < n ? x_norm[r_hi] : 0.0f;
  double sum_lo = 0.0, sum_hi = 0.0;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float a[32];  // this stage's A fragments: [0, 16) hi, [16, 32) lo, 4 per k-step

  int64_t j = 0;
  for (int64_t t = t0; t < t1; ++t) {
    for (int kc = 0; kc < chunks; ++kc, ++j) {
      const int s = static_cast<int>(j % kTcStages);
      mbar_wait(full0 + 8 * s, static_cast<uint32_t>((j / kTcStages) & 1));
      const float* x_tile = stages + s * kStageFloats;
#pragma unroll
      for (int ks = 0; ks < kTcK / 8; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {  // fragment register 2 h + rr: row a_row + 8 rr, column lane % 4 + 4 h
            const int r = a_row + 8 * rr;
            const int k = 8 * ks + lane % 4 + 4 * h;
            const float v = x_tile[r * kTcK + ((((k >> 2) ^ (r & 7)) << 2) | (k & 3))];
            const float hi = tf32_rna(v);
            a[4 * ks + 2 * h + rr] = hi;
            a[16 + 4 * ks + 2 * h + rr] = tf32_rna(v - hi);
          }
        }
      }
      const uint32_t y_hi = smem_addr(x_tile + kXFloats);
      const uint32_t y_lo = smem_addr(x_tile + kXFloats + kYFloats);
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTcK / 8; ++ks) {
        const uint32_t off = ks * 32;
        wgmma_m64n128k8_tf32_rs(acc, a + 4 * ks, sw128_desc(y_hi + off), (kc > 0 || ks > 0) ? 1 : 0);
        wgmma_m64n128k8_tf32_rs(acc, a + 4 * ks, sw128_desc(y_lo + off), 1);
        wgmma_m64n128k8_tf32_rs(acc, a + 16 + 4 * ks, sw128_desc(y_hi + off), 1);
      }
      wgmma_commit();
      // the fragments are reloaded next stage: wait for this one (the other
      // warpgroup keeps the tensor cores busy meanwhile)
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      mbar_arrive(empty0 + 8 * s);
    }
    // epilogue: register i holds (row r_lo or r_hi, column 8 (i / 4) + 2 (lane % 4) + i % 2)
    const int64_t col0 = t * kTcCols + 2 * (lane % 4);
    float tile_lo = 0.0f, tile_hi = 0.0f;
#pragma unroll
    for (int jn = 0; jn < kTcCols / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t col = col0 + 8 * jn + e;
        const bool live = col < m;  // selects, not branches
        const float yn = y_norm[live ? col : 0];
        float v = (xn_lo + yn) - 2.0f * acc[4 * jn + e];
        v = v < 0.0f ? 0.0f : v;  // a NaN stays NaN
        tile_lo += (live && !(zero_diag && col == r_lo)) ? sqrt_approx(v) : 0.0f;
        v = (xn_hi + yn) - 2.0f * acc[4 * jn + 2 + e];
        v = v < 0.0f ? 0.0f : v;
        tile_hi += (live && !(zero_diag && col == r_hi)) ? sqrt_approx(v) : 0.0f;
      }
    }
    sum_lo += static_cast<double>(tile_lo);
    sum_hi += static_cast<double>(tile_hi);
  }
  // the four lanes that share a row fold their sums
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
  }
  if (lane % 4 == 0) {
    double* dst = partial + static_cast<int64_t>(blockIdx.y) * n;
    if (r_lo < n) dst[r_lo] = sum_lo;
    if (r_hi < n) dst[r_hi] = sum_hi;
  }
}

// out[i] = the ranges' partial row sums added in range order.
__global__ void __launch_bounds__(256)
    fold_rows_kernel(const double* __restrict__ partial, int64_t ranges, int64_t n, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  double acc = 0.0;
  for (int64_t p = 0; p < ranges; ++p) acc += partial[p * n + i];
  out[i] = static_cast<float>(acc);
}

}  // namespace

namespace {

inline int64_t align16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// Column-tile ranges per row tile: the count that ends the launch on the
// fewest full waves of blocks (one block per SM), each range counted one
// tile longer for its pipeline fill and epilogue; ties go to fewer ranges.
void tc_ranges(int64_t n, int64_t m, int sms, int64_t* ranges, int64_t* tiles_per_range) {
  const int64_t row_tiles = (n + kTcRows - 1) / kTcRows;
  const int64_t col_tiles = (m + kTcCols - 1) / kTcCols;
  int64_t best_cost = -1;
  for (int64_t s = 1; s <= col_tiles && s <= kTcMaxRanges; ++s) {
    const int64_t per = (col_tiles + s - 1) / s;
    const int64_t used = (col_tiles + per - 1) / per;
    const int64_t waves = (row_tiles * used + sms - 1) / sms;
    const int64_t cost = waves * (per + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *ranges = used;
      *tiles_per_range = per;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, d] float32 row-major map, boxes of box_rows rows x 32 floats, 128-byte swizzle, zero fill.
bool tc_map(CUtensorMap* map, const void* base, int64_t rows, int64_t d, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kTcK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Scratch of the euclidean path: norms [n + m] float32, y_hi and y_lo
// [m, d] float32, partial row sums [ranges, n] float64.
int64_t euclid_scratch(int64_t n, int64_t m, int64_t d) {
  const int64_t col_tiles = (m + kTcCols - 1) / kTcCols;
  const int64_t most = col_tiles < kTcMaxRanges ? col_tiles : kTcMaxRanges;
  return align16((n + m) * 4) + 2 * align16(m * d * 4) + most * n * 8;
}

cudaError_t launch_euclid_tf32(int device, const float* x, const float* y, int64_t n, int64_t m, int64_t d,
                               bool zero_diag, float* out, uint8_t* scratch, cudaStream_t stream) {
  if (d % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      n > 0x7FFFFFFF || m > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;  // the wrapper pads and aligns (TMA needs 16-byte strides and bases)
  }
  float* norms = reinterpret_cast<float*>(scratch);
  float* y_hi = reinterpret_cast<float*>(scratch + align16((n + m) * 4));
  float* y_lo = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(y_hi) + align16(m * d * 4));
  double* partial = reinterpret_cast<double*>(reinterpret_cast<uint8_t*>(y_lo) + align16(m * d * 4));
  CUtensorMap x_map, hi_map, lo_map;
  if (!tc_map(&x_map, x, n, d, kTcRows) || !tc_map(&hi_map, y_hi, m, d, kTcCols) || !tc_map(&lo_map, y_lo, m, d, kTcCols)) {
    return cudaErrorNotSupported;
  }
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int64_t ranges = 1, per = 1;
  tc_ranges(n, m, sms, &ranges, &per);
  const int64_t prep_blocks = (n + m + 7) / 8 < 4096 ? (n + m + 7) / 8 : 4096;
  prep_kernel<<<static_cast<unsigned>(prep_blocks), 256, 0, stream>>>(x, y, n, m, d, norms, y_hi, y_lo);
  err = cudaFuncSetAttribute(euclid_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kTcRows - 1) / kTcRows), static_cast<unsigned>(ranges));
  euclid_tf32_kernel<<<grid, kTcThreads, kTcSmemBytes, stream>>>(x_map, hi_map, lo_map, norms, norms + n, n, m, d,
                                                                  zero_diag, per, partial);
  fold_rows_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(partial, ranges, n, out);
  return cudaGetLastError();
}

int64_t cosine_scratch(int64_t m, int64_t d) {
  return align16(m) + align16(cos_ranges(m) * d * 8) + align16(cos_ranges(m) * 8) + align16(d * 8) + 16;
}

template <typename T, typename O>
cudaError_t launch_cosine(const T* x, const T* y, int64_t n, int64_t m, int64_t d, bool zero_diag, O* out,
                          uint8_t* scratch, cudaStream_t stream) {
  const int64_t ranges = cos_ranges(m);
  uint8_t* flags = scratch;
  double* partial = reinterpret_cast<double*>(scratch + align16(m));
  int64_t* nan_partial = reinterpret_cast<int64_t*>(scratch + align16(m) + align16(ranges * d * 8));
  double* col_sum = reinterpret_cast<double*>(reinterpret_cast<uint8_t*>(nan_partial) + align16(ranges * 8));
  int64_t* nan_total = reinterpret_cast<int64_t*>(reinterpret_cast<uint8_t*>(col_sum) + align16(d * 8));
  const int64_t flag_blocks = (m + 7) / 8 < 4096 ? (m + 7) / 8 : 4096;
  cosine_nan_rows_kernel<T><<<static_cast<unsigned>(flag_blocks), kCosThreads, 0, stream>>>(y, m, d, flags);
  const int64_t col_blocks = (d + kCosCols - 1) / kCosCols;
  const int64_t rows_per_range = (m + ranges - 1) / ranges;
  cosine_col_partials_kernel<T><<<dim3(static_cast<unsigned>(col_blocks), static_cast<unsigned>(ranges)), kCosThreads, 0,
                                  stream>>>(y, m, d, rows_per_range, flags, partial, nan_partial);
  cosine_fold_kernel<<<static_cast<unsigned>((d + 31) / 32), kCosFoldThreads, 0, stream>>>(
      partial, nan_partial, ranges, d, col_sum, nan_total);
  const int64_t rows_per_block = (kCosThreads / 32) * kCosRowsPerWarp;
  constexpr int kE = 16 / sizeof(T);
  const unsigned blocks = static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block);
  if (d % kE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    cosine_rows_kernel<T, O, kE><<<blocks, kCosThreads, 0, stream>>>(x, y, n, m, d, zero_diag, flags, col_sum, nan_total, out);
  } else {
    cosine_rows_kernel<T, O, 1><<<blocks, kCosThreads, 0, stream>>>(x, y, n, m, d, zero_diag, flags, col_sum, nan_total, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch mt_pairwise_reduce needs for these arguments (codes as there).
int64_t mt_pairwise_scratch_bytes(int dtype, int op, int64_t n, int64_t m, int64_t d) {
  if (n <= 0 || m <= 0 || d <= 0) return 0;
  if (op == 1) return cosine_scratch(m, d);
  return dtype == 1 ? 0 : euclid_scratch(n, m, d);
}

// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16 (x and y alike), both
// row-major and contiguous; op: 0 euclidean (float32 or float64 only; for
// float32, d a multiple of 4 and 16-byte aligned bases), 1 cosine. out: [n]
// float64 for float64 inputs, else float32; every entry is written.
int mt_pairwise_reduce(int device, int dtype, int op, const void* x, const void* y, int64_t n, int64_t m,
                       int64_t d, int zero_diag, void* out, void* scratch, int64_t scratch_bytes, void* stream) {
  if (dtype < 0 || dtype > 3 || op < 0 || op > 1 || n < 0 || m < 0 || d < 0 || (op == 0 && (dtype == 2 || dtype == 3)) ||
      (n + kRows - 1) / kRows > 0x7FFFFFFF || scratch_bytes < mt_pairwise_scratch_bytes(dtype, op, n, m, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const bool zd = zero_diag != 0;
  const int64_t out_bytes = n * (dtype == 1 ? 8 : 4);
  if (m == 0 || d == 0) {  // no column, or every cell 0
    const cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  auto* sc = static_cast<uint8_t*>(scratch);
  cudaError_t err = cudaSuccess;
  if (op == 1) {
    switch (dtype) {
      case 0: err = launch_cosine(static_cast<const float*>(x), static_cast<const float*>(y), n, m, d, zd, static_cast<float*>(out), sc, s); break;
      case 1: err = launch_cosine(static_cast<const double*>(x), static_cast<const double*>(y), n, m, d, zd, static_cast<double*>(out), sc, s); break;
      case 2: err = launch_cosine(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y), n, m, d, zd, static_cast<float*>(out), sc, s); break;
      default: err = launch_cosine(static_cast<const __half*>(x), static_cast<const __half*>(y), n, m, d, zd, static_cast<float*>(out), sc, s); break;
    }
  } else if (dtype == 0) {
    err = launch_euclid_tf32(device, static_cast<const float*>(x), static_cast<const float*>(y), n, m, d, zd,
                             static_cast<float*>(out), sc, s);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
    pairwise_rows_kernel<double, double, 8, true><<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(x), static_cast<const double*>(y), n, m, d, zd, static_cast<double*>(out));
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
