// Shared device code of the three flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu): tile loads, the masked-position test and
// the tile product.
//
// Every product of two tiles goes through mm(): C (f32, shared memory)
// [+]= A * B with A and B in shared memory, either operand read
// transposed.  For bf16 operands it runs on the tensor cores through the
// warp-level WMMA API (16x16x16 bf16 fragments, f32 accumulation; the 8
// warps of a CTA share out the 16x16 output tiles); for f32 operands it
// is a plain f32 FMA loop (exact f32, the reference's numerics).  Tiles
// are zero-padded to multiples of 16 along every dimension, so padding
// never adds anything.  Everything else (masking, the online softmax,
// rescaling) is f32 code on shared-memory tiles, the same for both types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace fa {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1073741824.0f;   // -2^30: the finite mask value
constexpr size_t kSmemMax = 232448;         // per-block opt-in limit, H100
constexpr size_t kSmemTwoPerSm = 113 * 1024;

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Row strides in shared memory: 16 extra bytes a row, which keeps every
// row 32-byte aligned (WMMA needs 256-bit aligned tile pointers) and
// shifts consecutive rows by four banks.
template <typename T>
__host__ __device__ inline int ld_of(int cols) {
  return round16(cols) + 16 / (int)sizeof(T);
}
__host__ __device__ inline int ldf_of(int cols) { return round16(cols) + 4; }

// Bytes of an array of n elements of T, rounded up to 128.
template <typename T>
__host__ __device__ inline size_t bytes_of(size_t n) {
  return (n * sizeof(T) + 127) / 128 * 128;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A bump allocator over the CTA's dynamic shared memory; every array
// starts 128-byte aligned.  The host sizes the launch with the same calls.
struct Carve {
  unsigned char* p;
  template <typename T>
  __device__ T* take(size_t n) {
    T* out = reinterpret_cast<T*>(p);
    p += bytes_of<T>(n);
    return out;
  }
};

// dst[r][d] = src[r * row_stride + d] for r < rows_valid, d < D, and 0
// elsewhere, for r < rows and d < round16(D).  With vec, every row of src
// starts 16-byte aligned and D is a multiple of 16 bytes: 16-byte loads.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                          long long row_stride, int rows_valid, int rows,
                          int D, bool vec) {
  const int Dp = round16(D);
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int n_chunks = Dp / E;
    for (int i = threadIdx.x; i < rows * n_chunks; i += kThreads) {
      const int r = i / n_chunks, d0 = (i % n_chunks) * E;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows_valid && d0 < D)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + d0);
      *reinterpret_cast<uint4*>(dst + r * ld + d0) = val;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * Dp; i += kThreads) {
    const int r = i / Dp, d = i % Dp;
    dst[r * ld + d] = (r < rows_valid && d < D) ? src[r * row_stride + d]
                                                : from_f32<T>(0.0f);
  }
}

// f32 row values of length n (lse or delta), zero past n_valid.
__device__ inline void load_rows(float* dst, const float* __restrict__ src,
                                 int n_valid, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = i < n_valid ? src[i] : 0.0f;
}

// Whether query row q (its absolute position q_pos) may attend key k.
struct Mask {
  int Lq, Lk, causal, has_window, window, q_offset;
  __device__ __forceinline__ bool operator()(int q, int k) const {
    const int q_pos = q_offset + q;
    bool ok = q < Lq && k < Lk;
    if (causal) ok = ok && k <= q_pos;
    if (has_window) ok = ok && k > q_pos - window;
    return ok;
  }
  // Keys [lo, hi) that some query row of [q0, q1) may attend.
  __device__ void key_range(int q0, int q1, int* lo, int* hi) const {
    int l = 0, h = Lk;
    if (causal) h = min(h, q_offset + q1 - 1 + 1);
    if (has_window) l = max(l, q_offset + q0 - window + 1);
    *lo = l;
    *hi = max(h, l);
  }
  // Query rows [lo, hi) that may attend some key of [k0, k1).
  __device__ void query_range(int k0, int k1, int* lo, int* hi) const {
    int l = 0, h = Lq;
    if (causal) l = max(l, k0 - q_offset);
    if (has_window) h = min(h, k1 - 1 + window - q_offset);
    *lo = l;
    *hi = max(h, l);
  }
};

// C (M x N, f32, row stride ldc) = [C +] A (M x K) * B (K x N), where
// A(m, k) = TA ? A[k * lda + m] : A[m * lda + k] and
// B(k, n) = TB ? B[n * ldb + k] : B[k * ldb + n].  M, N and K are
// multiples of 16; every thread of the CTA calls it; no barrier inside.
template <typename T, bool TA, bool TB>
__device__ void mm(const T* A, int lda, const T* B, int ldb, float* C,
                   int ldc, int M, int N, int K, bool accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    namespace w = nvcuda::wmma;
    using LA = std::conditional_t<TA, w::col_major, w::row_major>;
    using LB = std::conditional_t<TB, w::col_major, w::row_major>;
    const int warp = threadIdx.x / 32;
    const int tn = N / 16;
    for (int t = warp; t < (M / 16) * tn; t += kWarps) {
      const int i = t / tn, j = t % tn;
      float* cp = C + i * 16 * ldc + j * 16;
      w::fragment<w::accumulator, 16, 16, 16, float> c;
      if (accumulate)
        w::load_matrix_sync(c, cp, ldc, w::mem_row_major);
      else
        w::fill_fragment(c, 0.0f);
      for (int k = 0; k < K; k += 16) {
        w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
        w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
        w::load_matrix_sync(a, TA ? A + k * lda + i * 16
                                  : A + i * 16 * lda + k, lda);
        w::load_matrix_sync(b, TB ? B + j * 16 * ldb + k
                                  : B + k * ldb + j * 16, ldb);
        w::mma_sync(c, a, b, c);
      }
      w::store_matrix_sync(cp, c, ldc, w::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N, n = idx % N;
      float s = accumulate ? C[m * ldc + n] : 0.0f;
      for (int k = 0; k < K; ++k) {
        const float a = TA ? A[k * lda + m] : A[m * lda + k];
        const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = s;
    }
  }
}

// Reductions over a warp.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tile sizes (query rows, keys) for a launch: the first candidate whose
// shared memory fits two CTAs on an SM, else the first that fits one.
// smem(bq, bk) gives the bytes; returns false if none fits.
template <typename F>
inline bool choose_tiles(F smem, int* bq, int* bk, size_t* bytes) {
  static const int cand[][2] = {{64, 64}, {64, 32}, {32, 64}, {32, 32},
                                {16, 32}, {32, 16}, {16, 16}};
  const size_t limits[2] = {kSmemTwoPerSm, kSmemMax};
  for (size_t limit : limits) {
    for (const auto& c : cand) {
      const size_t s = smem(c[0], c[1]);
      if (s <= limit) {
        *bq = c[0];
        *bk = c[1];
        *bytes = s;
        return true;
      }
    }
  }
  return false;
}

}  // namespace fa
