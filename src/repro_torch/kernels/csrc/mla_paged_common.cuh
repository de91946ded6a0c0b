// Shared device code of the three MLA attention kernels
// (mla_decode_paged.cu, mla_prefill_paged.cu, mla_decode.cu): the AMLA
// exponent-add rescale, the online-softmax tile update, the two ways a
// CTA reaches its request's latent rows (through a block table, or at a
// plain stride), the dequantizing loads of a quantized pool, and the
// host-side dispatch over element types.
//
// Absorbed MLA is multi-query attention with ONE latent KV head: every
// query row (a head, or a (chunk row, head) pair) attends the same
// {ckv | krope} rows of its request.  A CTA therefore owns kRows query
// rows of one request and walks that request's positions in tiles of
// kTile, staging each tile into shared memory once (converted to f32,
// and multiplied by its slot's scale for an int8 / fp8 pool) and reusing
// it for all kRows rows:
//
//   thread t = (row r = t / kTile, lane = t % kTile)
//   scores : thread (r, lane) computes the score of row r against the
//            tile's position lane (a Dl + Dr dot product from shared
//            memory); the row's 16 lanes sit in one half-warp, so the
//            row max and row sum are xor-shuffles within it;
//   PV     : thread (r, lane) owns output dims lane, lane + 16, ... of
//            row r and accumulates p[r, :] @ tile[:, dims] in registers.
//
// The running (m, l, acc) state is f32 in registers; tiles past the
// CTA's last valid position are never visited.  Plain CUDA-core FMAs, no
// tensor cores, no TMA, no split over the KV length: a simple kernel that
// is right first.  No f32 copy of a quantized pool exists anywhere but in
// the staged tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace mla {

constexpr int kRows = 16;                   // query rows per CTA
constexpr int kTile = 16;                   // positions per staged tile
constexpr int kThreads = kRows * kTile;     // 256
constexpr int kMaxDl = 512;                 // latent width the registers hold
constexpr int kAcc = kMaxDl / kTile;        // output dims per thread
constexpr float kNegInf = -1073741824.0f;   // -2^30: the finite mask value
constexpr float kInvLn2 = 1.4426950408889634f;

// Element loads in f32: the compute dtypes (f32, bf16) and the quantized
// pool's 1-byte codes (int8, fp8 e4m3, the layout of torch.float8_e4m3fn).
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x * 2**d for d <= 0 by adding d into the IEEE-754 exponent field.  Zero
// inputs and exponent underflow flush to 0; d <= 0 never reaches the sign.
__device__ __forceinline__ float exp_add_rescale(float x, int d) {
  const int bits = __float_as_int(x);
  const int exp_field = (bits >> 23) & 0xFF;
  const float shifted = __int_as_float(bits + d * (1 << 23));
  return (x != 0.0f && exp_field + d > 0) ? shifted : 0.0f;
}

// Reductions over the 16 lanes of one query row (a half-warp).  Every
// thread of the CTA calls them, so the full mask is always right.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kTile / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kTile / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One request's rows in the paged pool, reached through its block-table
// row bt.  P is the pool's element type.  With kScaled (an int8 / fp8
// pool) each element is multiplied in registers by its slot's f32 scale,
// read through the same block-table lookup as the row.  Entries outside
// [0, N) read as zeros.
template <typename P, bool kScaled>
struct PagedRows {
  const P* ckv;            // (N, bs, Dl)
  const P* krope;          // (N, bs, Dr)
  const float* ckv_s;      // (N, bs, 1), kScaled only
  const float* krope_s;
  const int* bt;           // (nb,)
  int nb, bs, N, Dl, Dr;

  __device__ int reach() const { return nb * bs; }

  __device__ float load(int p, int d) const {
    const int blk = bt[p / bs];
    if (blk < 0 || blk >= N) return 0.0f;
    const size_t slot = (size_t)blk * bs + p % bs;
    if (d < Dl) {
      const float v = to_f32(ckv[slot * Dl + d]);
      if constexpr (kScaled) return v * ckv_s[slot];
      return v;
    }
    const float v = to_f32(krope[slot * Dr + (d - Dl)]);
    if constexpr (kScaled) return v * krope_s[slot];
    return v;
  }
};

// One request's rows of the contiguous cache: position p of ckv at
// ckv + p * ckv_sp, its last dimension contiguous.  Any position stride,
// so a view of a larger cache needs no copy; S positions, no padding.
template <typename P>
struct DenseRows {
  const P* ckv;
  const P* krope;
  long long ckv_sp, krope_sp;
  int S, Dl;

  __device__ int reach() const { return S; }

  __device__ float load(int p, int d) const {
    return d < Dl ? to_f32(ckv[p * ckv_sp + d])
                  : to_f32(krope[p * krope_sp + (d - Dl)]);
  }
};

// Dynamic shared memory of one CTA, in bytes.
inline size_t smem_bytes(int D) {
  return sizeof(float) * (size_t(kRows + kTile) * (D + 1) + kRows * kTile);
}

// One CTA: query rows row0 .. row0 + n_rows - 1 of one request.  Row r
// belongs to chunk row c = (row0 + r) / H, attends positions <= start + c
// (and < rows.reach()), and is live only if c < nv (dead rows return
// exact zeros).  q and out point at the tile's first row; rows are
// contiguous, D = Dl + Dr wide in q and Dl wide in out.
template <typename T, bool kExpAdd, typename Rows>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            int row0, int n_rows, int H, int start, int nv,
                            const Rows& rows, int Dl, int Dr, float scale) {
  extern __shared__ float smem[];
  const int D = Dl + Dr;
  const int stride = D + 1;      // odd row stride: conflict-free columns
  float* q_s = smem;                        // [kRows][stride]
  float* kv_s = q_s + kRows * stride;       // [kTile][stride]
  float* p_s = kv_s + kTile * stride;       // [kRows][kTile]

  const int t = threadIdx.x;
  const int r = t / kTile;
  const int lane = t % kTile;

  for (int i = t; i < kRows * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    q_s[rr * stride + d] = rr < n_rows ? to_f32(q[(size_t)rr * D + d]) : 0.0f;
  }

  // the newest position any live row of this CTA attends
  const int c_first = row0 / H;
  const int c_last = (row0 + n_rows - 1) / H;
  int n_pos = 0;
  if (c_first < nv) n_pos = min(start + min(nv - 1, c_last) + 1, rows.reach());
  const int n_tiles = (max(n_pos, 0) + kTile - 1) / kTile;

  const int c = (row0 + r) / H;
  const bool row_live = r < n_rows && c < nv;
  const int limit = start + c;
  const int n_acc = Dl / kTile;

  float m = kNegInf, l = 0.0f;
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int p0 = tile * kTile;
    __syncthreads();   // q staged / the previous tile fully consumed
    for (int i = t; i < kTile * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int p = p0 + j;
      kv_s[j * stride + d] = p < n_pos ? rows.load(p, d) : 0.0f;
    }
    __syncthreads();

    // two-term score on the split cache, as the JAX kernels compute it
    const float* qr = q_s + r * stride;
    const float* kr = kv_s + lane * stride;
    float s_lat = 0.0f, s_rope = 0.0f;
    for (int d = 0; d < Dl; ++d) s_lat = fmaf(qr[d], kr[d], s_lat);
    for (int d = Dl; d < D; ++d) s_rope = fmaf(qr[d], kr[d], s_rope);
    const int p = p0 + lane;
    const bool valid = row_live && p <= limit && p < n_pos;
    const float s = valid ? (s_lat + s_rope) * scale : kNegInf;

    float pr;
    float corr = 1.0f;
    int d_i = 0;
    if constexpr (kExpAdd) {
      const float s2 = s * kInvLn2;
      const float m_new = ceilf(fmaxf(m, row_max(s2)));
      pr = valid ? exp2f(s2 - m_new) : 0.0f;
      d_i = (int)fminf(fmaxf(m - m_new, -254.0f), 0.0f);
      l = exp_add_rescale(l, d_i) + row_sum(pr);
      m = m_new;
    } else {
      const float m_new = fmaxf(m, row_max(s));
      pr = valid ? expf(s - m_new) : 0.0f;
      corr = expf(m - m_new);
      l = l * corr + row_sum(pr);
      m = m_new;
    }
    p_s[r * kTile + lane] = pr;
    __syncwarp();      // row r's 16 lanes live in one warp

    const float* pr_s = p_s + r * kTile;
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      if (k < n_acc) {
        const int d = lane + k * kTile;
        float a = kExpAdd ? exp_add_rescale(acc[k], d_i) : acc[k] * corr;
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          a = fmaf(pr_s[j], kv_s[j * stride + d], a);
        acc[k] = a;
      }
    }
  }

  if (r < n_rows) {
    const float l_safe = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      if (k < n_acc) {
        const int d = lane + k * kTile;
        out[(size_t)r * Dl + d] = from_f32<T>(acc[k] / l_safe);
      }
    }
  }
}

// ------------------------------------------------------ host dispatch --

template <typename T>
struct Type {
  using type = T;
};

// dtype codes of the C entry points (repro_torch/kernels/_launch.py)
constexpr int kF32 = 0, kBF16 = 1, kInt8 = 2, kFP8 = 3;

// f(Type<T>{}, integral_constant<bool, kExpAdd>{}) for the q / output
// dtype code (kF32, kBF16) and the rescale flag.
template <typename F>
cudaError_t dispatch_q(int dtype, int exp_add, F&& f) {
  auto rescale = [&](auto qt) -> cudaError_t {
    return exp_add ? f(qt, std::true_type{}) : f(qt, std::false_type{});
  };
  if (dtype == kF32) return rescale(Type<float>{});
  if (dtype == kBF16) return rescale(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// f(Type<T>{}, Type<P>{}, integral_constant<bool, kScaled>{},
//   integral_constant<bool, kExpAdd>{}): the pool is unquantized (P = T,
// pool_dtype == dtype) or quantized (kInt8 / kFP8 codes with scales).
template <typename F>
cudaError_t dispatch_pool(int dtype, int pool_dtype, int exp_add, F&& f) {
  return dispatch_q(dtype, exp_add, [&](auto qt, auto ea) -> cudaError_t {
    if (pool_dtype == dtype) return f(qt, qt, std::false_type{}, ea);
    if (pool_dtype == kInt8)
      return f(qt, Type<int8_t>{}, std::true_type{}, ea);
    if (pool_dtype == kFP8)
      return f(qt, Type<__nv_fp8_e4m3>{}, std::true_type{}, ea);
    return cudaErrorInvalidValue;
  });
}

// Set the CTA's dynamic shared memory and launch one CTA per (16 rows,
// request); returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, int n_rows, int B, int D,
                        cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + kRows - 1) / kRows, B);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace mla
