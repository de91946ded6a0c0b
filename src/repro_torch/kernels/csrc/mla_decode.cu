// Contiguous-cache absorbed-MLA flash-decode (kernel K3).
//
// Replaces the TPU kernel `mla_decode_kernel` (Pallas body `_kernel`) of
// src/repro/kernels/mla_decode.py: for each request b and head h,
//   o[b,h] = sum_{j <= index} softmax_j(scale * (q_lat[b,h] . ckv[b,j] + q_rope[b,h] . krope[b,j])) ckv[b,j]
// over one latent cache per request, ckv (B, S, Dl) and krope (B, S, Dr)
// in q's dtype (f32, bf16), with one scalar `index` shared by the batch
// (a host int: reading a device scalar back would sync every step).
// Positions past `index` are never read; a negative index gives zero rows.
// f32 accumulation, output in q's dtype.
//
// What bounds it on this card: the bytes of the cache it reads, (index + 1)
// x (Dl + Dr) per request (1,152 bytes per token in bf16 at DeepSeek-V2
// widths) against ~2 x 128 x 1,088 FLOP per token for all 128 heads, far
// below the 295 FLOP/byte ridge, so the 3.35 TB/s of HBM is the limit.
//
// bf16 q runs the tensor-core split-KV walk of mla_decode_tc.cuh
// (DenseSrc: rows at ckv + b * ckv_sb + j * ckv_ss): a CTA takes 64 heads
// of one request and one range of its positions, stages 64-position tiles
// with 16-byte cp.async (double-buffered), multiplies on the tensor cores
// and writes an f32 partial; the combine kernel merges the splits.  Since
// `index` is a host int, the wrapper picks the split count that fills the
// card for exactly index + 1 positions.  The strides are taken as given
// (multiples of 8 elements, 16-byte aligned rows), so a view of a larger
// cache needs no copy, and S is taken as it is: the ragged last tile is
// zero-filled by the copy, not padded (the Pallas wrapper pads S to a
// multiple of its 512-position block, a copy of the whole cache every
// call).  f32 q keeps the CUDA-core walk `attend_rows` of
// mla_paged_common.cuh (16 heads a CTA, 16-position tiles, f32 FMAs):
// TF32 tensor cores would not hold f32's bound.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/mla_decode.py.
#include "mla_decode_tc.cuh"
#include "mla_paged_common.cuh"

namespace mla {

template <typename T, bool kExpAdd>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ ckv,
              const T* __restrict__ krope, T* __restrict__ out, int H,
              int S, int Dl, int Dr, long long ckv_sb, long long ckv_ss,
              long long krope_sb, long long krope_ss, int index,
              float scale) {
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * kRows;
  const int D = Dl + Dr;
  const DenseRows<T> rows{ckv + b * ckv_sb, krope + b * krope_sb, ckv_ss,
                          krope_ss, S, Dl};
  // every head sits at chunk row 0 of a one-row chunk starting at index
  attend_rows<T, kExpAdd>(q + ((size_t)b * H + h0) * D,
                          out + ((size_t)b * H + h0) * Dl, h0,
                          min(kRows, H - h0), H, index, index >= 0 ? 1 : 0,
                          rows, Dl, Dr, scale);
}

// bf16 q: one CTA per (64 heads, split, request); its f32 partial goes to
// the workspace (ws_acc (B, H, n_split, Dl), ws_ml (B, H, n_split, 2)).
template <bool kExpAdd>
__global__ void __launch_bounds__(tc::kThreadsTC, 1)
decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ ckv,
                 const __nv_bfloat16* __restrict__ krope,
                 float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                 int H, int S, int Dl, int Dr, long long ckv_sb,
                 long long ckv_ss, long long krope_sb, long long krope_ss,
                 int index, int split_pos, float scale) {
  const int b = blockIdx.z, s = blockIdx.y, n_split = gridDim.y;
  const int h0 = blockIdx.x * tc::kRowsTC;
  const size_t row0 = (size_t)b * H + h0;
  const tc::DenseSrc<__nv_bfloat16> src{ckv + b * ckv_sb, krope + b * krope_sb,
                                        ckv_ss, krope_ss};
  tc::attend_split<__nv_bfloat16, false, kExpAdd>(
      q + row0 * (Dl + Dr), ws_acc + row0 * n_split * Dl,
      ws_ml + row0 * n_split * 2, src, min(tc::kRowsTC, H - h0),
      index < 0 ? 0 : min(index + 1, S), s, n_split, split_pos, Dl, Dr,
      scale);
}

}  // namespace mla

// dtype: q, the cache and out, 0 = float32, 1 = bfloat16.  Strides are in
// elements (batch, position); the last dimension is contiguous.  exp_add:
// 1 = AMLA rescale, 0 = mul.  n_split > 0 (bf16 only) runs the tensor-core
// walk with n_split splits of split_pos positions and the f32 workspace
// ws (B * H * n_split * (Dl + 2) floats); n_split = 0 runs attend_rows.
// Returns the cudaError_t of the launches.
extern "C" int mla_decode(const void* q, const void* ckv, const void* krope,
                          void* out, int B, int H, int S, int Dl, int Dr,
                          long long ckv_sb, long long ckv_ss,
                          long long krope_sb, long long krope_ss, int index,
                          float scale, int dtype, int exp_add, void* ws,
                          int n_split, int split_pos, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    if (dtype != mla::kBF16 ||
        !mla::tc::shape_ok(Dl, Dr, n_split, split_pos))
      return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    float* acc = static_cast<float*>(ws);
    float* ml = acc + (size_t)B * H * n_split * Dl;
    const size_t smem = mla::tc::layout(Dl, Dr, false, false).total;
    auto run = [&](auto ea) -> cudaError_t {
      constexpr bool kEA = decltype(ea)::value;
      return mla::tc::launch_split(
          mla::tc::combine_kernel<kEA>, mla::decode_tc_kernel<kEA>, smem, B,
          H, n_split, Dl, acc, ml,
          static_cast<bf16*>(out), st, static_cast<const bf16*>(q),
          static_cast<const bf16*>(ckv), static_cast<const bf16*>(krope),
          acc, ml, H, S, Dl, Dr, ckv_sb, ckv_ss, krope_sb, krope_ss, index,
          split_pos, scale);
    };
    return (int)(exp_add ? run(std::true_type{}) : run(std::false_type{}));
  }
  return (int)mla::dispatch_q(
      dtype, exp_add, [&](auto qt, auto ea) -> cudaError_t {
        using T = typename decltype(qt)::type;
        return mla::launch_rows(
            mla::decode_kernel<T, decltype(ea)::value>, H, B, Dl + Dr, st,
            static_cast<const T*>(q), static_cast<const T*>(ckv),
            static_cast<const T*>(krope), static_cast<T*>(out), H, S, Dl, Dr,
            ckv_sb, ckv_ss, krope_sb, krope_ss, index, scale);
      });
}
