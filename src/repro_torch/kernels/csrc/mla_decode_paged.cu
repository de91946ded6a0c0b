// Paged absorbed-MLA flash-decode (kernel K1).
//
// Replaces the TPU kernel `mla_decode_paged_kernel` (Pallas body
// `_paged_kernel`) of src/repro/kernels/mla_decode.py: for each request b
// and head h,
//   o[b,h] = sum_j softmax_j(scale * (q_lat[b,h] . ckv_j + q_rope[b,h] . krope_j)) ckv_j
// over positions j <= indices[b], reached through block_tables[b, j / bs];
// an index of -1 gives a zero row.  f32 accumulation, output in q's dtype.
// The pool is in q's dtype (f32, bf16) or quantized (int8, fp8 e4m3) with
// one f32 scale per token slot.
//
// What bounds it on this card: the bytes of the latent pool it reads.
// Each decode step reads every live request's (indices[b] + 1) x (Dl + Dr)
// cache rows once — at DeepSeek-V2 widths 1,152 bytes per token in bf16,
// 584 in int8 / fp8 with the two scales —
// against about 2 x 128 x 1,088 FLOP per token for all 128 heads, far
// below the card's 295 FLOP/byte ridge, so the 3.35 TB/s of HBM is the
// limit.
//
// bf16 q runs the tensor-core split-KV walk of mla_decode_tc.cuh
// (PagedSrc): a CTA takes 64 heads of one request and one range of its
// positions and stages 64-position tiles, whole pages of the pool, with
// 16-byte cp.async (double-buffered; int8 / fp8 codes are converted to
// bf16 in shared memory and their scales applied after the product).  It
// reads each block-table entry of a tile once, one tile ahead.  The
// split count comes from the block table's width (nb x bs, a host
// number), so no device value is read back: a CTA whose range starts past
// indices[b] writes an empty partial, and the combine kernel merges the
// rest.  f32 q keeps the CUDA-core walk `attend_rows` of
// mla_paged_common.cuh (PagedRows: 16 heads a CTA, 16-position tiles
// gathered through the block table, dequantized in registers, f32 FMAs):
// TF32 tensor cores would not hold f32's bound.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/mla_decode.py.
#include "mla_decode_tc.cuh"
#include "mla_paged_common.cuh"

namespace mla {

template <typename T, typename P, bool kScaled, bool kExpAdd>
__global__ void __launch_bounds__(kThreads)
decode_paged_kernel(const T* __restrict__ q, const P* __restrict__ ckv,
                    const P* __restrict__ krope,
                    const float* __restrict__ ckv_s,
                    const float* __restrict__ krope_s,
                    const int* __restrict__ bt,
                    const int* __restrict__ indices, T* __restrict__ out,
                    int H, int Dl, int Dr, int N, int bs, int nb,
                    float scale) {
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * kRows;
  const int idx = indices[b];
  const int D = Dl + Dr;
  const PagedRows<P, kScaled> rows{ckv, krope, ckv_s, krope_s,
                                   bt + (size_t)b * nb, nb, bs, N, Dl, Dr};
  // decode is the one-row chunk of the prefill walk: every head sits at
  // chunk row 0, attends positions <= idx, and is live iff idx >= 0
  attend_rows<T, kExpAdd>(q + ((size_t)b * H + h0) * D,
                          out + ((size_t)b * H + h0) * Dl, h0,
                          min(kRows, H - h0), H, idx, idx >= 0 ? 1 : 0, rows,
                          Dl, Dr, scale);
}

// bf16 q: one CTA per (64 heads, split, request); its f32 partial goes to
// the workspace (ws_acc (B, H, n_split, Dl), ws_ml (B, H, n_split, 2)).
template <typename P, bool kScaled, bool kExpAdd>
__global__ void __launch_bounds__(tc::kThreadsTC, 1)
decode_paged_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const P* __restrict__ ckv, const P* __restrict__ krope,
                       const float* __restrict__ ckv_s,
                       const float* __restrict__ krope_s,
                       const int* __restrict__ bt,
                       const int* __restrict__ indices,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int H, int Dl, int Dr, int N, int bs, int nb,
                       int split_pos, float scale) {
  const int b = blockIdx.z, s = blockIdx.y, n_split = gridDim.y;
  const int h0 = blockIdx.x * tc::kRowsTC;
  const size_t row0 = (size_t)b * H + h0;
  const int idx = indices[b];
  const tc::PagedSrc<P> src{ckv, krope, ckv_s, krope_s, bt + (size_t)b * nb,
                            nb, bs, N, Dl, Dr};
  tc::attend_split<P, kScaled, kExpAdd>(
      q + row0 * (Dl + Dr), ws_acc + row0 * n_split * Dl,
      ws_ml + row0 * n_split * 2, src, min(tc::kRowsTC, H - h0),
      idx < 0 ? 0 : min(idx + 1, nb * bs), s, n_split, split_pos, Dl, Dr,
      scale);
}

}  // namespace mla

// dtype: q and out, 0 = float32, 1 = bfloat16.  pool_dtype: dtype for an
// unquantized pool, 2 = int8 or 3 = fp8 e4m3 with ckv_s / krope_s (N, bs,
// 1) f32 scales (null otherwise).  exp_add: 1 = AMLA rescale, 0 = mul.
// n_split > 0 (bf16 q only) runs the tensor-core walk with n_split splits
// of split_pos positions and the f32 workspace ws (B * H * n_split *
// (Dl + 2) floats); n_split = 0 runs attend_rows.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int mla_decode_paged(const void* q, const void* ckv,
                                const void* krope, const void* ckv_s,
                                const void* krope_s, const void* bt,
                                const void* indices, void* out, int B, int H,
                                int Dl, int Dr, int N, int bs, int nb,
                                float scale, int dtype, int pool_dtype,
                                int exp_add, void* ws, int n_split,
                                int split_pos, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    if (dtype != mla::kBF16 ||
        !mla::tc::shape_ok(Dl, Dr, n_split, split_pos))
      return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    float* acc = static_cast<float*>(ws);
    float* ml = acc + (size_t)B * H * n_split * Dl;
    auto run = [&](auto pt, auto scaled, auto ea) -> cudaError_t {
      using P = typename decltype(pt)::type;
      constexpr bool kS = decltype(scaled)::value;
      constexpr bool kEA = decltype(ea)::value;
      const size_t smem = mla::tc::layout(Dl, Dr, kS, true).total;
      return mla::tc::launch_split(
          mla::tc::combine_kernel<kEA>,
          mla::decode_paged_tc_kernel<P, kS, kEA>, smem, B, H, n_split, Dl,
          acc, ml, static_cast<bf16*>(out), st, static_cast<const bf16*>(q),
          static_cast<const P*>(ckv), static_cast<const P*>(krope),
          static_cast<const float*>(ckv_s),
          static_cast<const float*>(krope_s), static_cast<const int*>(bt),
          static_cast<const int*>(indices), acc, ml, H, Dl, Dr, N, bs, nb,
          split_pos, scale);
    };
    auto rescale = [&](auto pt, auto scaled) -> cudaError_t {
      return exp_add ? run(pt, scaled, std::true_type{})
                     : run(pt, scaled, std::false_type{});
    };
    if (pool_dtype == mla::kBF16)
      return (int)rescale(mla::Type<bf16>{}, std::false_type{});
    if (pool_dtype == mla::kInt8)
      return (int)rescale(mla::Type<int8_t>{}, std::true_type{});
    if (pool_dtype == mla::kFP8)
      return (int)rescale(mla::Type<__nv_fp8_e4m3>{}, std::true_type{});
    return (int)cudaErrorInvalidValue;
  }
  return (int)mla::dispatch_pool(
      dtype, pool_dtype, exp_add,
      [&](auto qt, auto pt, auto scaled, auto ea) -> cudaError_t {
        using T = typename decltype(qt)::type;
        using P = typename decltype(pt)::type;
        return mla::launch_rows(
            mla::decode_paged_kernel<T, P, decltype(scaled)::value,
                                     decltype(ea)::value>,
            H, B, Dl + Dr, st, static_cast<const T*>(q),
            static_cast<const P*>(ckv), static_cast<const P*>(krope),
            static_cast<const float*>(ckv_s),
            static_cast<const float*>(krope_s), static_cast<const int*>(bt),
            static_cast<const int*>(indices), static_cast<T*>(out), H, Dl,
            Dr, N, bs, nb, scale);
      });
}
