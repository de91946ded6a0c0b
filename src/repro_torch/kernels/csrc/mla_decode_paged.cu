// Paged absorbed-MLA flash-decode (kernel K1).
//
// Replaces the TPU kernel `mla_decode_paged_kernel` (Pallas body
// `_paged_kernel`) of src/repro/kernels/mla_decode.py: for each request b
// and head h,
//   o[b,h] = sum_j softmax_j(scale * (q_lat[b,h] . ckv_j + q_rope[b,h] . krope_j)) ckv_j
// over positions j <= indices[b], reached through block_tables[b, j / bs];
// an index of -1 gives a zero row.  f32 accumulation, output in q's dtype.
// The pool is in q's dtype (f32, bf16) or quantized (int8, fp8 e4m3) with
// one f32 scale per token slot, dequantized in registers as each tile is
// staged (mla_paged_common.cuh: PagedRows).
//
// What bounds it on this card: the bytes of the latent pool it reads.
// Each decode step reads every live request's (indices[b] + 1) x (Dl + Dr)
// cache rows once — at DeepSeek-V2 widths 1,152 bytes per token in bf16,
// 584 in int8 / fp8 with the two scales —
// against about 2 x 128 x 1,088 FLOP per token for all 128 heads, far
// below the card's 295 FLOP/byte ridge, so the 3.35 TB/s of HBM is the
// limit.  The design reads each cache row from HBM once per CTA of 16
// heads (8 CTAs per request at 128 heads; the repeats hit L2) and keeps
// scores and the softmax state on chip, so no (B, H, S) score tensor and
// no gathered (B, S) view of the pool ever reaches HBM.  It runs on CUDA
// cores; tensor cores (wgmma), TMA and split-KV come later.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/mla_decode.py.
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

}  // namespace mla

// dtype: q and out, 0 = float32, 1 = bfloat16.  pool_dtype: dtype for an
// unquantized pool, 2 = int8 or 3 = fp8 e4m3 with ckv_s / krope_s (N, bs,
// 1) f32 scales (null otherwise).  exp_add: 1 = AMLA rescale, 0 = mul.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int mla_decode_paged(const void* q, const void* ckv,
                                const void* krope, const void* ckv_s,
                                const void* krope_s, const void* bt,
                                const void* indices, void* out, int B, int H,
                                int Dl, int Dr, int N, int bs, int nb,
                                float scale, int dtype, int pool_dtype,
                                int exp_add, void* stream) {
  return (int)mla::dispatch_pool(
      dtype, pool_dtype, exp_add,
      [&](auto qt, auto pt, auto scaled, auto ea) -> cudaError_t {
        using T = typename decltype(qt)::type;
        using P = typename decltype(pt)::type;
        return mla::launch_rows(
            mla::decode_paged_kernel<T, P, decltype(scaled)::value,
                                     decltype(ea)::value>,
            H, B, Dl + Dr, static_cast<cudaStream_t>(stream),
            static_cast<const T*>(q), static_cast<const P*>(ckv),
            static_cast<const P*>(krope), static_cast<const float*>(ckv_s),
            static_cast<const float*>(krope_s), static_cast<const int*>(bt),
            static_cast<const int*>(indices), static_cast<T*>(out), H, Dl,
            Dr, N, bs, nb, scale);
      });
}
