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
// Absorbed MLA is MQA with one latent head, so this is K1 with the block
// table replaced by a plain stride: the same CTA layout (one CTA for 16
// heads of one request, 16-position tiles staged in shared memory once
// for all 16 rows, (m, l, acc) in registers; mla_paged_common.cuh), with
// rows read at ckv + b * ckv_sb + j * ckv_ss (DenseRows).  The strides
// are taken as given, so a view of a larger cache needs no copy, and S is
// taken as it is: the ragged last tile is masked, not padded (the Pallas
// wrapper pads S to a multiple of its 512-position block, a copy of the
// whole cache every call).  At B = 8, H = 128 it launches 64 CTAs on the
// 132 SMs, as K1 does; split-KV, tensor cores and TMA come later.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/mla_decode.py.
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

}  // namespace mla

// dtype: q, the cache and out, 0 = float32, 1 = bfloat16.  Strides are in
// elements (batch, position); the last dimension is contiguous.  exp_add:
// 1 = AMLA rescale, 0 = mul.  Returns the cudaError_t of the launch.
extern "C" int mla_decode(const void* q, const void* ckv, const void* krope,
                          void* out, int B, int H, int S, int Dl, int Dr,
                          long long ckv_sb, long long ckv_ss,
                          long long krope_sb, long long krope_ss, int index,
                          float scale, int dtype, int exp_add, void* stream) {
  return (int)mla::dispatch_q(
      dtype, exp_add, [&](auto qt, auto ea) -> cudaError_t {
        using T = typename decltype(qt)::type;
        return mla::launch_rows(
            mla::decode_kernel<T, decltype(ea)::value>, H, B, Dl + Dr,
            static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
            static_cast<const T*>(ckv), static_cast<const T*>(krope),
            static_cast<T*>(out), H, S, Dl, Dr, ckv_sb, ckv_ss, krope_sb,
            krope_ss, index, scale);
      });
}
