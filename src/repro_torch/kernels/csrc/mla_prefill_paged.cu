// Paged absorbed-MLA chunked-prefill attention (kernel K2).
//
// Replaces the TPU kernel `mla_prefill_paged_kernel` (Pallas body
// `_prefill_kernel`) of src/repro/kernels/mla_prefill.py, the multi-query
// sibling of K1: chunk row c of request b attends pool positions
// <= lengths[b] + c through block_tables[b, :], with
//   o[b,c,h] = sum_j softmax_j(scale * (q_lat[b,c,h] . ckv_j + q_rope[b,c,h] . krope_j)) ckv_j.
// Rows with c >= n_valid[b], and idle requests (n_valid 0), return exact
// zeros.  The chunk's own latents are already in the pool, so the in-chunk
// causal triangle rides the same block-table walk.  The pool is in q's
// dtype or quantized (int8, fp8 e4m3 with per-slot f32 scales), as in K1.
//
// What bounds it on this card: operations.  A chunk of C rows x H heads
// reads the request's resident prefix once (1,152 bytes per token in bf16
// at DeepSeek-V2 widths) but does about 2 x C x H x 1,088 FLOP per token
// (C = 32, H = 128: ~7,800 FLOP per byte), far above the 295 FLOP/byte
// ridge.  This first version runs those products on CUDA cores in f32,
// not on the tensor cores, so it is far from that bound; what its design
// does keep is the memory side: each CTA of 16 (chunk row, head) rows
// stages every 16-position tile of the prefix in shared memory once and
// reuses it for all 16 rows, scores never leave the chip, and no gathered
// (B, S) view of the pool is written.  Tensor cores (wgmma over a 64-row
// tile of the C x H query rows), TMA and a larger row tile come later.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/mla_prefill.py.
#include "mla_paged_common.cuh"

namespace mla {

template <typename T, typename P, bool kScaled, bool kExpAdd>
__global__ void __launch_bounds__(kThreads)
prefill_paged_kernel(const T* __restrict__ q, const P* __restrict__ ckv,
                     const P* __restrict__ krope,
                     const float* __restrict__ ckv_s,
                     const float* __restrict__ krope_s,
                     const int* __restrict__ bt,
                     const int* __restrict__ lengths,
                     const int* __restrict__ n_valid, T* __restrict__ out,
                     int C, int H, int Dl, int Dr, int N, int bs, int nb,
                     float scale) {
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;     // flattened (chunk row, head)
  const int R = C * H;
  const int D = Dl + Dr;
  const PagedRows<P, kScaled> rows{ckv, krope, ckv_s, krope_s,
                                   bt + (size_t)b * nb, nb, bs, N, Dl, Dr};
  attend_rows<T, kExpAdd>(q + ((size_t)b * R + row0) * D,
                          out + ((size_t)b * R + row0) * Dl, row0,
                          min(kRows, R - row0), H, lengths[b], n_valid[b],
                          rows, Dl, Dr, scale);
}

}  // namespace mla

// dtype, pool_dtype, exp_add: as mla_decode_paged.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int mla_prefill_paged(const void* q, const void* ckv,
                                 const void* krope, const void* ckv_s,
                                 const void* krope_s, const void* bt,
                                 const void* lengths, const void* n_valid,
                                 void* out, int B, int C, int H, int Dl,
                                 int Dr, int N, int bs, int nb, float scale,
                                 int dtype, int pool_dtype, int exp_add,
                                 void* stream) {
  return (int)mla::dispatch_pool(
      dtype, pool_dtype, exp_add,
      [&](auto qt, auto pt, auto scaled, auto ea) -> cudaError_t {
        using T = typename decltype(qt)::type;
        using P = typename decltype(pt)::type;
        return mla::launch_rows(
            mla::prefill_paged_kernel<T, P, decltype(scaled)::value,
                                      decltype(ea)::value>,
            C * H, B, Dl + Dr, static_cast<cudaStream_t>(stream),
            static_cast<const T*>(q), static_cast<const P*>(ckv),
            static_cast<const P*>(krope), static_cast<const float*>(ckv_s),
            static_cast<const float*>(krope_s), static_cast<const int*>(bt),
            static_cast<const int*>(lengths),
            static_cast<const int*>(n_valid), static_cast<T*>(out), C, H,
            Dl, Dr, N, bs, nb, scale);
      });
}
