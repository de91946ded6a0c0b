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
// ridge, so the tensor cores are the limit.
//
// bf16 q runs the tensor-core split-KV walk of mla_decode_tc.cuh
// (PagedSrc), as K1 does: decode is the one-row chunk of this walk.  A CTA
// takes 64 heads of one (request b, chunk row c), whose q rows are
// contiguous in (B, C, H, Dl + Dr), and walks b's positions <= lengths[b]
// + c through b's block-table row in 64-position tiles staged with
// 16-byte cp.async (double-buffered; int8 / fp8 codes converted to bf16
// in shared memory, their scales applied after the product); both
// products run on mma.sync.  The grid is (H / 64, n_split, B * C): the
// wrapper plans the splits over the table's reach (nb x bs, a host
// number) for B * C rows of heads, so at serving loads (B * C = 256) one
// split covers it.  A row with c >= n_valid[b] (and every row of an idle
// request) has no position: each of its splits writes l = 0 and the
// combine (prefill_combine_kernel, a name of its own so profiles tell it
// from K1's) writes exact zeros.  Each tile is read once for 64 heads;
// the 32 chunk rows of a request read the same prefix, from L2 after the
// first.  f32 q keeps the CUDA-core walk `attend_rows` of
// mla_paged_common.cuh (16 (chunk row, head) rows a CTA, 16-position
// tiles, f32 FMAs): TF32 tensor cores would not hold f32's bound.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/mla_prefill.py.
#include "mla_decode_tc.cuh"
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

// bf16 q: one CTA per (64 heads, split, (request, chunk row)); its f32
// partial goes to the workspace (ws_acc (B, C, H, n_split, Dl), ws_ml
// (B, C, H, n_split, 2)).
template <typename P, bool kScaled, bool kExpAdd>
__global__ void __launch_bounds__(tc::kThreadsTC, 1)
prefill_paged_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const P* __restrict__ ckv,
                        const P* __restrict__ krope,
                        const float* __restrict__ ckv_s,
                        const float* __restrict__ krope_s,
                        const int* __restrict__ bt,
                        const int* __restrict__ lengths,
                        const int* __restrict__ n_valid,
                        float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                        int C, int H, int Dl, int Dr, int N, int bs, int nb,
                        int split_pos, float scale) {
  const int bc = blockIdx.z, s = blockIdx.y, n_split = gridDim.y;
  const int b = bc / C, c = bc % C;
  const int h0 = blockIdx.x * tc::kRowsTC;
  const size_t row0 = (size_t)bc * H + h0;
  // chunk row c attends positions <= lengths[b] + c; a row past n_valid
  // attends none
  const int n_pos = c < n_valid[b] ? min(lengths[b] + c + 1, nb * bs) : 0;
  const tc::PagedSrc<P> src{ckv, krope, ckv_s, krope_s, bt + (size_t)b * nb,
                            nb, bs, N, Dl, Dr};
  tc::attend_split<P, kScaled, kExpAdd>(
      q + row0 * (Dl + Dr), ws_acc + row0 * n_split * Dl,
      ws_ml + row0 * n_split * 2, src, min(tc::kRowsTC, H - h0), n_pos, s,
      n_split, split_pos, Dl, Dr, scale);
}

// The combine of K2's splits: grid B * C * H, 128 threads.
template <bool kExpAdd>
__global__ void __launch_bounds__(128)
prefill_combine_kernel(const float* __restrict__ acc,
                       const float* __restrict__ ml,
                       __nv_bfloat16* __restrict__ out, int n_split, int Dl) {
  tc::combine_row<kExpAdd>(acc, ml, out, n_split, Dl);
}

}  // namespace mla

// dtype, pool_dtype, exp_add: as mla_decode_paged.  n_split > 0 (bf16 q
// only) runs the tensor-core walk with n_split splits of split_pos
// positions and the f32 workspace ws (B * C * H * n_split * (Dl + 2)
// floats); n_split = 0 runs attend_rows.  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int mla_prefill_paged(const void* q, const void* ckv,
                                 const void* krope, const void* ckv_s,
                                 const void* krope_s, const void* bt,
                                 const void* lengths, const void* n_valid,
                                 void* out, int B, int C, int H, int Dl,
                                 int Dr, int N, int bs, int nb, float scale,
                                 int dtype, int pool_dtype, int exp_add,
                                 void* ws, int n_split, int split_pos,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    if (dtype != mla::kBF16 ||
        !mla::tc::shape_ok(Dl, Dr, n_split, split_pos) ||
        (long long)B * C > 65535)     // grid.z
      return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    float* acc = static_cast<float*>(ws);
    float* ml = acc + (size_t)B * C * H * n_split * Dl;
    auto run = [&](auto pt, auto scaled, auto ea) -> cudaError_t {
      using P = typename decltype(pt)::type;
      constexpr bool kS = decltype(scaled)::value;
      constexpr bool kEA = decltype(ea)::value;
      const size_t smem = mla::tc::layout(Dl, Dr, kS, true).total;
      // B * C rows of heads: the walk's "requests" are (b, c) pairs
      return mla::tc::launch_split(
          mla::prefill_combine_kernel<kEA>,
          mla::prefill_paged_tc_kernel<P, kS, kEA>, smem, B * C, H, n_split,
          Dl, acc, ml, static_cast<bf16*>(out), st,
          static_cast<const bf16*>(q), static_cast<const P*>(ckv),
          static_cast<const P*>(krope), static_cast<const float*>(ckv_s),
          static_cast<const float*>(krope_s), static_cast<const int*>(bt),
          static_cast<const int*>(lengths), static_cast<const int*>(n_valid),
          acc, ml, C, H, Dl, Dr, N, bs, nb, split_pos, scale);
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
            mla::prefill_paged_kernel<T, P, decltype(scaled)::value,
                                      decltype(ea)::value>,
            C * H, B, Dl + Dr, st, static_cast<const T*>(q),
            static_cast<const P*>(ckv), static_cast<const P*>(krope),
            static_cast<const float*>(ckv_s),
            static_cast<const float*>(krope_s), static_cast<const int*>(bt),
            static_cast<const int*>(lengths),
            static_cast<const int*>(n_valid), static_cast<T*>(out), C, H,
            Dl, Dr, N, bs, nb, scale);
      });
}
