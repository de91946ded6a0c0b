// Flash attention backward, query gradient (kernel K5).
//
// Replaces the TPU kernel `_dq_kernel` (the first pallas_call of
// `_flash_bwd`) of src/repro/kernels/flash_attention.py:
//   dQ[b,h,i] = sum_j scale * P_ij (dO_i . v_j - delta_i) k_j,
//   P_ij = exp(scale * q_i . k_j - lse_i),   delta_i = dO_i . O_i,
// over the keys j row i may attend (the forward's mask); masked lanes give
// P = 0.  delta is a PyTorch reduction outside the kernel, as the
// reference computes it outside any pallas_call.
//
// What bounds it on this card: operations.  Three products per (query,
// key) pair -- S = Q K^T (Dqk), dP = dO V^T (Dv), dQ += dS K (Dqk) -- give
// 2 (2 Dqk + Dv) FLOP a pair: 2.20 TFLOP at the training path's shapes
// (B 2, H 128, L 4096, Dqk 192, Dv 128, causal), 2.22 ms at 989 TFLOP/s;
// its bytes (q, dO, lse, delta and dQ once, k and v once: 1.02 GB) take
// 0.30 ms at 3.35 TB/s.
//
// What the design does about it.  One CTA owns a tile of query rows of
// one (batch, head) and loops over the key tiles inside it (the Pallas
// grid's sequential key axis becomes this loop), skipping tiles the mask
// removes wholly, so the CTA writes dQ once and needs no atomics.  Two
// routes, picked by the wrapper's plan (repro_torch/kernels/_launch.py,
// flash_bwd_plan) and passed in dims[13]:
//   * the tensor-core walk dq_tc_kernel of flash_attention_bwd_tc.cuh
//     (bf16, head dims multiples of 16 up to 256, 16-byte aligned
//     operands): 128 query rows a CTA (64 for wide head dims), mma.sync
//     with S, dP, dS and dQ in registers, K and V double-buffered with
//     cp.async.  The training path runs it;
//   * the WMMA kernel below for everything else (f32 above all): the
//     three products on WMMA (bf16) or f32 FMAs, with S, dP, dS and the
//     dQ accumulator in shared memory.  Its tiles come from the plan
//     (dims[14], [15]) and must be the ones choose_tiles picks.
// Strided (B, heads, L, D) operands, as the forward.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/flash_attention.py.
#include "flash_attention_bwd_tc.cuh"
#include "flash_common.cuh"

namespace fa {

struct DqArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  long long qs[3], ks[3], vs[3], dos[3], dqs[3];
  int H, G, Dqk, Dv, bq, bk;
  float scale;
  bool vec;
  Mask mask;
};

template <typename T>
size_t dq_smem(int bq, int bk, int Dqk, int Dv) {
  return bytes_of<T>((size_t)bq * ld_of<T>(Dqk))        // q
         + bytes_of<T>((size_t)bq * ld_of<T>(Dv))       // dO
         + bytes_of<T>((size_t)bk * ld_of<T>(Dqk))      // k
         + bytes_of<T>((size_t)bk * ld_of<T>(Dv))       // v
         + 2 * bytes_of<float>((size_t)bq * ldf_of(bk)) // s, dp
         + bytes_of<T>((size_t)bq * ld_of<T>(bk))       // ds
         + bytes_of<float>((size_t)bq * ldf_of(Dqk))    // dq
         + 2 * bytes_of<float>(bq);                     // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const DqArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bq = a.bq, bk = a.bk;
  const int ldq = ld_of<T>(a.Dqk), ldv = ld_of<T>(a.Dv);
  const int lds = ldf_of(bk), ldp = ld_of<T>(bk), ldg = ldf_of(a.Dqk);
  const int Dqp = round16(a.Dqk), Dvp = round16(a.Dv);
  Carve c{smem_raw};
  T* q_s = c.take<T>((size_t)bq * ldq);
  T* do_s = c.take<T>((size_t)bq * ldv);
  T* k_s = c.take<T>((size_t)bk * ldq);
  T* v_s = c.take<T>((size_t)bk * ldv);
  float* s_s = c.take<float>((size_t)bq * lds);
  float* dp_s = c.take<float>((size_t)bq * lds);
  T* ds_s = c.take<T>((size_t)bq * ldp);
  float* dq_s = c.take<float>((size_t)bq * ldg);
  float* lse_s = c.take<float>(bq);
  float* dl_s = c.take<float>(bq);

  const Mask& mk = a.mask;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, mk.Lq - q0);
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  load_tile<T>(q_s, ldq, static_cast<const T*>(a.q) + b * a.qs[0]
               + h * a.qs[1] + q0 * a.qs[2], a.qs[2], nq, bq, a.Dqk, a.vec);
  load_tile<T>(do_s, ldv, static_cast<const T*>(a.dout) + b * a.dos[0]
               + h * a.dos[1] + q0 * a.dos[2], a.dos[2], nq, bq, a.Dv,
               a.vec);
  load_rows(lse_s, a.lse + (size_t)bh * mk.Lq + q0, nq, bq);
  load_rows(dl_s, a.delta + (size_t)bh * mk.Lq + q0, nq, bq);
  for (int i = threadIdx.x; i < bq * ldg; i += kThreads) dq_s[i] = 0.0f;

  int k_lo, k_hi;
  mk.key_range(q0, q0 + nq, &k_lo, &k_hi);
  for (int k0 = k_lo / bk * bk; k0 < k_hi; k0 += bk) {
    __syncthreads();   // the previous tile fully consumed
    const int nk = min(bk, mk.Lk - k0);
    load_tile<T>(k_s, ldq, kg + k0 * a.ks[2], a.ks[2], nk, bk, a.Dqk, a.vec);
    load_tile<T>(v_s, ldv, vg + k0 * a.vs[2], a.vs[2], nk, bk, a.Dv, a.vec);
    __syncthreads();
    mm<T, false, true>(q_s, ldq, k_s, ldq, s_s, lds, bq, bk, Dqp, false);
    mm<T, false, true>(do_s, ldv, v_s, ldv, dp_s, lds, bq, bk, Dvp, false);
    __syncthreads();
    for (int i = threadIdx.x; i < bq * bk; i += kThreads) {
      const int r = i / bk, j = i % bk;
      const float p = mk(q0 + r, k0 + j)
                          ? expf(s_s[r * lds + j] * a.scale - lse_s[r])
                          : 0.0f;
      ds_s[r * ldp + j] =
          from_f32<T>(p * (dp_s[r * lds + j] - dl_s[r]) * a.scale);
    }
    __syncthreads();
    mm<T, false, false>(ds_s, ldp, k_s, ldq, dq_s, ldg, bq, Dqp, bk, true);
  }
  __syncthreads();

  T* g = static_cast<T*>(a.dq) + b * a.dqs[0] + h * a.dqs[1] + q0 * a.dqs[2];
  for (int i = threadIdx.x; i < nq * a.Dqk; i += kThreads) {
    const int r = i / a.Dqk, d = i % a.Dqk;
    g[r * a.dqs[2] + d] = from_f32<T>(dq_s[r * ldg + d]);
  }
}

// Launch the WMMA kernel with the planned tiles (a.bq, a.bk), which must
// be choose_tiles' pick.
template <typename T>
int launch(DqArgs a, int B, cudaStream_t stream) {
  size_t smem;
  int bq, bk;
  if (!choose_tiles([&](int bq_, int bk_) {
        return dq_smem<T>(bq_, bk_, a.Dqk, a.Dv); }, &bq, &bk, &smem) ||
      bq != a.bq || bk != a.bk)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.mask.Lq + a.bq - 1) / a.bq, B * a.H);
  dq_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fa

// strides: 15 element strides, (B, heads, L) of q, k, v, dout, dq.
// dims: as flash_attention_fwd: B, H, Hkv, Lq, Lk, Dqk, Dv, causal,
//       has_window, window, q_offset, dtype, vec, route (1 = the
//       tensor-core walk, 0 = WMMA) and the plan's tiles (query rows,
//       keys).  lse and delta: (B, H, Lq) f32, contiguous.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, const long long* strides,
                                      const int* dims, float scale,
                                      void* stream) {
  fa::DqArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.dos[i] = strides[9 + i];
    a.dqs[i] = strides[12 + i];
  }
  const int B = dims[0];
  a.H = dims[1];
  a.G = dims[1] / dims[2];
  a.Dqk = dims[5];
  a.Dv = dims[6];
  a.scale = scale;
  a.vec = dims[12] != 0;
  a.mask = fa::Mask{dims[3], dims[4], dims[7], dims[8], dims[9], dims[10]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.bq = dims[14];
  a.bk = dims[15];
  if (dims[13] == 1) {
    if (dims[11] != 1 || !a.vec || !(scale > 0.0f) || a.bk != fa::tcb::kKeys)
      return (int)cudaErrorInvalidValue;
    fa::tcb::Args t{};
    t.q = static_cast<const __nv_bfloat16*>(q);
    t.k = static_cast<const __nv_bfloat16*>(k);
    t.v = static_cast<const __nv_bfloat16*>(v);
    t.dout = static_cast<const __nv_bfloat16*>(dout);
    t.lse = a.lse;
    t.delta = a.delta;
    t.dq = static_cast<__nv_bfloat16*>(dq);
    for (int i = 0; i < 3; ++i) {
      t.qs[i] = a.qs[i];
      t.ks[i] = a.ks[i];
      t.vs[i] = a.vs[i];
      t.dos[i] = a.dos[i];
      t.dqs[i] = a.dqs[i];
    }
    t.H = a.H;
    t.G = a.G;
    t.Dqk = a.Dqk;
    t.Dv = a.Dv;
    t.scale = scale;
    t.mask = a.mask;
    return (int)fa::tcb::launch_dq(t, B, a.bq, s);
  }
  if (dims[11] == 0) return fa::launch<float>(a, B, s);
  if (dims[11] == 1) return fa::launch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
