// Flash attention backward, key and value gradients (kernel K6).
//
// Replaces the TPU kernel `_dkv_kernel` (the second pallas_call of
// `_flash_bwd`) of src/repro/kernels/flash_attention.py:
//   dV[b,hk,j] = sum_{g, i} P_ij dO_i
//   dK[b,hk,j] = sum_{g, i} scale * P_ij (dO_i . v_j - delta_i) q_i
// summed over the G = H / Hkv query heads h = hk * G + g of the key head
// and over every query row i that may attend key j (masked lanes: P = 0).
//
// What bounds it on this card: operations.  Four products per (query,
// key) pair -- S = Q K^T and dK += dS^T Q (Dqk), dP = dO V^T and
// dV += P^T dO (Dv) -- give 2 (2 Dqk + 2 Dv) FLOP a pair: 2.75 TFLOP at the
// training path's shapes (B 2, H 128, L 4096, Dqk 192, Dv 128, causal),
// 2.78 ms at 989 TFLOP/s; its bytes (k, v, dK, dV once, q, dO, lse and
// delta once: 1.02 GB) take 0.30 ms at 3.35 TB/s.
//
// What the design does about it.  One CTA owns a tile of keys of one
// (batch, key head) and loops over the G query heads and all query tiles
// inside it, skipping tiles the mask removes wholly, so dK and dV are
// written once: no atomics, no second pass.  (The Pallas grid did the
// same with its sequential (g, q-block) axes.)  Two routes, picked by
// the wrapper's plan (repro_torch/kernels/_launch.py, flash_bwd_plan)
// and passed in dims[13]:
//   * the tensor-core walk dkv_tc_kernel of flash_attention_bwd_tc.cuh
//     (bf16, head dims multiples of 16 up to 256, 16-byte aligned
//     operands): 64 keys a CTA, 64-query tiles double-buffered with
//     cp.async, mma.sync with the scores in registers, P^T and dS^T once
//     through shared memory in bf16, dK and dV in registers.  The
//     training path runs it;
//   * the WMMA kernel below for everything else (f32 above all): the
//     four products on WMMA (bf16) or f32 FMAs, with S, dP, P, dS and the
//     dK / dV accumulators in shared memory.  Its tiles come from the
//     plan (dims[14], [15]) and must be the ones choose_tiles picks.
// P and dS are rounded to bf16 only for the accumulating products on
// both bf16 routes.  Strided (B, heads, L, D) operands, as the forward.
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/flash_attention.py.
#include "flash_attention_bwd_tc.cuh"
#include "flash_common.cuh"

namespace fa {

struct DkvArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dk;
  void* dv;
  long long qs[3], ks[3], vs[3], dos[3], dks[3], dvs[3];
  int Hkv, G, Dqk, Dv, bq, bk;
  float scale;
  bool vec;
  Mask mask;
};

template <typename T>
size_t dkv_smem(int bq, int bk, int Dqk, int Dv) {
  return bytes_of<T>((size_t)bk * ld_of<T>(Dqk))        // k
         + bytes_of<T>((size_t)bk * ld_of<T>(Dv))       // v
         + bytes_of<float>((size_t)bk * ldf_of(Dqk))    // dk
         + bytes_of<float>((size_t)bk * ldf_of(Dv))     // dv
         + bytes_of<T>((size_t)bq * ld_of<T>(Dqk))      // q
         + bytes_of<T>((size_t)bq * ld_of<T>(Dv))       // dO
         + 2 * bytes_of<float>((size_t)bq * ldf_of(bk)) // s, dp
         + 2 * bytes_of<T>((size_t)bq * ld_of<T>(bk))   // p, ds
         + 2 * bytes_of<float>(bq);                     // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const DkvArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bq = a.bq, bk = a.bk;
  const int ldq = ld_of<T>(a.Dqk), ldv = ld_of<T>(a.Dv);
  const int lds = ldf_of(bk), ldp = ld_of<T>(bk);
  const int ldgk = ldf_of(a.Dqk), ldgv = ldf_of(a.Dv);
  const int Dqp = round16(a.Dqk), Dvp = round16(a.Dv);
  Carve c{smem_raw};
  T* k_s = c.take<T>((size_t)bk * ldq);
  T* v_s = c.take<T>((size_t)bk * ldv);
  float* dk_s = c.take<float>((size_t)bk * ldgk);
  float* dv_s = c.take<float>((size_t)bk * ldgv);
  T* q_s = c.take<T>((size_t)bq * ldq);
  T* do_s = c.take<T>((size_t)bq * ldv);
  float* s_s = c.take<float>((size_t)bq * lds);
  float* dp_s = c.take<float>((size_t)bq * lds);
  T* p_s = c.take<T>((size_t)bq * ldp);
  T* ds_s = c.take<T>((size_t)bq * ldp);
  float* lse_s = c.take<float>(bq);
  float* dl_s = c.take<float>(bq);

  const Mask& mk = a.mask;
  const int bhk = blockIdx.y;
  const int b = bhk / a.Hkv, hk = bhk % a.Hkv;
  const int H = a.Hkv * a.G;
  const int k0 = blockIdx.x * bk;
  const int nk = min(bk, mk.Lk - k0);

  load_tile<T>(k_s, ldq, static_cast<const T*>(a.k) + b * a.ks[0]
               + hk * a.ks[1] + k0 * a.ks[2], a.ks[2], nk, bk, a.Dqk, a.vec);
  load_tile<T>(v_s, ldv, static_cast<const T*>(a.v) + b * a.vs[0]
               + hk * a.vs[1] + k0 * a.vs[2], a.vs[2], nk, bk, a.Dv, a.vec);
  for (int i = threadIdx.x; i < bk * ldgk; i += kThreads) dk_s[i] = 0.0f;
  for (int i = threadIdx.x; i < bk * ldgv; i += kThreads) dv_s[i] = 0.0f;

  int q_lo, q_hi;
  mk.query_range(k0, k0 + nk, &q_lo, &q_hi);
  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const T* dog = static_cast<const T*>(a.dout) + b * a.dos[0]
                   + h * a.dos[1];
    const float* lseg = a.lse + ((size_t)b * H + h) * mk.Lq;
    const float* dlg = a.delta + ((size_t)b * H + h) * mk.Lq;
    for (int q0 = q_lo / bq * bq; q0 < q_hi; q0 += bq) {
      __syncthreads();   // the previous query tile fully consumed
      const int nq = min(bq, mk.Lq - q0);
      load_tile<T>(q_s, ldq, qg + q0 * a.qs[2], a.qs[2], nq, bq, a.Dqk,
                   a.vec);
      load_tile<T>(do_s, ldv, dog + q0 * a.dos[2], a.dos[2], nq, bq, a.Dv,
                   a.vec);
      load_rows(lse_s, lseg + q0, nq, bq);
      load_rows(dl_s, dlg + q0, nq, bq);
      __syncthreads();
      mm<T, false, true>(q_s, ldq, k_s, ldq, s_s, lds, bq, bk, Dqp, false);
      mm<T, false, true>(do_s, ldv, v_s, ldv, dp_s, lds, bq, bk, Dvp, false);
      __syncthreads();
      for (int i = threadIdx.x; i < bq * bk; i += kThreads) {
        const int r = i / bk, j = i % bk;
        const float p = mk(q0 + r, k0 + j)
                            ? expf(s_s[r * lds + j] * a.scale - lse_s[r])
                            : 0.0f;
        p_s[r * ldp + j] = from_f32<T>(p);
        ds_s[r * ldp + j] =
            from_f32<T>(p * (dp_s[r * lds + j] - dl_s[r]) * a.scale);
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q (the transposed operand read in place)
      mm<T, true, false>(p_s, ldp, do_s, ldv, dv_s, ldgv, bk, Dvp, bq, true);
      mm<T, true, false>(ds_s, ldp, q_s, ldq, dk_s, ldgk, bk, Dqp, bq, true);
    }
  }
  __syncthreads();

  T* gk = static_cast<T*>(a.dk) + b * a.dks[0] + hk * a.dks[1]
          + k0 * a.dks[2];
  T* gv = static_cast<T*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1]
          + k0 * a.dvs[2];
  for (int i = threadIdx.x; i < nk * a.Dqk; i += kThreads) {
    const int r = i / a.Dqk, d = i % a.Dqk;
    gk[r * a.dks[2] + d] = from_f32<T>(dk_s[r * ldgk + d]);
  }
  for (int i = threadIdx.x; i < nk * a.Dv; i += kThreads) {
    const int r = i / a.Dv, d = i % a.Dv;
    gv[r * a.dvs[2] + d] = from_f32<T>(dv_s[r * ldgv + d]);
  }
}

// Launch the WMMA kernel with the planned tiles (a.bq, a.bk), which must
// be choose_tiles' pick.
template <typename T>
int launch(DkvArgs a, int B, cudaStream_t stream) {
  size_t smem;
  int bq, bk;
  if (!choose_tiles([&](int bq_, int bk_) {
        return dkv_smem<T>(bq_, bk_, a.Dqk, a.Dv); }, &bq, &bk, &smem) ||
      bq != a.bq || bk != a.bk)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.mask.Lk + a.bk - 1) / a.bk, B * a.Hkv);
  dkv_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fa

// strides: 18 element strides, (B, heads, L) of q, k, v, dout, dk, dv.
// dims: as flash_attention_bwd_dq (route in dims[13], the plan's tiles,
//       query rows and keys, in dims[14], [15]).  lse and delta:
//       (B, H, Lq) f32, contiguous.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* strides,
                                       const int* dims, float scale,
                                       void* stream) {
  fa::DkvArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.dos[i] = strides[9 + i];
    a.dks[i] = strides[12 + i];
    a.dvs[i] = strides[15 + i];
  }
  const int B = dims[0];
  a.Hkv = dims[2];
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
    if (dims[11] != 1 || !a.vec || !(scale > 0.0f) ||
        a.bq != fa::tcb::kQueries || a.bk != fa::tcb::kKeys)
      return (int)cudaErrorInvalidValue;
    fa::tcb::Args t{};
    t.q = static_cast<const __nv_bfloat16*>(q);
    t.k = static_cast<const __nv_bfloat16*>(k);
    t.v = static_cast<const __nv_bfloat16*>(v);
    t.dout = static_cast<const __nv_bfloat16*>(dout);
    t.lse = a.lse;
    t.delta = a.delta;
    t.dk = static_cast<__nv_bfloat16*>(dk);
    t.dv = static_cast<__nv_bfloat16*>(dv);
    for (int i = 0; i < 3; ++i) {
      t.qs[i] = a.qs[i];
      t.ks[i] = a.ks[i];
      t.vs[i] = a.vs[i];
      t.dos[i] = a.dos[i];
      t.dks[i] = a.dks[i];
      t.dvs[i] = a.dvs[i];
    }
    t.H = dims[1];
    t.G = a.G;
    t.Dqk = a.Dqk;
    t.Dv = a.Dv;
    t.scale = scale;
    t.mask = a.mask;
    return (int)fa::tcb::launch_dkv(t, B, s);
  }
  if (dims[11] == 0) return fa::launch<float>(a, B, s);
  if (dims[11] == 1) return fa::launch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
