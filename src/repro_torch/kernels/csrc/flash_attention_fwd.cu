// Flash attention forward (kernel K4): out and the f32 log-sum-exp.
//
// Replaces the TPU kernel `_fwd` / `_fwd_kernel` of
// src/repro/kernels/flash_attention.py (the forward of its
// `flash_attention` custom_vjp): causal / sliding-window GQA attention
// with a query offset,
//   out[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/G,j]) v[b,h/G,j]
//   lse[b,h,i] = m_i + log(l_i)        (m: row max of the scaled scores)
// over the keys j that row i may attend (j < Lk; j <= q_offset + i if
// causal; j > q_offset + i - window with a window).  Masked scores are the
// finite -2^30 and masked lanes get p = 0, so a fully masked row returns
// out 0 and lse -2^30 + log 1, as the reference's l_safe does.
//
// What bounds it on this card: operations.  At the training path's shapes
// (q/k (2,128,4096,192), v (2,128,4096,128), bf16, causal) it does
// 2 (Dqk + Dv) FLOP for each of the 8,390,656 causal (query, key) pairs of
// the 256 (batch, head) rows: 1.375 TFLOP, 1.39 ms at 989 TFLOP/s, while
// its bytes (q, k, v read once, out and lse written once: 0.74 GB) take
// 0.22 ms at 3.35 TB/s.
//
// What the design does about it.  The Pallas grid walks the key blocks
// in order and keeps (m, l, acc) in VMEM across grid steps; CTAs on
// Hopper run in no order, so here one CTA owns a tile of bq query rows of
// one (batch, head) and loops over the key tiles inside it, skipping the
// tiles wholly above the causal diagonal or outside the window (half the
// work at causal L = 4096).  Both products of a key tile (S = Q K^T, then
// O += P V) run on the tensor cores (bf16 WMMA, f32 accumulation); the
// running (m, l) and the output accumulator stay f32 in shared memory,
// so scores never reach device memory.
//
// Two routes, picked by the wrapper's plan (repro_torch/kernels/_launch.py,
// flash_fwd_plan) and passed in dims[13]:
//   * the tensor-core walk of flash_attention_fwd_tc.cuh (bf16, head dims
//     multiples of 16 up to 256, 16-byte aligned operands): 128 query rows
//     a CTA, mma.sync with S, P and O in registers, K and V double-buffered
//     with cp.async.  The training and contiguous-prefill paths run it;
//   * the WMMA kernel below, for everything else (f32 above all, and head
//     dims the walk does not take): S, P and O in shared memory, K and V
//     loaded synchronously.  Its tiles come from the plan (dims[14], [15])
//     and must be the ones choose_tiles picks.
//
// Layout: every tensor is (B, heads, L, D) with its own element strides
// for B, heads and L, and a contiguous last dimension, so the MLA path's
// (B, L, H, D) tensors are read in place (no transposing copy).
//
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface, called through ctypes by repro_torch/kernels/flash_attention.py.
#include "flash_attention_fwd_tc.cuh"
#include "flash_common.cuh"

namespace fa {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long long qs[3], ks[3], vs[3], os[3];   // strides of B, heads, L
  int H, G, Dqk, Dv, bq, bk;
  float scale;
  bool vec;
  Mask mask;
};

template <typename T>
size_t fwd_smem(int bq, int bk, int Dqk, int Dv) {
  return bytes_of<T>((size_t)bq * ld_of<T>(Dqk))        // q
         + bytes_of<T>((size_t)bk * ld_of<T>(Dqk))      // k
         + bytes_of<T>((size_t)bk * ld_of<T>(Dv))       // v
         + bytes_of<float>((size_t)bq * ldf_of(bk))     // s
         + bytes_of<T>((size_t)bq * ld_of<T>(bk))       // p
         + bytes_of<float>((size_t)bq * ldf_of(Dv))     // o
         + 3 * bytes_of<float>(bq);                     // m, l, corr
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bq = a.bq, bk = a.bk;
  const int ldq = ld_of<T>(a.Dqk), ldv = ld_of<T>(a.Dv);
  const int lds = ldf_of(bk), ldp = ld_of<T>(bk), ldo = ldf_of(a.Dv);
  const int Dqp = round16(a.Dqk), Dvp = round16(a.Dv);
  Carve c{smem_raw};
  T* q_s = c.take<T>((size_t)bq * ldq);
  T* k_s = c.take<T>((size_t)bk * ldq);
  T* v_s = c.take<T>((size_t)bk * ldv);
  float* s_s = c.take<float>((size_t)bq * lds);
  T* p_s = c.take<T>((size_t)bq * ldp);
  float* o_s = c.take<float>((size_t)bq * ldo);
  float* m_s = c.take<float>(bq);
  float* l_s = c.take<float>(bq);
  float* c_s = c.take<float>(bq);

  const Mask& mk = a.mask;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, mk.Lq - q0);
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1]
                + q0 * a.qs[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  load_tile<T>(q_s, ldq, qg, a.qs[2], nq, bq, a.Dqk, a.vec);
  for (int i = threadIdx.x; i < bq * ldo; i += kThreads) o_s[i] = 0.0f;
  for (int i = threadIdx.x; i < bq; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int k_lo, k_hi;
  mk.key_range(q0, q0 + nq, &k_lo, &k_hi);
  for (int k0 = k_lo / bk * bk; k0 < k_hi; k0 += bk) {
    __syncthreads();   // the previous tile fully consumed
    const int nk = min(bk, mk.Lk - k0);
    load_tile<T>(k_s, ldq, kg + k0 * a.ks[2], a.ks[2], nk, bk, a.Dqk, a.vec);
    load_tile<T>(v_s, ldv, vg + k0 * a.vs[2], a.vs[2], nk, bk, a.Dv, a.vec);
    __syncthreads();
    mm<T, false, true>(q_s, ldq, k_s, ldq, s_s, lds, bq, bk, Dqp, false);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < bq; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < bk; j += 32) {
        const float s = mk(q0 + r, k0 + j) ? s_s[r * lds + j] * a.scale
                                           : kNegInf;
        s_s[r * lds + j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
      for (int j = lane; j < bk; j += 32) {
        const float p = mk(q0 + r, k0 + j) ? expf(s_s[r * lds + j] - m_new)
                                           : 0.0f;
        p_s[r * ldp + j] = from_f32<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < bq * Dvp; i += kThreads) {
      const int r = i / Dvp, d = i % Dvp;
      o_s[r * ldo + d] *= c_s[r];
    }
    __syncthreads();
    mm<T, false, false>(p_s, ldp, v_s, ldv, o_s, ldo, bq, Dvp, bk, true);
  }
  __syncthreads();

  T* og = static_cast<T*>(a.out) + b * a.os[0] + h * a.os[1] + q0 * a.os[2];
  for (int i = threadIdx.x; i < nq * a.Dv; i += kThreads) {
    const int r = i / a.Dv, d = i % a.Dv;
    const float l = l_s[r];
    og[r * a.os[2] + d] = from_f32<T>(o_s[r * ldo + d] / (l == 0.0f ? 1.0f : l));
  }
  for (int r = threadIdx.x; r < nq; r += kThreads) {
    const float l = l_s[r];
    a.lse[(size_t)bh * mk.Lq + q0 + r] = m_s[r] + logf(l == 0.0f ? 1.0f : l);
  }
}

// Launch the WMMA kernel with the planned tiles (a.bq, a.bk), which must
// be choose_tiles' pick.
template <typename T>
int launch(FwdArgs a, int B, cudaStream_t stream) {
  size_t smem;
  int bq, bk;
  if (!choose_tiles([&](int bq_, int bk_) {
        return fwd_smem<T>(bq_, bk_, a.Dqk, a.Dv); }, &bq, &bk, &smem) ||
      bq != a.bq || bk != a.bk)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.mask.Lq + a.bq - 1) / a.bq, B * a.H);
  fwd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fa

// strides: 12 element strides, (B, heads, L) of q, k, v, out.
// dims: B, H, Hkv, Lq, Lk, Dqk, Dv, causal, has_window, window, q_offset,
//       dtype (0 = float32, 1 = bfloat16), vec (16-byte loads allowed),
//       route (1 = the tensor-core walk, 0 = WMMA), and the WMMA route's
//       tiles bq, bk.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const long long* strides, const int* dims,
                                   float scale, void* stream) {
  fa::FwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
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
  if (dims[13] == 1) {
    if (dims[11] != 1 || !a.vec || !(scale > 0.0f))
      return (int)cudaErrorInvalidValue;
    fa::tc::Args t{};
    t.q = static_cast<const __nv_bfloat16*>(q);
    t.k = static_cast<const __nv_bfloat16*>(k);
    t.v = static_cast<const __nv_bfloat16*>(v);
    t.out = static_cast<__nv_bfloat16*>(out);
    t.lse = a.lse;
    for (int i = 0; i < 3; ++i) {
      t.qs[i] = a.qs[i];
      t.ks[i] = a.ks[i];
      t.vs[i] = a.vs[i];
      t.os[i] = a.os[i];
    }
    t.H = a.H;
    t.G = a.G;
    t.Dqk = a.Dqk;
    t.Dv = a.Dv;
    t.scale = a.scale;
    t.mask = a.mask;
    return (int)fa::tc::launch(t, B, s);
  }
  a.bq = dims[14];
  a.bk = dims[15];
  if (dims[11] == 0) return fa::launch<float>(a, B, s);
  if (dims[11] == 1) return fa::launch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
