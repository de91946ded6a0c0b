// The tensor-core walks of the flash-attention backward for bf16 operands:
// K5 (dQ, dq_tc_kernel) and K6 (dK and dV, dkv_tc_kernel), on mma.sync
// with every accumulator in registers.  Launched by
// flash_attention_bwd_dq.cu / flash_attention_bwd_dkv.cu when the
// wrapper's plan says so (repro_torch/kernels/_launch.py,
// flash_bwd_plan); f32 and other head dims keep the WMMA kernels there.
// Two kernels, as the reference has two pallas_calls: each output is
// written once by the CTA that owns it, so there are no atomics and the
// gradients are deterministic.
//
// Both recompute, for a (query, key) pair the mask admits,
//   p  = exp2(s c - lse log2(e))           c = scale log2(e), s = q . k
//   dS = p (dP - delta) scale              dP = dO . v
// one FFMA and one exp2f for p: lse (the forward's, f32) is known, so
// there is no running max and nothing to rescale.  p and dS stay f32 and
// are rounded to bf16 only as operands of the accumulating products
// (dQ += dS K, dV += P^T dO, dK += dS^T Q), which accumulate in f32, as
// the WMMA kernels and the plain versions do.
//
// K5 (dq_tc_kernel) is the forward walk (flash_attention_fwd_tc.cuh) with
// a second score product and no online softmax.  A CTA takes 128 query
// rows of one (batch, head) (64 when Dqk > 192 or Dv > 128, for shared
// memory), a warp one 16-row block.  The query and dO tiles are staged
// once; the key and value tiles of 64 keys are double-buffered with
// 16-byte cp.async (tile t+1 lands while tile t is multiplied).  For a
// key tile a warp runs S = Q K^T and dP = dO V^T into registers (A from
// the staged Q / dO, B from K / V through ldmatrix), p and dS in place,
// then dQ += dS K with dS packed to bf16 straight from the C fragments
// into the A fragments (the forward's P trick) and K's B fragments
// through ldmatrix.trans.  dQ lives in registers: 96 f32 a thread at
// Dqk 192, beside S and dP (32 each).  Query tiles are launched longest
// first (blockIdx.x reversed).
//
// K6 (dkv_tc_kernel) is the transposed walk, in FlashAttention-2's
// layout.  A CTA owns 64 keys of one (batch, key head) and walks the G
// query heads and, for each, the 64-query tiles Mask::query_range admits
// (Q, dO, lse and delta of tile t+1 copied while tile t is multiplied).
// For a query tile:
//   phase 1  the 8 warps split the (64 keys x 64 queries) score tile into
//            (16 keys x 32 queries) blocks: S^T = K Q^T, dP^T = V dO^T
//            with the keys as the M dimension; P^T and dS^T, rounded to
//            bf16 once, go to one swizzled shared-memory tile each;
//   phase 2  the warps split (keys x D): a warp owns 32 keys (two 16-row
//            blocks) and a quarter of Dqk and of Dv and runs dV += P^T dO,
//            dK += dS^T Q, A from the P^T / dS^T tiles through ldmatrix,
//            B from dO / Q through ldmatrix.trans, each B fragment feeding
//            both row blocks.
// dK and dV (64 x 192 + 64 x 128 f32) live in registers, 80 f32 a
// thread, and are written once.  Key tiles are launched in order: key
// tile 0 sees every query under a causal mask, so the longest go first.
//
// Masking, both walks: tiles no row of the CTA may attend are never
// visited (Mask::key_range / query_range); a warp skips a block none of
// its rows (K5) or none of its (key, query) pairs (K6) may attend; pairs
// are masked, exactly, only in blocks the causal diagonal, the window
// edge, Lk (and for K6 Lq) cut, behind a warp-uniform branch.  A masked
// pair gets p = 0 without evaluating exp2f: a row that attends no key
// has lse = -2^30, and exp2f of its scores would be inf.  Rows past Lq
// and keys past Lk are zero-filled by the copies, never read from device
// memory; K5 never writes rows past Lq (their lse and delta are taken as
// 0, so they stay finite) and K6 masks them.  flash_dq_walk and
// flash_dkv_walk in repro_torch/kernels/_launch.py mirror these
// decisions for the CPU tests.
//
// Operands: (B, heads, L, D) with element strides for B, heads and L, the
// last dimension contiguous; the wrapper routes here only bf16 with Dqk
// and Dv multiples of 16 up to 256, 16-byte aligned pointers, strides
// that are multiples of 8 elements and a positive scale.
#pragma once

#include "flash_common.cuh"
#include "tc_primitives.cuh"

namespace fa {
namespace tcb {

using namespace ::hopper;   // swz, copy_tile_rows, ldsm4(_t), mma, ...
using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;      // K5: keys a staged tile; K6: keys a CTA
constexpr int kQueries = 64;   // K6: queries a staged tile
constexpr int kMaxD = 256;     // Dqk and Dv the walks take
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round64(int x) { return (x + 63) / 64 * 64; }

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;     // (B, H, Lq), contiguous
  const float* delta;   // (B, H, Lq), contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long qs[3], ks[3], vs[3], dos[3], dqs[3], dks[3], dvs[3];
  int H, G, Dqk, Dv;
  float scale;
  Mask mask;
};

// What the walks take (the wrapper checks alignment and strides): head
// dims multiples of 16 up to 256.
inline bool shape_ok(int Dqk, int Dv) {
  return Dqk > 0 && Dv > 0 && Dqk % 16 == 0 && Dv % 16 == 0 &&
         Dqk <= kMaxD && Dv <= kMaxD;
}

// Query rows of a K5 CTA: 128, or 64 for head dims whose staged tiles
// would not fit shared memory at 128 (_launch.flash_dq_tc_rows).
inline int dq_rows(int Dqk, int Dv) {
  return Dqk <= 192 && Dv <= 128 ? 128 : 64;
}

// ------------------------------------------------------------------ K5 ---

// Shared memory of a K5 CTA of `rows` query rows: the query and dO tiles,
// then two (key, value) tile pairs.  Row strides are rounded up to 64
// elements so the swizzle stays inside a row.
inline size_t dq_smem(int rows, int Dqk, int Dv) {
  const size_t Dsq = round64(Dqk), Dsv = round64(Dv);
  return ((size_t)rows + 2 * kKeys) * (Dsq + Dsv) * sizeof(bf16);
}

// kWarps: warps a CTA (16 query rows each); kQK: 16-deep steps of Dqk
// (Dqk <= 16 kQK); kVK: of Dv.  All compile-time, so the loops unroll.
template <int kWarps, int kQK, int kVK>
__global__ void __launch_bounds__(32 * kWarps, 1) dq_tc_kernel(const Args a) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = 16 * kWarps;
  constexpr int kSTiles = kKeys / 8;        // 8-key score tiles
  extern __shared__ __align__(128) unsigned char fa_tcb_smem[];
  const int Dsq = round64(a.Dqk), Dsv = round64(a.Dv);
  bf16* q_s = reinterpret_cast<bf16*>(fa_tcb_smem);
  bf16* do_s = q_s + kRows * Dsq;
  bf16* kv_s = do_s + kRows * Dsv;          // K_0, V_0, K_1, V_1
  const int kv_step = kKeys * (Dsq + Dsv);

  const Mask& mk = a.mask;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // longest first
  const int nq = min(kRows, mk.Lq - q0);
  const bf16* kg = a.k + b * a.ks[0] + hk * a.ks[1];
  const bf16* vg = a.v + b * a.vs[0] + hk * a.vs[1];

  int k_lo, k_hi;
  mk.key_range(q0, q0 + nq, &k_lo, &k_hi);
  const int t0 = k_lo / kKeys;
  const int n_kt = k_hi > k_lo ? (k_hi - 1) / kKeys - t0 + 1 : 0;
  auto copy_kv = [&](int t) {
    const int k0 = (t0 + t) * kKeys;
    bf16* k_s = kv_s + (t & 1) * kv_step;
    copy_tile_rows<kKeys, kThreads>(k_s, Dsq, kg + k0 * a.ks[2], a.ks[2],
                               mk.Lk - k0, a.Dqk);
    copy_tile_rows<kKeys, kThreads>(k_s + kKeys * Dsq, Dsv, vg + k0 * a.vs[2],
                               a.vs[2], mk.Lk - k0, a.Dv);
  };
  copy_tile_rows<kRows, kThreads>(
      q_s, Dsq, a.q + b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2], a.qs[2], nq,
      a.Dqk);
  copy_tile_rows<kRows, kThreads>(
      do_s, Dsv, a.dout + b * a.dos[0] + h * a.dos[1] + q0 * a.dos[2],
      a.dos[2], nq, a.Dv);
  if (n_kt > 0) copy_kv(0);
  cp_commit();

  const float c = a.scale * kLog2e;
  const int r0 = q0 + 16 * warp;            // the warp's first query row
  // lse log2(e) and delta of this thread's rows g and g + 8 (0 past Lq:
  // those rows are never written and stay finite)
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    const bool ok = r < mk.Lq;
    lse2[i] = ok ? a.lse[(size_t)bh * mk.Lq + r] * kLog2e : 0.0f;
    dl[i] = ok ? a.delta[(size_t)bh * mk.Lq + r] : 0.0f;
  }
  int w_lo = 0, w_hi = 0;                   // keys the warp's rows see
  if (r0 < mk.Lq) mk.key_range(r0, min(r0 + 16, mk.Lq), &w_lo, &w_hi);
  const bool warp_live = w_hi > w_lo;

  float dq[2 * kQK][4];
#pragma unroll
  for (int n = 0; n < 2 * kQK; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  const int a_row = 16 * warp + (lane & 15);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int t_row = (lane & 7) + 8 * ((lane >> 3) & 1);

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = (t0 + t) * kKeys;
    cp_wait_all();
    __syncthreads();        // K_t, V_t landed; every warp is done with t-1
    if (t + 1 < n_kt) copy_kv(t + 1);
    cp_commit();
    if (!(warp_live && k0 < w_hi && k0 + kKeys > w_lo)) continue;
    const bf16* k_s = kv_s + (t & 1) * kv_step;
    const bf16* v_s = k_s + kKeys * Dsq;

    // ---- S = Q K^T and dP = dO V^T: the warp's 16 rows, 64 keys
    float s[kSTiles][4], dp[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < 16 * kQK; kk += 16) {
      if (kk >= a.Dqk) break;
      uint32_t af[4];
      ldsm4(af, q_s + swz(a_row, kk + 8 * (lane >> 4), Dsq));
#pragma unroll
      for (int np = 0; np < kSTiles / 2; ++np) {
        uint32_t bfr[4];
        ldsm4(bfr, k_s + swz(16 * np + b_row, kk + 8 * ((lane >> 3) & 1),
                             Dsq));
        mma(s[2 * np], af, bfr[0], bfr[1]);
        mma(s[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 16 * kVK; kk += 16) {
      if (kk >= a.Dv) break;
      uint32_t af[4];
      ldsm4(af, do_s + swz(a_row, kk + 8 * (lane >> 4), Dsv));
#pragma unroll
      for (int np = 0; np < kSTiles / 2; ++np) {
        uint32_t bfr[4];
        ldsm4(bfr, v_s + swz(16 * np + b_row, kk + 8 * ((lane >> 3) & 1),
                             Dsv));
        mma(dp[2 * np], af, bfr[0], bfr[1]);
        mma(dp[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }

    // ---- p and dS in place of S (f32).  Whether the diagonal, the
    // window edge or Lk cuts the tile for one of the warp's rows
    // (warp-uniform); only then are pairs masked, each row against its
    // own limits lo <= key <= hi
    const bool edge =
        k0 + kKeys > mk.Lk ||
        (mk.causal && k0 + kKeys - 1 > mk.q_offset + r0) ||
        (mk.has_window && k0 <= mk.q_offset + r0 + 15 - mk.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q_pos = mk.q_offset + r0 + g + 8 * i;
        const int hi = mk.causal ? min(mk.Lk - 1, q_pos) : mk.Lk - 1;
        const int lo = mk.has_window ? q_pos - mk.window + 1 : 0;
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * n + 2 * c4 + e;
            const float p =
                key < lo || key > hi
                    ? 0.0f
                    : exp2f(fmaf(s[n][2 * i + e], c, -lse2[i]));
            s[n][2 * i + e] = p * (dp[n][2 * i + e] - dl[i]) * a.scale;
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[n][e], c, -lse2[e >> 1]));
          s[n][e] = p * (dp[n][e] - dl[e >> 1]) * a.scale;
        }
      }
    }

    // ---- dQ += dS K: key steps of 16, dS's A fragments from registers
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < kQK; ++np) {
        if (16 * np < a.Dqk) {
          uint32_t bfr[4];
          ldsm4_t(bfr, k_s + swz(16 * ks + t_row, 16 * np + 8 * (lane >> 4),
                                 Dsq));
          mma(dq[2 * np], pa, bfr[0], bfr[1]);
          mma(dq[2 * np + 1], pa, bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_wait_all();             // no copy outlives the CTA (n_kt = 0)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= mk.Lq) continue;
    bf16* row = a.dq + b * a.dqs[0] + h * a.dqs[1] + r * a.dqs[2];
#pragma unroll
    for (int n = 0; n < 2 * kQK; ++n)
      if (8 * n < a.Dqk)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * c4) =
            __floats2bfloat162_rn(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

template <int kWarps, int kQK, int kVK>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = dq_smem(16 * kWarps, a.Dqk, a.Dv);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const void* kernel =
      reinterpret_cast<const void*>(dq_tc_kernel<kWarps, kQK, kVK>);
  cudaError_t err = opt_in_smem(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.mask.Lq + 16 * kWarps - 1) / (16 * kWarps), B * a.H);
  dq_tc_kernel<kWarps, kQK, kVK><<<grid, 32 * kWarps, smem, stream>>>(a);
  return cudaGetLastError();
}

// K5 on the walk: `rows` must be dq_rows' pick (the plan's tiles).
inline cudaError_t launch_dq(const Args& a, int B, int rows,
                             cudaStream_t stream) {
  if (!shape_ok(a.Dqk, a.Dv) || rows != dq_rows(a.Dqk, a.Dv))
    return cudaErrorInvalidValue;
  if (a.Dqk <= 64 && a.Dv <= 64) return launch_dq<8, 4, 4>(a, B, stream);
  if (a.Dqk <= 128 && a.Dv <= 128) return launch_dq<8, 8, 8>(a, B, stream);
  if (a.Dqk <= 192 && a.Dv <= 128) return launch_dq<8, 12, 8>(a, B, stream);
  return launch_dq<4, 16, 16>(a, B, stream);
}

// ------------------------------------------------------------------ K6 ---

// Shared memory of a K6 CTA: the key and value tiles, two (Q, dO) tile
// pairs, the P^T and dS^T tiles (64 x 64 bf16 each) and two (lse,
// delta) row pairs (f32).
inline size_t dkv_smem(int Dqk, int Dv) {
  const size_t Dsq = round64(Dqk), Dsv = round64(Dv);
  return ((size_t)kKeys + 2 * kQueries) * (Dsq + Dsv) * sizeof(bf16) +
         2 * (size_t)kKeys * kQueries * sizeof(bf16) +
         4 * (size_t)kQueries * sizeof(float);
}

// kQK: 16-deep steps of Dqk (Dqk <= 16 kQK); kVK: of Dv.  A phase-2 warp
// owns a quarter of each: (kQK + 3) / 4 and (kVK + 3) / 4 16-column
// blocks.
template <int kQK, int kVK>
__global__ void __launch_bounds__(256, 1) dkv_tc_kernel(const Args a) {
  constexpr int kThreads = 256;
  constexpr int kQQ = (kQK + 3) / 4, kVQ = (kVK + 3) / 4;
  extern __shared__ __align__(128) unsigned char fa_tcb_smem[];
  const int Dsq = round64(a.Dqk), Dsv = round64(a.Dv);
  bf16* k_s = reinterpret_cast<bf16*>(fa_tcb_smem);
  bf16* v_s = k_s + kKeys * Dsq;
  bf16* qd_s = v_s + kKeys * Dsv;           // Q_0, dO_0, Q_1, dO_1
  const int qd_step = kQueries * (Dsq + Dsv);
  bf16* p_s = qd_s + 2 * qd_step;           // P^T (keys x queries)
  bf16* ds_s = p_s + kKeys * kQueries;      // dS^T
  float* rows_s = reinterpret_cast<float*>(ds_s + kKeys * kQueries);
  // rows_s: lse_0, delta_0, lse_1, delta_1 (kQueries each)

  const Mask& mk = a.mask;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int Hkv = a.H / a.G;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int k0 = blockIdx.x * kKeys;
  const int nk = min(kKeys, mk.Lk - k0);

  copy_tile_rows<kKeys, kThreads>(k_s, Dsq,
                             a.k + b * a.ks[0] + hk * a.ks[1] + k0 * a.ks[2],
                             a.ks[2], nk, a.Dqk);
  copy_tile_rows<kKeys, kThreads>(v_s, Dsv,
                             a.v + b * a.vs[0] + hk * a.vs[1] + k0 * a.vs[2],
                             a.vs[2], nk, a.Dv);
  int q_lo, q_hi;
  mk.query_range(k0, k0 + nk, &q_lo, &q_hi);
  const int qt0 = q_lo / kQueries;
  const int nqt = q_hi > q_lo ? (q_hi - 1) / kQueries - qt0 + 1 : 0;
  const int n_total = a.G * nqt;            // (query head, query tile)
  auto copy_q = [&](int t) {
    const int h = hk * a.G + t / nqt;
    const int q0 = (qt0 + t % nqt) * kQueries;
    bf16* q_s = qd_s + (t & 1) * qd_step;
    copy_tile_rows<kQueries, kThreads>(
        q_s, Dsq, a.q + b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2], a.qs[2],
        mk.Lq - q0, a.Dqk);
    copy_tile_rows<kQueries, kThreads>(
        q_s + kQueries * Dsq, Dsv,
        a.dout + b * a.dos[0] + h * a.dos[1] + q0 * a.dos[2], a.dos[2],
        mk.Lq - q0, a.Dv);
    float* r_s = rows_s + (t & 1) * 2 * kQueries;
    const size_t base = ((size_t)b * a.H + h) * mk.Lq + q0;
    for (int i = tid; i < 2 * kQueries; i += kThreads) {
      const int j = i & (kQueries - 1);
      const bool ok = q0 + j < mk.Lq;
      const float* src = i < kQueries ? a.lse : a.delta;
      cp4(r_s + i, ok ? src + base + j : src, ok);
    }
  };
  if (n_total > 0) copy_q(0);
  cp_commit();

  const float c = a.scale * kLog2e;
  // phase 1: this warp's block of 16 keys (kb) x 32 queries (qh)
  const int kb = warp & 3, qh = warp >> 2;
  const int kb0 = k0 + 16 * kb;
  int bq_lo = 0, bq_hi = 0;                 // queries the block's keys see
  if (kb0 < mk.Lk) mk.query_range(kb0, min(kb0 + 16, mk.Lk), &bq_lo, &bq_hi);
  // phase 2: this warp's 32 keys (two 16-row blocks from k2) and quarter
  // (dq4) of Dqk and Dv: 16-column blocks [qc0, qc1) and [vc0, vc1)
  const int k2 = 32 * (warp & 1), dq4 = warp >> 1;
  int kq_lo = 0, kq_hi = 0;                 // queries its keys see
  if (k0 + k2 < mk.Lk)
    mk.query_range(k0 + k2, min(k0 + k2 + 32, mk.Lk), &kq_lo, &kq_hi);
  const int nq16 = a.Dqk / 16, nv16 = a.Dv / 16;
  const int qc0 = dq4 * ((nq16 + 3) / 4), vc0 = dq4 * ((nv16 + 3) / 4);
  const int qc1 = min(nq16, qc0 + (nq16 + 3) / 4);
  const int vc1 = min(nv16, vc0 + (nv16 + 3) / 4);
  float dk[2][2 * kQQ][4], dv[2][2 * kVQ][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int n = 0; n < 2 * kQQ; ++n)
      dk[mt][n][0] = dk[mt][n][1] = dk[mt][n][2] = dk[mt][n][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < 2 * kVQ; ++n)
      dv[mt][n][0] = dv[mt][n][1] = dv[mt][n][2] = dv[mt][n][3] = 0.0f;
  }
  const int a_row = 16 * kb + (lane & 15);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int t_row = (lane & 7) + 8 * ((lane >> 3) & 1);

  for (int t = 0; t < n_total; ++t) {
    const int q0 = (qt0 + t % nqt) * kQueries;
    cp_wait_all();
    __syncthreads();   // tile t landed; every warp is done with tile t-1
    if (t + 1 < n_total) copy_q(t + 1);
    cp_commit();
    const bf16* q_s = qd_s + (t & 1) * qd_step;
    const bf16* do_s = q_s + kQueries * Dsq;
    const float* lse_s = rows_s + (t & 1) * 2 * kQueries;
    const float* dl_s = lse_s + kQueries;

    // ---- phase 1: S^T = K Q^T and dP^T = V dO^T on the warp's block
    const int qb0 = q0 + 32 * qh;
    const bool live = kb0 < mk.Lk && qb0 < mk.Lq && qb0 < bq_hi &&
                      qb0 + 32 > bq_lo;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    }
    if (live) {
#pragma unroll
      for (int kk = 0; kk < 16 * kQK; kk += 16) {
        if (kk >= a.Dqk) break;
        uint32_t af[4];
        ldsm4(af, k_s + swz(a_row, kk + 8 * (lane >> 4), Dsq));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bfr[4];
          ldsm4(bfr, q_s + swz(32 * qh + 16 * np + b_row,
                               kk + 8 * ((lane >> 3) & 1), Dsq));
          mma(s[2 * np], af, bfr[0], bfr[1]);
          mma(s[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 16 * kVK; kk += 16) {
        if (kk >= a.Dv) break;
        uint32_t af[4];
        ldsm4(af, v_s + swz(a_row, kk + 8 * (lane >> 4), Dsv));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bfr[4];
          ldsm4(bfr, do_s + swz(32 * qh + 16 * np + b_row,
                                kk + 8 * ((lane >> 3) & 1), Dsv));
          mma(dp[2 * np], af, bfr[0], bfr[1]);
          mma(dp[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
      // whether the diagonal, the window edge, Lk or Lq cuts the block
      // (warp-uniform); only then are pairs masked
      const bool edge =
          kb0 + 16 > mk.Lk || qb0 + 32 > mk.Lq ||
          (mk.causal && kb0 + 15 > mk.q_offset + qb0) ||
          (mk.has_window && kb0 <= mk.q_offset + qb0 + 31 - mk.window);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 32 * qh + 8 * n + 2 * c4 + (e & 1);   // query
          bool ok = true;
          if (edge) {
            const int key = kb0 + g + 8 * (e >> 1);
            const int q_pos = mk.q_offset + q0 + j;
            ok = key < mk.Lk && q0 + j < mk.Lq &&
                 !(mk.causal && key > q_pos) &&
                 !(mk.has_window && key <= q_pos - mk.window);
          }
          const float p =
              ok ? exp2f(fmaf(s[n][e], c, -lse_s[j] * kLog2e)) : 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl_s[j]) * a.scale;
        }
      }
    }
    // P^T and dS^T to shared memory in bf16 (zeros for a skipped block)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = swz(16 * kb + g + 8 * i, 32 * qh + 8 * n + 2 * c4,
                            kQueries);
        *reinterpret_cast<uint32_t*>(p_s + off) =
            pack_bf16(s[n][2 * i], s[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(ds_s + off) =
            pack_bf16(dp[n][2 * i], dp[n][2 * i + 1]);
      }
    }
    __syncthreads();        // the P^T and dS^T tiles are whole

    // ---- phase 2: dV += P^T dO, dK += dS^T Q on the warp's 32 keys and
    // its quarter of Dv and Dqk (each B fragment feeds both row blocks);
    // skipped when no query of the tile may attend them
    if (k0 + k2 >= mk.Lk || q0 >= kq_hi || q0 + kQueries <= kq_lo) continue;
#pragma unroll
    for (int ks = 0; ks < kQueries / 16; ++ks) {
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = k2 + 16 * mt + (lane & 15);
        ldsm4(pa[mt], p_s + swz(row, 16 * ks + 8 * (lane >> 4), kQueries));
        ldsm4(da[mt], ds_s + swz(row, 16 * ks + 8 * (lane >> 4), kQueries));
      }
#pragma unroll
      for (int np = 0; np < kVQ; ++np) {
        if (vc0 + np < vc1) {
          uint32_t bfr[4];
          ldsm4_t(bfr, do_s + swz(16 * ks + t_row,
                                  16 * (vc0 + np) + 8 * (lane >> 4), Dsv));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(dv[mt][2 * np], pa[mt], bfr[0], bfr[1]);
            mma(dv[mt][2 * np + 1], pa[mt], bfr[2], bfr[3]);
          }
        }
      }
#pragma unroll
      for (int np = 0; np < kQQ; ++np) {
        if (qc0 + np < qc1) {
          uint32_t bfr[4];
          ldsm4_t(bfr, q_s + swz(16 * ks + t_row,
                                 16 * (qc0 + np) + 8 * (lane >> 4), Dsq));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(dk[mt][2 * np], da[mt], bfr[0], bfr[1]);
            mma(dk[mt][2 * np + 1], da[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
  }
  cp_wait_all();             // no copy outlives the CTA (n_total = 0)

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + k2 + 16 * mt + g + 8 * i;
      if (key >= mk.Lk) continue;
      bf16* krow = a.dk + b * a.dks[0] + hk * a.dks[1] + key * a.dks[2];
      bf16* vrow = a.dv + b * a.dvs[0] + hk * a.dvs[1] + key * a.dvs[2];
#pragma unroll
      for (int n = 0; n < 2 * kQQ; ++n)
        if (qc0 + n / 2 < qc1)
          *reinterpret_cast<__nv_bfloat162*>(krow + 16 * qc0 + 8 * n +
                                             2 * c4) =
              __floats2bfloat162_rn(dk[mt][n][2 * i], dk[mt][n][2 * i + 1]);
#pragma unroll
      for (int n = 0; n < 2 * kVQ; ++n)
        if (vc0 + n / 2 < vc1)
          *reinterpret_cast<__nv_bfloat162*>(vrow + 16 * vc0 + 8 * n +
                                             2 * c4) =
              __floats2bfloat162_rn(dv[mt][n][2 * i], dv[mt][n][2 * i + 1]);
    }
  }
}

template <int kQK, int kVK>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = dkv_smem(a.Dqk, a.Dv);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(dkv_tc_kernel<kQK, kVK>);
  cudaError_t err = opt_in_smem(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.mask.Lk + kKeys - 1) / kKeys, B * (a.H / a.G));
  dkv_tc_kernel<kQK, kVK><<<grid, 256, smem, stream>>>(a);
  return cudaGetLastError();
}

// K6 on the walk, 64 keys and 64-query tiles.
inline cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  if (!shape_ok(a.Dqk, a.Dv)) return cudaErrorInvalidValue;
  if (a.Dqk <= 64 && a.Dv <= 64) return launch_dkv<4, 4>(a, B, stream);
  if (a.Dqk <= 128 && a.Dv <= 128) return launch_dkv<8, 8>(a, B, stream);
  if (a.Dqk <= 192 && a.Dv <= 128) return launch_dkv<12, 8>(a, B, stream);
  return launch_dkv<16, 16>(a, B, stream);
}

}  // namespace tcb
}  // namespace fa
