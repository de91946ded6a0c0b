// The tensor-core walk of the flash-attention forward (kernel K4) for
// bf16 operands: the FlashAttention-2 dataflow on mma.sync, with S, P and
// the output accumulator in registers.  Launched by flash_attention_fwd.cu
// when the wrapper's plan says so (repro_torch/kernels/_launch.py,
// flash_fwd_plan); everything else keeps the WMMA kernel there.
//
// A CTA takes 128 query rows of one (batch, head).  A warp owns whole
// rows, so a row's max and sum never leave it (each row lives in one quad
// of lanes: two xor shuffles): 32 rows (two 16-row blocks) for Dv <= 128,
// so every K and V fragment it reads from shared memory feeds two blocks'
// products -- the walk's limit is that fragment traffic -- and 16 rows
// for wider values, whose accumulators would not fit twice.  The query
// tile is staged once; one key and one value tile of 64 keys are copied
// with 16-byte cp.async in FlashAttention-2's order: V_t while S_t is
// multiplied, K_t+1 while P_t V_t is.  At the path's head dims (192 / 128)
// that is 88 KB of shared memory and 4 warps, so two CTAs share an SM and
// one's softmax overlaps the other's products.  Every buffer row is
// XOR-swizzled in 16-byte chunks (tc_primitives.cuh, swz), so each
// ldmatrix is conflict-free.  For a key tile a warp runs
//
//   S = Q K^T       (16 or 32) x 64, mma m16n8k16: A from Q and B from K
//                   through ldmatrix, S in registers (32 f32 a thread a
//                   row block);
//   softmax         p = exp2f(s c - m c) with c = scale log2(e), one FFMA
//                   an element; the running (m, l) in registers; O is
//                   rescaled in registers only when a row's max moved;
//   O += P V        P packed to bf16 straight from the S accumulators into
//                   the A fragments (the C layout of two n8 tiles is the
//                   A layout of one k16 step), V's B fragments through
//                   ldmatrix.trans; O is f32 in registers (64 a thread a
//                   row block at Dv 128).
//
// l sums the f32 p before it is rounded for the product, as the WMMA
// kernel and the plain version do, so lse (natural log, m scale + log(l), f32;
// -2^30 + log 1 for a row that attends no key) keeps its meaning for the
// backward kernels K5 / K6.  Masking: key tiles no row of the CTA may
// attend are never visited (Mask::key_range); a warp skips a tile none of
// its rows may attend; keys are masked (against each row's limits, two
// compares an element) only on the tiles the causal diagonal, the window
// edge or the end of the keys cuts for the warp's rows, behind a
// warp-uniform branch.  Query tiles are launched longest first (blockIdx.x
// reversed), so under a causal mask the long rows start first and the
// short ones fill the tail; the tiles of one (batch, head) stay next to
// each other in the launch order, so its keys and values are read from
// device memory about once and from L2 after that.
//
// Operands: (B, heads, L, D) with element strides for B, heads and L (the
// MLA path's transposed views go in without a copy), the last dimension
// contiguous; the wrapper routes here only bf16 with Dqk and Dv multiples
// of 16 up to 256, 16-byte aligned pointers and strides that are
// multiples of 8 elements.  Rows past Lq and keys past Lk are zero-filled
// by the copies, never read from device memory.
#pragma once

#include "flash_common.cuh"
#include "tc_primitives.cuh"

namespace fa {
namespace tc {

using namespace ::hopper;   // swz, copy_tile, ldsm4(_t), mma, pack_bf16, ...
using bf16 = __nv_bfloat16;

constexpr int kRowsQ = 128;              // query rows a CTA
constexpr int kKeys = 64;                // keys a staged tile
constexpr int kMaxD = 256;               // Dqk and Dv the route takes
constexpr int kSTiles = kKeys / 8;       // 8-key score tiles a row block
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round64(int x) { return (x + 63) / 64 * 64; }

// Shared-memory layout, byte offsets: the query tile and one key and one
// value tile.  Row strides Dsq, Dsv (elements) are rounded up to 64 so
// the swizzle stays inside a row.
struct Layout {
  int Dsq, Dsv;
  size_t q, k, v, total;
};

__host__ __device__ inline Layout layout(int Dqk, int Dv) {
  Layout L;
  L.Dsq = round64(Dqk);
  L.Dsv = round64(Dv);
  L.q = 0;
  L.k = L.q + (size_t)kRowsQ * L.Dsq * sizeof(bf16);
  L.v = L.k + (size_t)kKeys * L.Dsq * sizeof(bf16);
  L.total = L.v + (size_t)kKeys * L.Dsv * sizeof(bf16);
  return L;
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;
  long long qs[3], ks[3], vs[3], os[3];   // strides of B, heads, L
  int H, G, Dqk, Dv;
  float scale;
  Mask mask;
};

// kMT: 16-row blocks a warp owns (the CTA's 128 rows take 8 / kMT warps);
// kQK: 16-deep steps of the score product (Dqk <= 16 kQK); kVT: 8-column
// output tiles (Dv <= 8 kVT).  All compile-time, so the loops unroll.
// With kMT = 2 every K and V fragment read from shared memory feeds two
// row blocks, half the fragment traffic of one.
template <int kMT, int kQK, int kVT>
__global__ void __launch_bounds__(32 * 8 / kMT, kMT)
    fwd_tc_kernel(const Args a) {
  constexpr int kWarps = 8 / kMT;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRowsW = 16 * kMT;           // rows a warp owns
  extern __shared__ __align__(128) unsigned char fa_tc_smem[];
  const Layout L = layout(a.Dqk, a.Dv);
  const int Dsq = L.Dsq, Dsv = L.Dsv;
  bf16* q_s = reinterpret_cast<bf16*>(fa_tc_smem + L.q);
  bf16* k_s = reinterpret_cast<bf16*>(fa_tc_smem + L.k);
  bf16* v_s = reinterpret_cast<bf16*>(fa_tc_smem + L.v);

  const Mask& mk = a.mask;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsQ;   // longest first
  const int nq = min(kRowsQ, mk.Lq - q0);
  const bf16* qg = a.q + b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2];
  const bf16* kg = a.k + b * a.ks[0] + hk * a.ks[1];
  const bf16* vg = a.v + b * a.vs[0] + hk * a.vs[1];

  int k_lo, k_hi;
  mk.key_range(q0, q0 + nq, &k_lo, &k_hi);
  const int t0 = k_lo / kKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi - 1) / kKeys - t0 + 1 : 0;
  auto copy_k = [&](int t) {
    const int k0 = (t0 + t) * kKeys;
    copy_tile<kKeys, kThreads>(k_s, Dsq, kg + k0 * a.ks[2], a.ks[2],
                               mk.Lk - k0, a.Dqk);
  };
  auto copy_v = [&](int t) {
    const int k0 = (t0 + t) * kKeys;
    copy_tile<kKeys, kThreads>(v_s, Dsv, vg + k0 * a.vs[2], a.vs[2],
                               mk.Lk - k0, a.Dv);
  };

  // Loads, one buffer each (FlashAttention-2's order): the query tile
  // and K_0 first; V_t is copied while S_t is multiplied, K_t+1 while
  // P_t V_t is.
  copy_tile<kRowsQ, kThreads>(q_s, Dsq, qg, a.qs[2], nq, a.Dqk);
  if (n_tiles > 0) copy_k(0);
  cp_commit();

  float o[kMT][kVT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kVT; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.0f;
  // the running max of the raw scores q . k and this thread's part of
  // the row sum, of rows g and g + 8 of each row block
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
  }
  const float scale2 = a.scale * kLog2e;
  const int r0 = q0 + kRowsW * warp;         // the warp's first query row
  int w_lo, w_hi;                            // keys the warp's rows see
  mk.key_range(r0, r0 + kRowsW, &w_lo, &w_hi);
  const bool warp_live = r0 < mk.Lq && w_hi > w_lo;
  const int a_row = kRowsW * warp + (lane & 15);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = (t0 + t) * kKeys;
    cp_wait_all();
    __syncthreads();        // K_t landed; every warp is done with V_t-1
    copy_v(t);
    cp_commit();
    const bool live = warp_live && k0 < w_hi && k0 + kKeys > w_lo;

    // ---- S = Q K^T: the warp's kMT row blocks, the tile's 64 keys
    float s[kMT][kSTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.0f;
    if (live) {
      // unrolled by two, not fully: a full unroll runs the 32-row blocks
      // out of registers (spills, ~10 % slower on an H100)
#pragma unroll 2
      for (int kk = 0; kk < 16 * kQK; kk += 16) {
        if (kk >= a.Dqk) break;
        uint32_t af[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldsm4(af[mt], q_s + swz(a_row + 16 * mt, kk + 8 * (lane >> 4), Dsq));
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          uint32_t bfr[4];
          ldsm4(bfr,
                k_s + swz(b_row + 16 * np, kk + 8 * ((lane >> 3) & 1), Dsq));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma(s[mt][2 * np], af[mt], bfr[0], bfr[1]);
            mma(s[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
    cp_wait_all();
    __syncthreads();        // V_t landed; every warp is done with K_t
    if (t + 1 < n_tiles) copy_k(t + 1);
    cp_commit();
    if (!live) continue;

    // whether the diagonal, the window edge or Lk cuts the tile for one
    // of the warp's rows (warp-uniform); only then are keys masked, each
    // row against its own limits lo <= key <= hi
    const bool edge =
        k0 + kKeys > mk.Lk ||
        (mk.causal && k0 + kKeys - 1 > mk.q_offset + r0) ||
        (mk.has_window && k0 <= mk.q_offset + r0 + kRowsW - 1 - mk.window);
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q_pos = mk.q_offset + r0 + 16 * mt + g + 8 * i;
          const int hi = mk.causal ? min(mk.Lk - 1, q_pos) : mk.Lk - 1;
          const int lo = mk.has_window ? q_pos - mk.window + 1 : 0;
#pragma unroll
          for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * n + 2 * c4 + e;
              if (key < lo || key > hi) s[mt][n][2 * i + e] = -INFINITY;
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      // ---- the tile's row maxima (raw scores; masked lanes are -inf)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float corr[2], ms[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // m stays the finite -2^30 while a row has seen no key, so a
        // masked lane's exp2f(-inf) is 0 and corr is exp2f(0) = 1
        const float m_new = fmaxf(m[mt][i], mx[i]);
        corr[i] = exp2f((m[mt][i] - m_new) * scale2);
        m[mt][i] = m_new;
        ms[i] = m_new * scale2;
      }
      // ---- p = exp2(s scale log2(e) - m scale log2(e)) in place (one
      // FFMA and one exp2f an element), the row sums (f32)
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = exp2f(fmaf(s[mt][n][e], scale2, -ms[e >> 1]));
          rs[e >> 1] += s[mt][n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[mt][i] = l[mt][i] * corr[i] + rs[i];
      // a factor of 1 changes nothing: rescale only when a max moved
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int n = 0; n < kVT; ++n) {
          o[mt][n][0] *= corr[0];
          o[mt][n][1] *= corr[0];
          o[mt][n][2] *= corr[1];
          o[mt][n][3] *= corr[1];
        }
      }
    }

    // ---- O += P V: key steps of 16, P's A fragments from S's registers
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      uint32_t pa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * ks][0], s[mt][2 * ks][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * ks][2], s[mt][2 * ks][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * ks + 1][0], s[mt][2 * ks + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * ks + 1][2], s[mt][2 * ks + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < kVT / 2; ++np) {
        if (16 * np < a.Dv) {
          uint32_t bfr[4];
          ldsm4_t(bfr, v_s + swz(16 * ks + v_row, 16 * np + 8 * (lane >> 4),
                                 Dsv));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma(o[mt][2 * np], pa[mt], bfr[0], bfr[1]);
            mma(o[mt][2 * np + 1], pa[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
  }

  cp_wait_all();             // no copy outlives the CTA (n_tiles = 0)

  // ---- out = O / l (bf16), lse = m ln 2 + log l
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int r = r0 + 16 * mt + g + 8 * i;
      if (r >= mk.Lq) continue;
      const float inv = li == 0.0f ? 1.0f : 1.0f / li;
      bf16* orow = a.out + b * a.os[0] + h * a.os[1] + r * a.os[2];
#pragma unroll
      for (int n = 0; n < kVT; ++n)
        if (8 * n < a.Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * c4) =
              __floats2bfloat162_rn(o[mt][n][2 * i] * inv,
                                    o[mt][n][2 * i + 1] * inv);
      if (c4 == 0)
        a.lse[(size_t)bh * mk.Lq + r] =
            li == 0.0f ? kNegInf : m[mt][i] * a.scale + logf(li);
    }
  }
}

// The tiles and grid of a launch: 128 query rows a CTA, grid
// (ceil(Lq / 128), B * H).
template <int kMT, int kQK, int kVT>
cudaError_t launch_fwd(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = layout(a.Dqk, a.Dv).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const void* kernel =
      reinterpret_cast<const void*>(fwd_tc_kernel<kMT, kQK, kVT>);
  cudaError_t err = opt_in_smem(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.mask.Lq + kRowsQ - 1) / kRowsQ, B * a.H);
  fwd_tc_kernel<kMT, kQK, kVT><<<grid, 32 * 8 / kMT, smem, stream>>>(a);
  return cudaGetLastError();
}

// What the walk takes (the wrapper checks alignment and strides): head
// dims multiples of 16 up to 256.
inline bool shape_ok(int Dqk, int Dv) {
  return Dqk > 0 && Dv > 0 && Dqk % 16 == 0 && Dv % 16 == 0 &&
         Dqk <= kMaxD && Dv <= kMaxD;
}

inline cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  if (!shape_ok(a.Dqk, a.Dv)) return cudaErrorInvalidValue;
  // Dv <= 128: 32 rows a warp (4 warps; the registers of O and S fit two
  // CTAs an SM); wider values: 16 rows a warp (8 warps)
  if (a.Dv > 128) return launch_fwd<1, 16, 32>(a, B, stream);
  if (a.Dqk <= 64 && a.Dv <= 64) return launch_fwd<2, 4, 8>(a, B, stream);
  if (a.Dqk <= 128) return launch_fwd<2, 8, 16>(a, B, stream);
  if (a.Dqk <= 192) return launch_fwd<2, 12, 16>(a, B, stream);
  return launch_fwd<2, 16, 16>(a, B, stream);
}

}  // namespace tc
}  // namespace fa
