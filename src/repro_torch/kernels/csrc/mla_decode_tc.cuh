// The tensor-core split-KV walk shared by the absorbed-MLA kernels for
// bf16 q: contiguous decode (K3, mla_decode.cu), paged decode (K1,
// mla_decode_paged.cu) and paged chunked prefill (K2, mla_prefill_paged.cu:
// a CTA's 64 rows are the heads of one (request, chunk row), which attends
// positions <= lengths[b] + c); and the combine that merges its splits.
// The Hopper primitives it is built from (swizzle, cp.async, ldmatrix,
// mma.sync) are in tc_primitives.cuh.
//
// Absorbed MLA is multi-query attention with ONE latent KV head: all H
// query heads of a request attend the same {ckv | krope} rows.  So a CTA
// takes 64 heads of one request (one query tile, staged in shared memory
// once) and one contiguous range of its positions (a split), and walks the
// range in tiles of 64 positions.  Each tile is read from device memory
// once for the 64 heads, and both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate):
//
//   S = Q_lat K_lat^T + Q_rope K_rope^T   (64 x 64; K = Dl and K = Dr,
//                                          two f32 accumulators, summed
//                                          in f32 as the JAX kernels do)
//   O += P V                              (64 x Dl; P cast to bf16, and
//                                          the row sum l taken of the
//                                          cast values)
//
// Warps: 16, in 4 groups of 4.  Warp w owns query rows 16 (w % 4) .. + 15
// and belongs to group w / 4.  For S it takes the tile's positions
// 16 (w / 4) .. + 15; the four warps of a row block exchange their row
// maxima through shared memory, so all apply the same running max, and
// each keeps the row sum of its own positions (added at the end).  P goes
// through shared memory as bf16; for O the warp takes output columns
// (w / 4) Dl / 4 .. + Dl / 4 of its 16 rows, so the 64 x 512 f32
// accumulator is 64 registers a thread.  A warp rescales its accumulator
// only when the running max of one of its rows moved.
//
// Staging: 16-byte cp.async into two tile buffers, the next tile's copy in
// flight while the current one is multiplied (8-byte copies only for the
// rope codes of an int8 / fp8 pool whose Dr is no multiple of 16).  Rows
// are XOR-swizzled in 16-byte chunks (chunk c of row r at c ^ (r % 8)),
// so every ldmatrix is conflict-free without padding.  A position past
// the split's end, or a block-table entry outside the pool, is
// zero-filled by the copy itself and never read from device memory.  An
// int8 / fp8 pool copies its codes (1 byte each) into byte buffers,
// converts them exactly to bf16 in shared memory (|int8| <= 127 and every
// e4m3 value are bf16 values), and applies the slot's scales after the
// product: ckv_s[j] and krope_s[j] multiply the latent and rope score
// columns, and ckv_s[j] is folded into p_j before PV.  No dequantized
// copy of the pool exists.
//
// Split-KV: the grid is (H / 64, n_split, B) (B x C for K2, a "request"
// being one (request, chunk row)); split s covers positions
// [s * split_pos, (s + 1) * split_pos) cut at the request's last position.
// Each CTA writes its rows' unnormalized f32 partial (acc, m, l) to a
// workspace; a split that starts past the request's index writes l = 0
// and is skipped by the merge.  The combine kernel rescales each split to
// the largest m: under exp_add every m is an integer (the ceil of the
// running max), so that is an exact power of two applied by
// exp_add_rescale; under mul it is exp(m_s - M).
#pragma once

#include "mla_paged_common.cuh"
#include "tc_primitives.cuh"

namespace mla {
namespace tc {

using namespace ::hopper;   // swz, cp16, ldsm4, mma, opt_in_smem, ...
using bf16 = __nv_bfloat16;

constexpr int kRowsTC = 64;        // query rows (heads) per CTA
constexpr int kPos = 64;           // positions per staged tile
constexpr int kWarpsTC = 16;
constexpr int kThreadsTC = 32 * kWarpsTC;
constexpr int kGroups = kWarpsTC / 4;      // warps that share a row block
constexpr int kLoaders = kThreadsTC / kPos;   // threads copying a position
constexpr int kMaxK = 576;         // Dl + round16(Dr) the buffers hold
constexpr int kMaxPages = 64;      // block-table entries one tile touches
constexpr int kSTiles = kPos / kGroups / 8;  // 8-position score tiles a warp
constexpr int kAccTiles = kMaxDl / kGroups / 8;   // 8-column output tiles

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory layout of one CTA, byte offsets.  Ds is the row stride of
// the q and tile buffers in elements: the score product's depth
// Dl + round16(Dr), rounded up to 64 so the swizzle stays inside a row.
struct Layout {
  int Ds;
  size_t q, kv, p, red, sc, pg, total;
};

__host__ __device__ inline Layout layout(int Dl, int Dr, bool scaled,
                                         bool paged) {
  Layout L;
  L.Ds = round_up(Dl + round_up(Dr, 16), 64);
  const size_t tile = (size_t)kPos * L.Ds * sizeof(bf16);
  L.q = 0;
  L.kv = L.q + (size_t)kRowsTC * L.Ds * sizeof(bf16);
  L.p = L.kv + 2 * tile;            // two bf16 tiles, or one + two of codes
  L.red = L.p + (size_t)kRowsTC * kPos * sizeof(bf16);
  L.sc = L.red + kGroups * kRowsTC * sizeof(float);
  L.pg = L.sc + (scaled ? 2 * 2 * kPos * sizeof(float) : 0);
  L.total = L.pg + (paged ? 2 * kMaxPages * sizeof(int) : 0);
  return L;
}

// Where a request's rows are.  slot(p, pages, p0) is the row of position
// p of the tile at p0 (-1: it reads as zeros); pages holds the tile's
// block-table entries, which a paged source reads once a tile, one tile
// ahead (page_count entries from first_page).
template <typename P>
struct DenseSrc {
  static constexpr bool kPaged = false;
  const P* ckv;
  const P* krope;
  long long ckv_sp, krope_sp;

  __device__ long long slot(int p, const int*, int) const { return p; }
  __device__ const P* ckv_row(long long s) const { return ckv + s * ckv_sp; }
  __device__ const P* krope_row(long long s) const {
    return krope + s * krope_sp;
  }
};

template <typename P>
struct PagedSrc {
  static constexpr bool kPaged = true;
  const P* ckv;             // (N, bs, Dl)
  const P* krope;           // (N, bs, Dr)
  const float* ckv_s;       // (N, bs, 1), scaled pools only
  const float* krope_s;
  const int* bt;            // this request's (nb,) block-table row
  int nb, bs, N, Dl, Dr;

  __device__ long long slot(int p, const int* pages, int p0) const {
    const int blk = pages[p / bs - p0 / bs];
    if (blk < 0 || blk >= N) return -1;
    return (long long)blk * bs + p % bs;
  }
  __device__ const P* ckv_row(long long s) const { return ckv + s * Dl; }
  __device__ const P* krope_row(long long s) const { return krope + s * Dr; }
  __device__ int first_page(int p0) const { return p0 / bs; }
  // entries of the tile at p0, positions < p_end
  __device__ int page_count(int p0, int p_end) const {
    return (min(p0 + kPos, p_end) - 1) / bs - p0 / bs + 1;
  }
  __device__ int page(int k) const { return k < nb ? bt[k] : -1; }
};

// One CTA: query rows 0 .. n_rows - 1 of q (64 rows of a request, each
// Dl + Dr wide) against positions [s * split_pos, min((s + 1) * split_pos,
// n_pos)) of src.  Writes row r's partial to acc[r * row_stride + s * Dl
// ...] and ml[(r * n_split + s) * 2 ...] = (m, l).
template <typename P, bool kScaled, bool kExpAdd, typename Src>
__device__ void attend_split(const bf16* __restrict__ q,
                             float* __restrict__ acc_out,
                             float* __restrict__ ml_out, const Src& src,
                             int n_rows, int n_pos, int s, int n_split,
                             int split_pos, int Dl, int Dr, float scale) {
  constexpr bool kCodes = sizeof(P) == 1;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  const Layout L = layout(Dl, Dr, kScaled, Src::kPaged);
  const int Ds = L.Ds;
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);
  bf16* kv_s = reinterpret_cast<bf16*>(smem + L.kv);
  unsigned char* code_s = smem + L.kv + (size_t)kPos * Ds * sizeof(bf16);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L.p);
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);
  int* pg_s = reinterpret_cast<int*>(smem + L.pg);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, grp = warp >> 2;
  const int g = lane >> 2, c4 = lane & 3;
  const int Dq = Dl + Dr;                 // q's row width
  const int Dk = Dl + round_up(Dr, 16);   // the score product's depth
  const int n_ch = Dk / 8;                // 16-byte bf16 chunks a row
  const int row_stride = n_split * Dl;

  const int p_begin = s * split_pos;
  const int p_end = min(p_begin + split_pos, n_pos);
  if (p_begin >= p_end) {                 // nothing of this request here
    for (int r = tid; r < n_rows; r += kThreadsTC) {
      ml_out[((size_t)r * n_split + s) * 2] = kNegInf;
      ml_out[((size_t)r * n_split + s) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int n_tiles = (p_end - p_begin + kPos - 1) / kPos;

  // issue the copies of tile t into buffer t % 2
  auto issue_tile = [&](int t) {
    const int p0 = p_begin + t * kPos;
    const int j = tid / kLoaders, sub = tid % kLoaders;
    const int p = p0 + j;
    long long slot = -1;
    if (p < p_end) slot = src.slot(p, pg_s + (t & 1) * kMaxPages, p0);
    const bool ok = slot >= 0;
    const long long sl = ok ? slot : 0;
    const P* crow = src.ckv_row(sl);
    const P* rrow = src.krope_row(sl);
    if constexpr (!kCodes) {
      bf16* dst = kv_s + (size_t)(t & 1) * kPos * Ds;
      for (int ch = sub; ch < n_ch; ch += kLoaders) {
        const int col = ch * 8;
        if (col < Dl) {
          cp16(dst + swz(j, col, Ds), crow + col, ok);
        } else {
          const int cr = col - Dl;
          const bool v = ok && cr < Dr;
          cp16(dst + swz(j, col, Ds), v ? rrow + cr : rrow, v);
        }
      }
    } else {
      unsigned char* dst = code_s + (size_t)(t & 1) * kPos * Ds + j * Ds;
      for (int ch = sub; ch < Dl / 16; ch += kLoaders)
        cp16(dst + ch * 16, crow + ch * 16, ok);
      if (Dr % 16 == 0) {             // rope rows of whole 16-byte chunks
        for (int ch = sub; ch < Dr / 16; ch += kLoaders)
          cp16(dst + Dl + ch * 16, rrow + ch * 16, ok);
      } else {                        // 8-byte chunks, then the zero pad
        for (int ch = sub; ch < (Dk - Dl) / 8; ch += kLoaders) {
          const bool v = ok && ch * 8 < Dr;
          cp8(dst + Dl + ch * 8, v ? rrow + ch * 8 : rrow, v);
        }
      }
      if constexpr (kScaled) {
        if (sub == 0) {
          float* sc = sc_s + (t & 1) * 2 * kPos;
          cp4(sc + j, src.ckv_s + sl, ok);
          cp4(sc + kPos + j, src.krope_s + sl, ok);
        }
      }
    }
  };

  if constexpr (Src::kPaged) {   // the entries of tiles 0 and 1
    for (int t = 0; t < 2 && t < n_tiles; ++t) {
      const int p0 = p_begin + t * kPos;
      if (tid < src.page_count(p0, p_end))
        pg_s[t * kMaxPages + tid] = src.page(src.first_page(p0) + tid);
    }
    __syncthreads();
  }

  // the query tile (rows past n_rows and the rope padding are zeros)
  for (int i = tid; i < kRowsTC * n_ch; i += kThreadsTC) {
    const int r = i / n_ch, col = (i % n_ch) * 8;
    const bool v = r < n_rows && col < Dq;
    cp16(q_s + swz(r, col, Ds), v ? q + (size_t)r * Dq + col : q, v);
  }
  issue_tile(0);
  cp_commit();

  float acc[kAccTiles][4];
#pragma unroll
  for (int n = 0; n < kAccTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  // output columns col0 .. col0 + cw of the group (whole 8-column tiles;
  // groups past Dl own none)
  const int cw = round_up((Dl + kGroups - 1) / kGroups, 8);
  const int col0 = grp * cw;

  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = p_begin + t * kPos;
    cp_wait_all();
    __syncthreads();        // tile t landed; tile t - 1 fully consumed
    if (t + 1 < n_tiles) issue_tile(t + 1);
    cp_commit();
    int page_next = -1;     // an entry of tile t + 2, stored below
    bool fetch_page = false;
    if constexpr (Src::kPaged) {
      const int p2 = p0 + 2 * kPos;
      fetch_page = t + 2 < n_tiles && tid < src.page_count(p2, p_end);
      if (fetch_page) page_next = src.page(src.first_page(p2) + tid);
    }

    const bf16* kv = kv_s;
    if constexpr (kCodes) {
      // codes of tile t -> bf16 tile buffer 0, exactly
      const unsigned char* cs = code_s + (size_t)(t & 1) * kPos * Ds;
      for (int i = tid; i < kPos * n_ch; i += kThreadsTC) {
        const int j = i / n_ch, col = (i % n_ch) * 8;
        const uint2 raw = *reinterpret_cast<const uint2*>(cs + j * Ds + col);
        const P* e = reinterpret_cast<const P*>(&raw);
        __nv_bfloat162 o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[k] = __floats2bfloat162_rn(to_f32(e[2 * k]), to_f32(e[2 * k + 1]));
        *reinterpret_cast<uint4*>(kv_s + swz(j, col, Ds)) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncthreads();
    } else {
      kv = kv_s + (size_t)(t & 1) * kPos * Ds;
    }

    // ---- S = Q K^T for rows 16 rg .., positions 8 kSTiles grp ..
    float s_lat[kSTiles][4], s_rope[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_lat[n][e] = s_rope[n][e] = 0.0f;
    const int pos0 = 8 * kSTiles * grp;       // the warp's first position
    const int a_row = 16 * rg + (lane & 15);
    const int b_row = pos0 + (lane & 7) + 8 * (lane >> 4);
    for (int k = 0; k < Dk; k += 16) {
      uint32_t a[4];
      ldsm4(a, q_s + swz(a_row, k + 8 * (lane >> 4), Ds));
#pragma unroll
      for (int np = 0; np < kSTiles / 2; ++np) {
        uint32_t b[4];
        ldsm4(b, kv + swz(b_row + 16 * np, k + 8 * ((lane >> 3) & 1), Ds));
        if (k < Dl) {
          mma(s_lat[2 * np], a, b[0], b[1]);
          mma(s_lat[2 * np + 1], a, b[2], b[3]);
        } else {
          mma(s_rope[2 * np], a, b[0], b[1]);
          mma(s_rope[2 * np + 1], a, b[2], b[3]);
        }
      }
    }

    // ---- scores, the tile's row maxima (shared by the row block's warps)
    const float* sc = sc_s + (t & 1) * 2 * kPos;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pos0 + 8 * n + 2 * c4 + (e & 1);
        float v = s_lat[n][e], vr = s_rope[n][e];
        if constexpr (kScaled) {
          v *= sc[pos];
          vr *= sc[kPos + pos];
        }
        v = p0 + pos < p_end ? (v + vr) * scale : kNegInf;
        if constexpr (kExpAdd) v *= kInvLn2;
        s_lat[n][e] = v;                       // the tile's scores
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (c4 == 0) red_s[grp * kRowsTC + 16 * rg + g + 8 * i] = mx[i];
    }
    if (fetch_page) pg_s[(t & 1) * kMaxPages + tid] = page_next;
    __syncthreads();

    // ---- online softmax: p, the running (m, l), acc rescaled
    float corr[2];
    int d_i[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * rg + g + 8 * i;
      float mt = red_s[r];
#pragma unroll
      for (int gg = 1; gg < kGroups; ++gg)
        mt = fmaxf(mt, red_s[gg * kRowsTC + r]);
      float m_new;
      if constexpr (kExpAdd) {
        m_new = ceilf(fmaxf(m[i], mt));
        d_i[i] = (int)fminf(fmaxf(m[i] - m_new, -254.0f), 0.0f);
        corr[i] = 1.0f;
      } else {
        m_new = fmaxf(m[i], mt);
        corr[i] = expf(m[i] - m_new);
      }
      m[i] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      const int pos = pos0 + 8 * n + 2 * c4;
      const bool v0 = p0 + pos < p_end, v1 = p0 + pos + 1 < p_end;
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = (e & 1) ? v1 : v0;
        const float x = s_lat[n][e] - m[e >> 1];
        // l sums p as PV sees it (rounded to bf16), so the weights that
        // multiply V add up to l exactly
        pr[e] = __bfloat162float(
            __float2bfloat16(v ? (kExpAdd ? exp2f(x) : expf(x)) : 0.0f));
        rs[e >> 1] += pr[e];
      }
      float f0 = 1.0f, f1 = 1.0f;
      if constexpr (kScaled) {
        f0 = sc[pos];
        f1 = sc[pos + 1];
      }
      const int r = 16 * rg + g;
      *reinterpret_cast<__nv_bfloat162*>(p_s + swz(r, pos, kPos)) =
          __floats2bfloat162_rn(pr[0] * f0, pr[1] * f1);
      *reinterpret_cast<__nv_bfloat162*>(p_s + swz(r + 8, pos, kPos)) =
          __floats2bfloat162_rn(pr[2] * f0, pr[3] * f1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = (kExpAdd ? exp_add_rescale(l[i], d_i[i]) : l[i] * corr[i]) +
             rs[i];
    }
    // a factor of 1 changes nothing: rescale only when a max moved
    const bool moved = kExpAdd ? (d_i[0] != 0 || d_i[1] != 0)
                               : (corr[0] != 1.0f || corr[1] != 1.0f);
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int n = 0; n < kAccTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kExpAdd)
            acc[n][e] = exp_add_rescale(acc[n][e], d_i[e >> 1]);
          else
            acc[n][e] *= corr[e >> 1];
        }
      }
    }
    __syncthreads();        // P complete

    // ---- O += P V for rows 16 rg .., columns col0 .. col0 + cw
#pragma unroll
    for (int ks = 0; ks < kPos / 16; ++ks) {
      uint32_t a[4];
      ldsm4(a, p_s + swz(a_row, 16 * ks + 8 * (lane >> 4), kPos));
      const int v_row = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int np = 0; np < kAccTiles / 2; ++np) {
        const int c = col0 + 16 * np;
        if (16 * np < cw && c < Dl) {
          uint32_t b[4];
          ldsm4_t(b, kv + swz(v_row, c + 8 * (lane >> 4), Ds));
          mma(acc[2 * np], a, b[0], b[1]);
          if (16 * np + 8 < cw && c + 8 < Dl)
            mma(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // ---- the row sums of the groups, then the partial out
  if (grp > 0 && c4 == 0) {
    red_s[grp * kRowsTC + 16 * rg + g] = l[0];
    red_s[grp * kRowsTC + 16 * rg + g + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * rg + g + 8 * i;
    if (r >= n_rows) continue;
    if (grp == 0 && c4 == 0) {
      float lt = l[i];
#pragma unroll
      for (int gg = 1; gg < kGroups; ++gg) lt += red_s[gg * kRowsTC + r];
      ml_out[((size_t)r * n_split + s) * 2] = m[i];
      ml_out[((size_t)r * n_split + s) * 2 + 1] = lt;
    }
    float* o = acc_out + (size_t)r * row_stride + (size_t)s * Dl + col0;
#pragma unroll
    for (int n = 0; n < kAccTiles; ++n)
      if (8 * n < cw && col0 + 8 * n < Dl)
        *reinterpret_cast<float2*>(o + 8 * n + 2 * c4) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// Merge the n_split partials of row blockIdx.x (one (request, head), or
// one (request, chunk row, head)) with the block's threads, 4 output
// columns a thread.
template <bool kExpAdd>
__device__ __forceinline__ void combine_row(const float* __restrict__ acc,
                                            const float* __restrict__ ml,
                                            bf16* __restrict__ out,
                                            int n_split, int Dl) {
  const size_t row = blockIdx.x;
  const float* mlr = ml + row * n_split * 2;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (mlr[2 * s + 1] > 0.0f) M = fmaxf(M, mlr[2 * s]);
  for (int d = threadIdx.x * 4; d < Dl; d += blockDim.x * 4) {
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float l = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float ls = mlr[2 * s + 1];
      if (ls == 0.0f) continue;           // an empty split
      const float4 x =
          *reinterpret_cast<const float4*>(acc + (row * n_split + s) * Dl + d);
      if constexpr (kExpAdd) {
        const int di = (int)fminf(fmaxf(mlr[2 * s] - M, -254.0f), 0.0f);
        a.x += exp_add_rescale(x.x, di);
        a.y += exp_add_rescale(x.y, di);
        a.z += exp_add_rescale(x.z, di);
        a.w += exp_add_rescale(x.w, di);
        l += exp_add_rescale(ls, di);
      } else {
        const float c = expf(mlr[2 * s] - M);
        a.x += x.x * c;
        a.y += x.y * c;
        a.z += x.z * c;
        a.w += x.w * c;
        l += ls * c;
      }
    }
    const float inv = l == 0.0f ? 1.0f : 1.0f / l;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + row * Dl + d);
    o[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    o[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
}

// The combine of the decode kernels K1 and K3: grid B * H, 128 threads.
template <bool kExpAdd>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
               bf16* __restrict__ out, int n_split, int Dl) {
  combine_row<kExpAdd>(acc, ml, out, n_split, Dl);
}

// Launch the split kernel on grid (H / 64, n_split, B), then `combine`
// (a kernel that calls combine_row) on B * H rows; returns the first
// launch error.
template <typename Combine, typename Kernel, typename... Args>
cudaError_t launch_split(Combine combine, Kernel kernel, size_t smem, int B,
                         int H, int n_split, int Dl, const float* ws_acc,
                         const float* ws_ml, bf16* out, cudaStream_t stream,
                         Args... args) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kRowsTC - 1) / kRowsTC, n_split, B);
  kernel<<<grid, kThreadsTC, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine<<<B * H, 128, 0, stream>>>(ws_acc, ws_ml, out, n_split, Dl);
  return cudaGetLastError();
}

// What the tensor-core walk takes (the wrappers check the rest): Dr a
// multiple of 8 (16-byte bf16 chunks, 8-byte code chunks), the score
// depth within the buffers, at least one split of whole tiles.
inline bool shape_ok(int Dl, int Dr, int n_split, int split_pos) {
  return Dl % 16 == 0 && Dl <= kMaxDl && Dr % 8 == 0 && Dr > 0 &&
         Dl + round_up(Dr, 16) <= kMaxK && n_split >= 1 && split_pos > 0 &&
         split_pos % kPos == 0;
}

}  // namespace tc
}  // namespace mla
