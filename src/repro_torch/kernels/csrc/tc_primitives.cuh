// Hopper building blocks shared by the tensor-core walks: the split-KV
// MLA decode / prefill walk (mla_decode_tc.cuh, kernels K1, K2, K3) and
// the flash-attention walks (flash_attention_fwd_tc.cuh, K4;
// flash_attention_bwd_tc.cuh, K5 and K6).
//
//   swz          the XOR swizzle of 16-byte chunks in a shared-memory row
//   cp16/8/4     cp.async copies with zero fill, cp_commit / cp_wait_all
//   ldsm4(_t)    ldmatrix x4 (and transposed) into mma fragments
//   mma          mma.sync m16n8k16, bf16 in, f32 accumulate
//   pack_bf16    two f32 results as one bf16x2 mma operand register
//   copy_tile    a bf16 tile into a swizzled buffer with 16-byte cp.async
//                (copy_tile_rows: the same, each row's address once)
//   opt_in_smem  the per-kernel dynamic shared-memory opt-in, once
//
// Nothing here knows about attention: the walks own their layouts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr size_t kSmemMax = 232448;         // per-block opt-in limit, H100

// Element offset of (row, col) in a swizzled buffer of row stride Ds.
__device__ __forceinline__ int swz(int row, int col, int Ds) {
  return row * Ds + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `valid` false copies no byte and writes zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b: one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values packed into one 32-bit register (lo in the low half):
// an mma operand made from two f32 results.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Copy a (kTileRows x D) bf16 tile at src (row stride `stride` elements)
// into the swizzled buffer dst of row stride Ds with the CTA's kThreads
// threads; rows past n_valid are zero-filled.  Chunks go in groups of 8
// (64 columns), so a thread's row and chunk are shifts, not divisions.
template <int kTileRows, int kThreads>
__device__ __forceinline__ void copy_tile(bf16* dst, int Ds,
                                          const bf16* src, long long stride,
                                          int n_valid, int D) {
  for (int c0 = 0; c0 < D; c0 += 64) {
#pragma unroll
    for (int i = threadIdx.x; i < kTileRows * 8; i += kThreads) {
      const int j = i >> 3, col = c0 + ((i & 7) << 3);
      if (col < D) {
        const bool ok = j < n_valid;
        cp16(dst + swz(j, col, Ds), ok ? src + j * stride + col : src, ok);
      }
    }
  }
}

// copy_tile with a thread's chunks of one row taken together (64 columns
// apart), so each row's source address is computed once: fewer
// instructions a copy.  The backward walks issue a copy for every tile
// and run ~1-2 ms faster with it at the training path's shapes; the
// forward walk, at 255 registers, spills with it and runs ~0.4 ms slower
// (chip_profile.py flash, on an H100), so it keeps copy_tile.
template <int kTileRows, int kThreads>
__device__ __forceinline__ void copy_tile_rows(bf16* dst, int Ds,
                                               const bf16* src,
                                               long long stride, int n_valid,
                                               int D) {
#pragma unroll
  for (int i = threadIdx.x; i < kTileRows * 8; i += kThreads) {
    const int j = i >> 3;
    const bool ok = j < n_valid;
    const bf16* row = ok ? src + j * stride : src;
    for (int col = (i & 7) << 3; col < D; col += 64)
      cp16(dst + swz(j, col, Ds), row + (ok ? col : 0), ok);
  }
}

// Raise a kernel's dynamic shared-memory ceiling to kSmemMax, which every
// layout fits under, once for each kernel and device rather than on every
// launch: the attribute call costs host time on a path that takes tens of
// microseconds on the device.
inline cudaError_t opt_in_smem(const void* kernel) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == kernel && d.second == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err == cudaSuccess) done.emplace_back(kernel, dev);
  return err;
}

}  // namespace hopper
