// Building blocks shared by the flash attention kernels for Hopper
// (sm_90a): shared-memory strides, cp.async copies of row tiles, and the
// warp-level tensor-core fragments (mma.sync, ldmatrix) with the operand
// splits that give f32 accuracy from tf32 and from 16-bit products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
__host__ __device__ constexpr bool is_f32() { return std::is_same<T, float>::value; }

// Shared row stride in elements: 16-byte aligned rows, and padded so that
// tf32 fragment loads (f32, stride ≡ 4 mod 32 words) and ldmatrix rows
// (16 bits, stride ≡ 16 mod 128 bytes) hit distinct banks.
template <typename T, int kD>
__host__ __device__ constexpr int smem_stride() { return is_f32<T>() ? kD + 4 : kD + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + kRows) of a [s_len, d] matrix into columns [0, d) of
// a [kRows][kS] tile in 16-byte copies, spread over the block's threads;
// rows past s_len zero-filled. d·sizeof(T) is a multiple of 16 (the
// wrappers pad).
template <typename T, int kRows, int kS>
__device__ __forceinline__ void load_rows_async(T* tile, const T* __restrict__ src, int row0,
                                                int s_len, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = d / kVec;
  for (int idx = threadIdx.x; idx < kRows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * kVec;
    const bool valid = row0 + r < s_len;
    cp_async16(tile + r * kS + c, valid ? src + (size_t)(row0 + r) * d + c : src, valid);
  }
}

// Zeroes columns [d, kD) of n_rows rows of stride kS: the fragment loads
// read kD columns, the copies write only [0, d).
template <typename T, int kD, int kS>
__device__ __forceinline__ void zero_tail_columns(T* rows, int n_rows, int d) {
  const int width = kD - d;
  if (width <= 0) return;
  for (int idx = threadIdx.x; idx < n_rows * width; idx += blockDim.x) {
    const int r = idx / width;
    rows[r * kS + d + (idx - r * width)] = T(0.f);
  }
}

// ---- tensor-core fragments -------------------------------------------------
//
// m16n8k8 tf32 (lane = 4·g + t): A a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C c0/c1 (g, 2t/2t+1),
// c2/c3 (g+8, 2t/2t+1). m16n8k16 (16 bits, two values a register): A a0
// (g, 2t..2t+1), a1 (g+8, ·), a2 (g, 2t+8..), a3 (g+8, 2t+8..); B b0
// (k 2t..2t+1, n g), b1 (k 2t+8.., n g); C as above.

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite value (to
// nearest, ties away from zero) in two integer operations. The cvt also
// handles NaN and infinity, which no operand here is, and costs several
// instructions more: the splits, not the mma, set the f32 kernels' pace.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma_16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two f32 values as hi and lo packed pairs of T (x0 in the low half):
// x = hi + lo to ~16 (bf16) or ~22 (f16) significant bits.
template <typename T>
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

}  // namespace
