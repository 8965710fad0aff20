// Flash attention forward for Hopper (sm_90a): O = softmax(Q·Kᵀ·D^-½)·V
// and the per-row log-sum-exp, without materialising the S×S scores.
//
// Replaces torchsnapshot_tpu/ops/attention.py:_flash_kernel (the Pallas
// kernel launched by _flash_forward). The arithmetic is the same: Q, K
// and V are cast to f32 before the products, the scale is applied after
// Q·Kᵀ, causally masked scores are -1e30, the running max, denominator
// and accumulator are f32, a row whose denominator is 0 divides by 1, and
// lse = m + log(denominator). GQA maps q-head h to kv-head h / group from
// the row index, as _kv_index_map does; K/V are never repeated in memory.
//
// Structure. The Pallas kernel steps a sequential third grid axis over
// key blocks and carries the online-softmax state in VMEM scratch. Here
// one thread block owns one 64-row query tile of one (batch, q-head) row
// and loops over 64-key tiles itself; the loop stops at the diagonal tile
// when causal. The softmax state and the output accumulator live in
// registers: thread (ty, tx) of the 16×16 layout holds rows ty*4..ty*4+3,
// score columns tx+16j and output columns tx+16c, and the 16 threads
// sharing a row reduce its max and sum with warp shuffles. Keys past the
// end of a sequence whose length is not a multiple of 64 get p = 0.
//
// What bounds it. Its arithmetic intensity is ~S/2 flop per byte of
// Q/K/V, far above the H100's ~20 flop/byte for f32, so the bound is
// operations, not bytes. This version does them as scalar f32 FMAs out of
// shared memory (padded row strides keep the loads free of bank
// conflicts; K and V share one tile buffer to fit two blocks on an SM at
// head_dim 128), which caps it well below the f32 peak of 67 TFLOP/s and
// far below the tensor cores' 989 TFLOP/s for bf16 inputs. mma/wgmma
// tiles and TMA-fed pipelining are the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr float kMaskValue = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

template <int kDMax>
constexpr size_t smem_bytes() {
  // Q tile and the shared K/V tile with a padded stride, plus the P tile.
  return sizeof(float) *
         (size_t)(2 * kBlockM * (kDMax + 1) + kBlockM * (kBlockN + 1));
}

// Loads rows [row0, row0+64) of a [s_len, d] matrix into a [64][kDMax+1]
// f32 tile, zero-filling rows past s_len and columns past d.
template <typename T, int kDMax>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src,
                                          int row0, int s_len, int d) {
  constexpr int kStride = kDMax + 1;
  for (int idx = threadIdx.x; idx < kBlockM * kDMax; idx += kThreads) {
    const int r = idx / kDMax;
    const int c = idx - r * kDMax;
    float val = 0.f;
    if (row0 + r < s_len && c < d) val = to_f32(src[(size_t)(row0 + r) * d + c]);
    tile[r * kStride + c] = val;
  }
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int group, int s_len, int d,
                 float scale, int causal) {
  constexpr int kStride = kDMax + 1;
  constexpr int kPStride = kBlockN + 1;
  constexpr int kCols = kDMax / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_tile = smem;
  float* kv_tile = q_tile + kBlockM * kStride;
  float* p_tile = kv_tile + kBlockN * kStride;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int hkv = hq / group;
  const int kv_row = (bh / hq) * hkv + (bh % hq) / group;
  const size_t plane = (size_t)s_len * d;
  const T* q_bh = q + (size_t)bh * plane;
  const T* k_bh = k + (size_t)kv_row * plane;
  const T* v_bh = v + (size_t)kv_row * plane;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, kDMax>(q_tile, q_bh, q0, s_len, d);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles_all = (s_len + kBlockN - 1) / kBlockN;
  const int n_tiles =
      causal ? min(n_tiles_all, (q0 + kBlockM - 1) / kBlockN + 1) : n_tiles_all;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile's P·V reads are done
    load_tile<T, kDMax>(kv_tile, k_bh, k0, s_len, d);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_tile[(ty * 4 + i) * kStride + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_tile[(tx + 16 * j) * kStride + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (k_pos >= s_len) {
          s = -INFINITY;  // no such key
        } else if (causal && k_pos > q_pos) {
          s = kMaskValue;
        }
        sc[i][j] = s;
        row_max = fmaxf(row_max, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = (k0 + col >= s_len) ? 0.f : expf(sc[i][j] - m_new);
        p_tile[(ty * 4 + i) * kPStride + col] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // K reads done, P visible
    load_tile<T, kDMax>(kv_tile, v_bh, k0, s_len, d);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockN; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_tile[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = kv_tile[kk * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_len) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
    T* o_row = o + (size_t)bh * plane + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) o_row[col] = from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0) lse[(size_t)bh * s_len + row] = m[i] + logf(denom);
  }
}

template <typename T, int kDMax>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int b, int hq, int hkv, int s_len, int d, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, kDMax>;
  constexpr size_t smem = smem_bytes<kDMax>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s_len + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), hq, hq / hkv, s_len, d, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         void* lse, int b, int hq, int hkv, int s_len, int d,
                         float scale, int causal, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, stream);
  return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Tensors are contiguous:
// q, o [b, hq, s_len, d]; k, v [b, hkv, s_len, d]; lse [b, hq, s_len] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int b, int hq, int hkv, int s_len, int d,
                         int dtype, int causal, float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 || d <= 0 ||
      d > 128 || (s_len + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_dim<float>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, st);
    case 1:
      return (int)dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, st);
    case 2:
      return (int)dispatch_dim<__half>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
