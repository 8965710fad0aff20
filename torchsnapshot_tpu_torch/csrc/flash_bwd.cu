// Flash attention backward for Hopper (sm_90a): dq, and per-q-head dk and
// dv, of O = softmax(Q·Kᵀ·D^-½)·V, from the forward's per-row log-sum-exp,
// without materialising the S×S scores.
//
// Replaces two Pallas kernels of torchsnapshot_tpu/ops/attention.py, both
// launched by _flash_backward around their shared core _bwd_pieces:
//
//   flash_bwd_dq   <- _flash_bwd_dq_kernel:  per query tile, over key tiles,
//                     dq += scale · ds·K
//   flash_bwd_dkv  <- _flash_bwd_dkv_kernel: per key tile, over query tiles,
//                     dv += pᵀ·dO and dk += scale · dsᵀ·Q, per q-head
//
// The arithmetic is the Pallas kernels': Q, K, V and dO are f32 before
// the products (the wrapper hands dO over in f32, which is exact for a
// bf16/f16 cotangent), s = (Q·Kᵀ)·scale, p = exp(s − lse) where
// lse > -5e29 and 0 where the forward wrote the -1e30 sentinel (the exp is
// never taken of s + 1e30), causally masked pairs get p = 0,
// dP = dO·Vᵀ, ds = p·(dP − delta) with delta = rowsum(dO·O) − dlse given
// by the wrapper, and every sum is f32. GQA maps q-head h to kv-head
// h / group from the row index, as _kv_index_map does. flash_bwd_dkv
// writes one dk/dv plane per q-head; the wrapper sums each group of
// planes into its kv-head, as the JAX package does after its call. The
// two-kernel split is deterministic: no atomics, each output element is
// summed by one thread in one order.
//
// Structure. Each Pallas kernel steps a sequential third grid axis and
// carries its accumulator in VMEM scratch. Here one thread block owns one
// 64-row tile of one (batch, q-head) row and loops over the other axis
// itself, keeping the accumulators in registers: thread (ty, tx) of the
// 16×16 layout holds tile rows ty*4..ty*4+3 and output columns tx+16c.
// flash_bwd_dq stops at the diagonal key tile when causal; flash_bwd_dkv
// starts at the diagonal query tile (query tile index >= key tile index:
// both tiles are 64 rows). Rows and keys past the end of a sequence whose
// length is not a multiple of 64 load as zeros, get p = 0 (their lse
// loads as the sentinel) and are never written.
//
// What bounds it. The backward does 3 (dq) and 4 (dk, dv) products of
// 2·D flops per kept (query, key) pair against O(S·D) bytes: ~S/2 flop
// per byte, far above the H100's ~20 flop/byte for f32, so the bound is
// operations. This version does them as scalar f32 FMAs out of shared
// memory (padded row strides keep the loads free of bank conflicts), as
// flash_fwd.cu does, which caps it well below the f32 peak of 67 TFLOP/s
// and far below the tensor cores' 989 TFLOP/s for bf16 inputs. Tiles for
// mma/wgmma fed by TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr float kMaskValue = -1e30f;
constexpr float kLseFloor = -5e29f;  // lse at or below this: all-masked row

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

// p of one (query, key) pair from its raw score Q·Kᵀ.
__device__ __forceinline__ float recompute_p(float raw, float scale, float lse,
                                             bool keep) {
  if (!keep || !(lse > kLseFloor)) return 0.f;
  return expf(raw * scale - lse);
}

template <int kDMax>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K and V tiles with a padded stride, plus the ds tile.
  return sizeof(float) *
         (size_t)(4 * kBlockM * (kDMax + 1) + kBlockM * (kBlockN + 1));
}

template <int kDMax>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q and dO tiles with a padded stride, plus the p and ds tiles.
  return sizeof(float) *
         (size_t)(4 * kBlockM * (kDMax + 1) + 2 * kBlockN * (kBlockM + 1));
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ d_out,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int hq, int group, int s_len, int d,
                    float scale, int causal) {
  constexpr int kStride = kDMax + 1;
  constexpr int kPStride = kBlockN + 1;
  constexpr int kCols = kDMax / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_tile = smem;
  float* do_tile = q_tile + kBlockM * kStride;
  float* k_tile = do_tile + kBlockM * kStride;
  float* v_tile = k_tile + kBlockN * kStride;
  float* ds_tile = v_tile + kBlockN * kStride;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int hkv = hq / group;
  const int kv_row = (bh / hq) * hkv + (bh % hq) / group;
  const size_t plane = (size_t)s_len * d;
  const T* k_bh = k + (size_t)kv_row * plane;
  const T* v_bh = v + (size_t)kv_row * plane;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, kDMax>(q_tile, q + (size_t)bh * plane, q0, s_len, d);
  load_tile<float, kDMax>(do_tile, d_out + (size_t)bh * plane, q0, s_len, d);

  float row_lse[4], row_delta[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    row_lse[i] = row < s_len ? lse[(size_t)bh * s_len + row] : kMaskValue;
    row_delta[i] = row < s_len ? delta[(size_t)bh * s_len + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles_all = (s_len + kBlockN - 1) / kBlockN;
  const int n_tiles =
      causal ? min(n_tiles_all, (q0 + kBlockM - 1) / kBlockN + 1) : n_tiles_all;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile's ds·K reads are done
    load_tile<T, kDMax>(k_tile, k_bh, k0, s_len, d);
    load_tile<T, kDMax>(v_tile, v_bh, k0, s_len, d);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_tile[(ty * 4 + i) * kStride + dd];
        ov[i] = do_tile[(ty * 4 + i) * kStride + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_tile[(tx + 16 * j) * kStride + dd];
        vv[j] = v_tile[(tx + 16 * j) * kStride + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool keep = k_pos < s_len && !(causal && k_pos > q_pos);
        const float p = recompute_p(sc[i][j], scale, row_lse[i], keep);
        ds_tile[(ty * 4 + i) * kPStride + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();  // ds visible

#pragma unroll 4
    for (int kk = 0; kk < kBlockN; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_tile[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kval = k_tile[kk * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kval, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_len) continue;
    float* dq_row = dq + (size_t)bh * plane + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dq_row[col] = scale * acc[i][c];
    }
  }
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ d_out,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int hq,
                     int group, int s_len, int d, float scale, int causal) {
  constexpr int kStride = kDMax + 1;
  constexpr int kPStride = kBlockM + 1;
  constexpr int kCols = kDMax / 16;
  extern __shared__ float smem[];
  float* k_tile = smem;
  float* v_tile = k_tile + kBlockN * kStride;
  float* q_tile = v_tile + kBlockN * kStride;
  float* do_tile = q_tile + kBlockM * kStride;
  float* p_tile = do_tile + kBlockM * kStride;  // [key][query] = pᵀ
  float* ds_tile = p_tile + kBlockN * kPStride;  // [key][query] = dsᵀ

  const int bh = blockIdx.x;
  const int key_tile = blockIdx.y;
  const int k0 = key_tile * kBlockN;
  const int hkv = hq / group;
  const int kv_row = (bh / hq) * hkv + (bh % hq) / group;
  const size_t plane = (size_t)s_len * d;
  const T* q_bh = q + (size_t)bh * plane;
  const float* do_bh = d_out + (size_t)bh * plane;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, kDMax>(k_tile, k + (size_t)kv_row * plane, k0, s_len, d);
  load_tile<T, kDMax>(v_tile, v + (size_t)kv_row * plane, k0, s_len, d);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q_tiles = (s_len + kBlockM - 1) / kBlockM;
  const int first = causal ? key_tile : 0;

  for (int t = first; t < n_q_tiles; ++t) {
    const int q0 = t * kBlockM;
    __syncthreads();  // the previous tile's reads of Q, dO, p and ds are done
    load_tile<T, kDMax>(q_tile, q_bh, q0, s_len, d);
    load_tile<float, kDMax>(do_tile, do_bh, q0, s_len, d);
    __syncthreads();

    float col_lse[4], col_delta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = q0 + tx + 16 * j;
      col_lse[j] = col < s_len ? lse[(size_t)bh * s_len + col] : kMaskValue;
      col_delta[j] = col < s_len ? delta[(size_t)bh * s_len + col] : 0.f;
    }

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = k_tile[(ty * 4 + i) * kStride + dd];
        vv[i] = v_tile[(ty * 4 + i) * kStride + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = q_tile[(tx + 16 * j) * kStride + dd];
        ov[j] = do_tile[(tx + 16 * j) * kStride + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k_pos = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q_pos = q0 + tx + 16 * j;
        const bool keep = k_pos < s_len && !(causal && k_pos > q_pos);
        const float p = recompute_p(st[i][j], scale, col_lse[j], keep);
        const int at = (ty * 4 + i) * kPStride + tx + 16 * j;
        p_tile[at] = p;
        ds_tile[at] = p * (dpt[i][j] - col_delta[j]);
      }
    }
    __syncthreads();  // p and ds visible

#pragma unroll 4
    for (int qq = 0; qq < kBlockM; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = p_tile[(ty * 4 + i) * kPStride + qq];
        dsv[i] = ds_tile[(ty * 4 + i) * kPStride + qq];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float oval = do_tile[qq * kStride + tx + 16 * c];
        const float qval = q_tile[qq * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pv[i], oval, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qval, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= s_len) continue;
    float* dk_row = dk + (size_t)bh * plane + (size_t)row * d;
    float* dv_row = dv + (size_t)bh * plane + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk_row[col] = scale * dk_acc[i][c];
        dv_row[col] = dv_acc[i][c];
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* d_out;
  const void* lse;
  const void* delta;
  void* dq;
  void* dk;
  void* dv;
  int b, hq, hkv, s_len, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int kDMax>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, kDMax>;
  constexpr size_t smem = dq_smem_bytes<kDMax>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.hq, (a.s_len + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.d_out),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.hq, a.hq / a.hkv, a.s_len, a.d, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int kDMax>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, kDMax>;
  constexpr size_t smem = dkv_smem_bytes<kDMax>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.hq, (a.s_len + kBlockN - 1) / kBlockN);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.d_out),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.hq, a.hq / a.hkv,
      a.s_len, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kDkv, typename T>
cudaError_t dispatch_dim(const Args& a) {
  if (a.d <= 64) return kDkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  return kDkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
}

template <bool kDkv>
int dispatch(const Args& a, int dtype) {
  if (a.b <= 0 || a.hq <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0 || a.s_len <= 0 ||
      a.d <= 0 || a.d > 128 || (a.s_len + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)dispatch_dim<kDkv, float>(a);
    case 1:
      return (int)dispatch_dim<kDkv, __nv_bfloat16>(a);
    case 2:
      return (int)dispatch_dim<kDkv, __half>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q, k, v): 0 = float32, 1 = bfloat16, 2 = float16. Tensors are
// contiguous: q [b, hq, s_len, d]; k, v [b, hkv, s_len, d]; d_out f32
// [b, hq, s_len, d]; lse and delta f32 [b, hq, s_len]; dq, dk and dv f32
// [b, hq, s_len, d] (dk and dv per q-head). Each returns the cudaError_t of
// its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* d_out, const void* lse, const void* delta,
                            void* dq, int b, int hq, int hkv, int s_len, int d,
                            int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, d_out, lse, delta, dq, nullptr, nullptr, b, hq, hkv,
               s_len, d, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dtype);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* d_out, const void* lse, const void* delta,
                             void* dk, void* dv, int b, int hq, int hkv, int s_len,
                             int d, int dtype, int causal, float scale,
                             void* stream) {
  const Args a{q, k, v, d_out, lse, delta, nullptr, dk, dv, b, hq, hkv,
               s_len, d, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dtype);
}
