// Flash attention forward for Hopper (sm_90a): O = softmax(Q·Kᵀ·D^-½)·V
// and the per-row log-sum-exp, without materialising the S×S scores.
//
// Replaces torchsnapshot_tpu/ops/attention.py:_flash_kernel (:103, the
// Pallas kernel launched by _flash_forward). The arithmetic is the same:
// the scale is applied after Q·Kᵀ, causally masked scores are -1e30, keys
// past a ragged end give p = 0, the running max, denominator and output
// accumulator are f32, a row whose denominator is 0 divides by 1, and
// lse = m + log(denominator). GQA maps q-head h to kv-head h / group, as
// _kv_index_map does; K and V are never repeated in memory. O comes out in
// the input type, lse in f32. Deterministic: no atomics, every output is
// summed by one thread in one fixed order.
//
// What bounds it. Two products of 2·D flops per kept (query, key) pair
// against O(S·D) bytes: ~S/2 flop per byte, far above the H100's ridge,
// so at the main path's shape ([4,25,1024,64] f32 causal) the bound is
// operations on the tensor cores. Every product runs there as warp-level
// mma.sync with f32 accumulators in registers:
//
//   f32 inputs: 3xTF32. hi = tf32(x), lo = tf32(x − hi), and A·B is taken
//     as Ahi·Bhi + Ahi·Blo + Alo·Bhi with m16n8k8 tf32 mma: f32 accuracy
//     at a third of the 495 TFLOP/s TF32 rate.
//   bf16/f16 inputs: m16n8k16 mma in the input type. Q·Kᵀ is exact; p
//     (f32) is split into hi + lo terms of the input type, two mma, so
//     P·V is not rounded to 16 bits.
//
// What the design does about it. Such kernels are held back less by the
// tensor cores than by the instruction stream around each mma, above all
// the tf32 splits of the f32 path, and by how few warps an SM holds to
// hide its latency. So each operand is split as few times as the
// registers allow. f32 Q is split once per block, into tf32 hi and lo
// planes in shared memory (its A fragments do not fit in registers beside
// S and O at 32 rows a warp or at head_dim 128); 16-bit Q needs no split,
// and each warp holds its A fragments in registers across the key loop.
// For f32 at head_dim 64 a warp owns 32 query rows, so each K or V
// fragment it splits feeds two m16 tiles. Splitting K and V once per
// block instead, into hi and lo planes, doubles the shared-memory bytes
// of every B fragment and the block's footprint, and was slower on the
// card (PERF.md). p is split from the accumulator registers, once per
// warp. exp is ex2.approx (two instructions, where expf takes about
// eight).
//
// Structure. Four warps own 16 or 32 query rows each of a tile of one
// (batch, q-head); a loop in the block streams the key tiles through a
// two-stage cp.async ring (tile t+1 lands while tile t is computed; one
// barrier a tile). S stays in registers, and p feeds P·V straight from the
// accumulator layout: for 16 bits two n8 accumulator tiles are one k16
// operand; for tf32 the k order inside an 8-wide step is permuted
// (operand column t is key 2t, column t+4 is key 2t+1) and the V rows are
// read in the same order; Q·Kᵀ permutes its k order the same way, so each
// lane reads Q and K in 8-byte pairs. The online softmax reduces each
// row's max over the 4 lanes that share it and rescales O only when some
// row's max moved; the denominator is summed per lane and reduced once at
// the end. Masks are applied only on tiles that cross the diagonal or the
// ragged end; a warp skips a tile whose keys all lie past its rows.
// Causal: the loop stops at the diagonal, and blockIdx.y is mapped so that
// the blocks with the most tiles launch first. O is staged through shared
// memory and written with 16-byte stores; lse by one lane a row. Shared
// strides are padded so that fragment loads and ldmatrix are free of bank
// conflicts; columns past d are zero in shared memory.

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -1e30f;
// f32: n-tiles of B read together, then each 3xTF32 term issued across
// them, so no mma waits on the one before it.
constexpr int kChunk = 4;

// One configuration of the kernel. T is the input type; kD the head_dim it
// is compiled for (the true one is at most kD; columns past it are zero);
// each warp owns kMT m16 tiles of query rows; a key tile has kN keys.
template <typename T, int kD_, int kMT_, int kN_>
struct Cfg {
  using Elem = T;
  static constexpr int kD = kD_, kMT = kMT_, kN = kN_;
  static constexpr bool kF32 = is_f32<T>();
  // Q and K rows: f32 is read in 8-byte k-pairs, a half-warp at a time,
  // conflict-free at a stride ≡ 8 mod 32 words; 16 bits by ldmatrix.
  static constexpr int kSK = kD + 8;
  // V rows (and the staged O): f32 B fragments of P·V read two keys 2t,
  // 2t+1 of one column, conflict-free at the common stride rule.
  static constexpr int kSV = smem_stride<T, kD>();
  static constexpr int kBM = 16 * kMT * kWarps;  // query rows of a block
  static constexpr int kNT = kN / 8;             // key n8 tiles of S
  static constexpr int kDT = kD / 8;             // column n8 tiles of O
  // Q: f32 as pre-split tf32 hi and lo planes (their A fragments do not
  // fit in registers beside S and O at 32 rows a warp or head_dim 128);
  // 16 bits as a tile whose A fragments each warp holds in registers.
  static constexpr int kQ = (kF32 ? 2 : 1) * kBM * kSK;
  static constexpr int kStage = kN * (kSK + kSV);  // a K and a V tile
  static constexpr int kQFrags = kF32 ? 1 : kD / 16;
  static constexpr size_t kBytes = sizeof(T) * (size_t)(kQ + 2 * kStage);
  // 16 bits: three blocks an SM, so at most 168 registers a thread (ptxas
  // gave the f16 kernel at head_dim 128 171 unbounded, which fit two).
  static constexpr int kMinBlocks = kF32 ? 1 : 3;
  static_assert(kF32 || kMT == 1, "16-bit warps own 16 rows");
  static_assert(kBM * kSV <= kQ, "O is staged where Q was");
  static_assert(kNT % kChunk == 0 && kDT % kChunk == 0, "n-tiles come in whole chunks");
};

// The f32 values this thread copied with load_rows_async<float, kRows>
// (the same pieces, by the same thread), once landed, split into tf32 hi
// (in place) and lo (same offset in lo): Q's planes, split once per block.
template <int kRows, int kS>
__device__ __forceinline__ void split_rows(float* tile, float* lo, int d) {
  const int chunks = d / 4;
  for (int idx = threadIdx.x; idx < kRows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int off = r * kS + (idx - r * chunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// e^x as ex2.approx(x·log2 e): two instructions where expf takes about
// eight. The result is within ~2 ulp of 2^(x·log2 e), whose rounded
// exponent moves it by at most |x|·2^-24 relative: below 1e-6 for every
// p > 1e-7; an x of -inf or -1e30 gives 0.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The warp's 16-bit Q A-fragments, loaded once per block: qf[kt] of
// k-step kt.
template <class C>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[C::kQFrags][4],
                                             const typename C::Elem* q_w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kt = 0; kt < C::kD / 16; ++kt)
    ldsm_x4(qf[kt], q_w + (lane % 16) * C::kSK + 16 * kt + (lane / 16) * 8);
}

// s[mt][n] = Q·Kᵀ for the warp's kMT m16 tiles and the kNT key n-tiles of
// the tile k_t, over kD: f32 Q from its planes at q_w, 16-bit Q from the
// registers qf; stride kSK.
template <class C>
__device__ __forceinline__ void qk_product(float (&s)[C::kMT][C::kNT][4],
                                           const uint32_t (&qf)[C::kQFrags][4],
                                           const typename C::Elem* q_w,
                                           const typename C::Elem* k_t) {
  constexpr int kSK = C::kSK, kMT = C::kMT, kNT = C::kNT;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (C::kF32) {
    // The k order inside a step is free: operand column t is k 2t and
    // column t+4 is k 2t+1, for A and B alike, so each lane reads 8-byte
    // pairs. Each K value is split by the warp that reads it, once for
    // all kMT m-tiles.
#pragma unroll
    for (int kt = 0; kt < C::kD / 8; ++kt) {
      uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        constexpr int kLo = C::kBM * kSK;  // Q's lo plane
        const float* a = q_w + (16 * mt + g) * kSK + 8 * kt + 2 * t;
        const uint2 top_hi = *reinterpret_cast<const uint2*>(a);
        const uint2 top_lo = *reinterpret_cast<const uint2*>(a + kLo);
        const uint2 bottom_hi = *reinterpret_cast<const uint2*>(a + 8 * kSK);
        const uint2 bottom_lo = *reinterpret_cast<const uint2*>(a + 8 * kSK + kLo);
        a_hi[mt][0] = top_hi.x;
        a_hi[mt][1] = bottom_hi.x;
        a_hi[mt][2] = top_hi.y;
        a_hi[mt][3] = bottom_hi.y;
        a_lo[mt][0] = top_lo.x;
        a_lo[mt][1] = bottom_lo.x;
        a_lo[mt][2] = top_lo.y;
        a_lo[mt][3] = bottom_lo.y;
      }
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kChunk) {
        uint32_t b_hi[kChunk][2], b_lo[kChunk][2];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float2 b =
              *reinterpret_cast<const float2*>(k_t + (8 * (n0 + c) + g) * kSK + 8 * kt + 2 * t);
          split_tf32(b.x, b_hi[c][0], b_lo[c][0]);
          split_tf32(b.y, b_hi[c][1], b_lo[c][1]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            mma_tf32(s[mt][n0 + c], a_lo[mt], b_hi[c][0], b_hi[c][1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            mma_tf32(s[mt][n0 + c], a_hi[mt], b_lo[c][0], b_lo[c][1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            mma_tf32(s[mt][n0 + c], a_hi[mt], b_hi[c][0], b_hi[c][1]);
      }
    }
  } else {
    using T = typename C::Elem;
#pragma unroll
    for (int kt = 0; kt < C::kD / 16; ++kt) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, k_t + (16 * np + (lane % 8) + (lane / 16) * 8) * kSK + 16 * kt +
                        ((lane / 8) % 2) * 8);
        mma_16<T>(s[0][2 * np], qf[kt], bf[0], bf[1]);
        mma_16<T>(s[0][2 * np + 1], qf[kt], bf[2], bf[3]);
      }
    }
  }
}

// o[mt][n] += P·V for the warp's kMT m16 tiles: P is f32 in the
// accumulator layout of S (split hi + lo here), v_t the [kN][kSV] V tile
// (f32: each value split by the warp that reads it, once for all kMT
// m-tiles).
template <class C>
__device__ __forceinline__ void pv_product(float (&o)[C::kMT][C::kDT][4],
                                           const float (&p)[C::kMT][C::kNT][4],
                                           const typename C::Elem* v_t) {
  constexpr int kSV = C::kSV, kMT = C::kMT, kNT = C::kNT, kDT = C::kDT;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (C::kF32) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      // Operand column t is key 2t of the step and column t+4 key 2t+1:
      // the accumulator layout, read with V rows in the same order.
      uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        split_tf32(p[mt][j][0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(p[mt][j][2], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(p[mt][j][1], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(p[mt][j][3], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < kDT; n0 += kChunk) {
        uint32_t b_hi[kChunk][2], b_lo[kChunk][2];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float* b = v_t + (8 * j + 2 * t) * kSV + 8 * (n0 + c) + g;
          split_tf32(b[0], b_hi[c][0], b_lo[c][0]);
          split_tf32(b[kSV], b_hi[c][1], b_lo[c][1]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            mma_tf32(o[mt][n0 + c], a_lo[mt], b_hi[c][0], b_hi[c][1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            mma_tf32(o[mt][n0 + c], a_hi[mt], b_lo[c][0], b_lo[c][1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            mma_tf32(o[mt][n0 + c], a_hi[mt], b_hi[c][0], b_hi[c][1]);
      }
    }
  } else {
    using T = typename C::Elem;
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      // Two n8 accumulator tiles are one k16 operand.
      uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        split_pack<T>(p[mt][2 * j][0], p[mt][2 * j][1], a_hi[mt][0], a_lo[mt][0]);
        split_pack<T>(p[mt][2 * j][2], p[mt][2 * j][3], a_hi[mt][1], a_lo[mt][1]);
        split_pack<T>(p[mt][2 * j + 1][0], p[mt][2 * j + 1][1], a_hi[mt][2], a_lo[mt][2]);
        split_pack<T>(p[mt][2 * j + 1][2], p[mt][2 * j + 1][3], a_hi[mt][3], a_lo[mt][3]);
      }
      const int row = 16 * j + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < kDT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, v_t + row * kSV + (lane / 16) * 8 + 16 * np);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_16<T>(o[mt][2 * np], a_lo[mt], bf[0], bf[1]);
          mma_16<T>(o[mt][2 * np + 1], a_lo[mt], bf[2], bf[3]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_16<T>(o[mt][2 * np], a_hi[mt], bf[0], bf[1]);
          mma_16<T>(o[mt][2 * np + 1], a_hi[mt], bf[2], bf[3]);
        }
      }
    }
  }
}

// One key tile of the online softmax for the warp's rows (first row
// row0): S (raw Q·Kᵀ) becomes p in place; the running max, the lane's
// part of the denominator and O are rescaled. kMask: the tile crosses the
// diagonal or the ragged end.
template <class C, bool kMask>
__device__ __forceinline__ void online_softmax(float (&s)[C::kMT][C::kNT][4],
                                               float (&m_run)[C::kMT][2],
                                               float (&l_run)[C::kMT][2],
                                               float (&o)[C::kMT][C::kDT][4], float scale,
                                               int row0, int k0, int s_len, bool causal) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * mt + g + 8 * h;
      float row_max = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = s[mt][nt][2 * h + i] * scale;
          if constexpr (kMask) {
            const int key = k0 + 8 * nt + 2 * t + i;
            if (key >= s_len) {
              x = -INFINITY;  // no such key: p = 0
            } else if (causal && key > row) {
              x = kMaskValue;
            }
          }
          s[mt][nt][2 * h + i] = x;
          row_max = fmaxf(row_max, x);
        }
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_new = fmaxf(m_run[mt][h], row_max);
      const float alpha = exp_approx(m_run[mt][h] - m_new);
      m_run[mt][h] = m_new;
      float row_sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p = exp_approx(s[mt][nt][2 * h + i] - m_new);
          s[mt][nt][2 * h + i] = p;
          row_sum += p;
        }
      l_run[mt][h] = l_run[mt][h] * alpha + row_sum;
      // alpha is 1 where a row's max did not move, as it mostly does not
      // after the first tiles; O is rescaled only if some row of the warp
      // moved (x · 1 = x, so the result is the same).
      if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
        for (int dt = 0; dt < C::kDT; ++dt) {
          o[mt][dt][2 * h] *= alpha;
          o[mt][dt][2 * h + 1] *= alpha;
        }
      }
    }
}

// Two f32 values as one packed pair of T (x0 in the low half), or as
// themselves for f32, for the staged O.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float x0, float x1) {
  if constexpr (is_f32<T>()) {
    *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  } else {
    *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(x0, x1);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
flash_fwd_kernel(const typename C::Elem* __restrict__ q, const typename C::Elem* __restrict__ k,
                 const typename C::Elem* __restrict__ v, typename C::Elem* __restrict__ o,
                 float* __restrict__ lse, int hq, int group, int s_len, int d, float scale,
                 int causal) {
  using T = typename C::Elem;
  constexpr int kSK = C::kSK, kSV = C::kSV, kBM = C::kBM, kN = C::kN, kMT = C::kMT;
  constexpr int kVOff = kN * kSK;  // V within a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const q_s = reinterpret_cast<T*>(smem_raw);  // then O
  T* const ring = q_s + C::kQ;                     // two stages

  const int n_q_tiles = (s_len + kBM - 1) / kBM;
  // Causal: the last query tiles read the most key tiles; launch them first.
  const int q_tile = causal ? n_q_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = q_tile * kBM;
  const int bh = blockIdx.x;
  const int hkv = hq / group;
  const int kv_row = (bh / hq) * hkv + (bh % hq) / group;
  const size_t plane = (size_t)s_len * d;
  const T* k_bh = k + (size_t)kv_row * plane;
  const T* v_bh = v + (size_t)kv_row * plane;
  const int n_tiles_all = (s_len + kN - 1) / kN;
  const int n_tiles = causal ? min(n_tiles_all, (q0 + kBM - 1) / kN + 1) : n_tiles_all;

  auto issue = [&](int tile, int stage) {
    T* st = ring + stage * C::kStage;
    load_rows_async<T, kN, kSK>(st, k_bh, tile * kN, s_len, d);
    load_rows_async<T, kN, kSV>(st + kVOff, v_bh, tile * kN, s_len, d);
  };

  zero_tail_columns<T, C::kD, kSK>(q_s, C::kQ / kSK, d);
#pragma unroll
  for (int stage = 0; stage < 2; ++stage) {
    zero_tail_columns<T, C::kD, kSK>(ring + stage * C::kStage, kN, d);
    zero_tail_columns<T, C::kD, kSV>(ring + stage * C::kStage + kVOff, kN, d);
  }
  load_rows_async<T, kBM, kSK>(q_s, q + (size_t)bh * plane, q0, s_len, d);
  issue(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int w_row0 = 16 * kMT * warp;  // the warp's first row in the block
  const T* q_w = q_s + w_row0 * kSK;
  uint32_t qf[C::kQFrags][4];
  float o_acc[kMT][C::kDT][4];
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[mt][h] = kMaskValue;
      l_run[mt][h] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < C::kDT; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[mt][dt][i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    T* const st = ring + stage * C::kStage;
    cp_async_wait<0>();  // this thread's copies of tile it (and Q) landed
    if constexpr (C::kF32) {
      if (it == 0) split_rows<kBM, kSK>(q_s, q_s + kBM * kSK, d);
    }
    // Tile it (and Q) is visible to every thread, and every warp is done
    // with tile it - 1, whose stage the next copies overwrite.
    __syncthreads();
    if constexpr (!C::kF32) {
      if (it == 0) load_q_frags<C>(qf, q_w);
    }
    if (it + 1 < n_tiles) issue(it + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps one group per tile

    const int k0 = it * kN;
    const int row0 = q0 + w_row0;
    if (causal && k0 > row0 + 16 * kMT - 1) continue;  // every key past the warp's rows
    float s[kMT][C::kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
    qk_product<C>(s, qf, q_w, st);
    if ((causal && k0 + kN - 1 > row0) || k0 + kN > s_len) {
      online_softmax<C, true>(s, m_run, l_run, o_acc, scale, row0, k0, s_len, causal);
    } else {
      online_softmax<C, false>(s, m_run, l_run, o_acc, scale, row0, k0, s_len, causal);
    }
    pv_product<C>(o_acc, s, st + kVOff);
  }

  // O through shared memory where Q was (every warp is done with it), then
  // 16-byte stores of whole rows.
  __syncthreads();
  T* const o_s = q_s;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float denom = l == 0.f ? 1.f : l;
      const int r = w_row0 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int dt = 0; dt < C::kDT; ++dt)
        store_pair<T>(o_s + r * kSV + 8 * dt + 2 * t, o_acc[mt][dt][2 * h] / denom,
                      o_acc[mt][dt][2 * h + 1] / denom);
      if (t == 0 && q0 + r < s_len) lse[(size_t)bh * s_len + q0 + r] = m_run[mt][h] + logf(denom);
    }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = d / kVec;
  T* o_bh = o + (size_t)bh * plane;
  for (int idx = threadIdx.x; idx < kBM * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * kVec;
    if (q0 + r < s_len)
      *reinterpret_cast<uint4*>(o_bh + (size_t)(q0 + r) * d + c) =
          *reinterpret_cast<const uint4*>(o_s + r * kSV + c);
  }
}

template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                   int hq, int hkv, int s_len, int d, float scale, int causal,
                   cudaStream_t stream) {
  using T = typename C::Elem;
  if (d > C::kD || (d * sizeof(T)) % 16 != 0 || (s_len + C::kBM - 1) / C::kBM > 65535)
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s_len + C::kBM - 1) / C::kBM);
  kernel<<<grid, kThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), hq, hq / hkv, s_len, d, scale, causal);
  return cudaGetLastError();
}

// The configuration each input type and head_dim runs, the fastest that
// tools/flash_fwd_variants.py found on the card (PERF.md): f32 at head_dim
// 64 with 32 rows a warp, so each split K or V fragment feeds two m-tiles,
// and 32-key tiles; 16 rows a warp otherwise, with 64-key tiles for f32 at
// 128 and 16 bits at 64, 32-key tiles for 16 bits at 128.
template <typename T, int kD>
constexpr int chosen_mt() { return is_f32<T>() && kD <= 64 ? 2 : 1; }
template <typename T, int kD>
constexpr int chosen_n() {
  return is_f32<T>() ? (kD <= 64 ? 32 : 64) : (kD <= 64 ? 64 : 32);
}
template <typename T, int kD>
using Chosen = Cfg<T, kD, chosen_mt<T, kD>(), chosen_n<T, kD>()>;

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o, void* lse,
                         int b, int hq, int hkv, int s_len, int d, float scale, int causal,
                         cudaStream_t stream) {
  if (d <= 64)
    return launch<Chosen<T, 64>>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, stream);
  return launch<Chosen<T, 128>>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, stream);
}

template <typename T>
size_t smem_bytes(int d) {
  return d <= 64 ? Chosen<T, 64>::kBytes : Chosen<T, 128>::kBytes;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Tensors are contiguous
// and 16-byte aligned, with d·itemsize a multiple of 16 (the wrapper
// pads): q, o [b, hq, s_len, d]; k, v [b, hkv, s_len, d]; lse [b, hq,
// s_len] f32. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int b, int hq, int hkv, int s_len, int d, int dtype, int causal,
                         float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 || d <= 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  const uintptr_t pointers = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  if (pointers % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_dim<float>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, st);
    case 1:
      return (int)dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale,
                                              causal, st);
    case 2:
      return (int)dispatch_dim<__half>(q, k, v, o, lse, b, hq, hkv, s_len, d, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory in bytes of the launch that flash_fwd makes for
// this dtype and head_dim (-1 for an unknown dtype).
extern "C" long long flash_fwd_smem_bytes(int dtype, int d) {
  switch (dtype) {
    case 0:
      return (long long)smem_bytes<float>(d);
    case 1:
      return (long long)smem_bytes<__nv_bfloat16>(d);
    case 2:
      return (long long)smem_bytes<__half>(d);
    default:
      return -1;
  }
}
