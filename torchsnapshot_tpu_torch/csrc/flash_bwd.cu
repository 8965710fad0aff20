// Flash attention backward for Hopper (sm_90a): dq, dk and dv of
// O = softmax(Q·Kᵀ·D^-½)·V, from the forward's per-row log-sum-exp,
// without materialising the S×S scores.
//
// Replaces two Pallas kernels of torchsnapshot_tpu/ops/attention.py, both
// launched by _flash_backward around their shared core _bwd_pieces:
//
//   flash_bwd_dq   <- _flash_bwd_dq_kernel:  per query tile, over key tiles,
//                     dq += scale · ds·K
//   flash_bwd_dkv  <- _flash_bwd_dkv_kernel: per key tile of a kv-head, over
//                     the query tiles of every q-head that reads it,
//                     dv += pᵀ·dO and dk += scale · dsᵀ·Q
//
// The arithmetic is the Pallas kernels': s = (Q·Kᵀ)·scale, p = exp(s − lse)
// where lse > -5e29 and 0 where the forward wrote the -1e30 sentinel (the
// exp is never taken of s + 1e30), causally masked pairs get p = 0,
// dP = dO·Vᵀ, ds = p·(dP − delta) with delta = rowsum(dO·O) − dlse given by
// the wrapper, every product of f32 accuracy and every sum in f32. dO comes
// in q's dtype. GQA maps q-head h to kv-head h / group, as _kv_index_map
// does; flash_bwd_dkv sums the group's q-heads itself and writes dk and dv
// per kv-head. The two-kernel split is deterministic: no atomics, each
// output element is summed by one thread in one fixed order.
//
// What bounds it. The backward does 3 (dq) and 4 (dk, dv) products of 2·D
// flops per kept (query, key) pair against O(S·D) bytes: ~S/2 flop per
// byte, far above the H100's ridge, so the bound is the tensor cores. Every
// product runs there as warp-level mma.sync with f32 accumulators in
// registers:
//
//   f32 inputs: 3xTF32. Each f32 operand is split in registers as it leaves
//     shared memory, hi = tf32(x), lo = tf32(x − hi), and A·B is taken as
//     Ahi·Bhi + Ahi·Blo + Alo·Bhi with m16n8k8 tf32 mma: f32 accuracy at a
//     third of the 495 TFLOP/s TF32 rate (what PyTorch's memory-efficient
//     SDPA backward does for float).
//   bf16/f16 inputs: m16n8k16 mma in the input type. Q·Kᵀ and dO·Vᵀ are
//     exact products; p and ds (f32) are split into hi + lo terms of the
//     input type, two mma per product, so they are not rounded to 16 bits.
//
// The f32 kernels spend an issue slot on every integer op of the operand
// splits, and with 8 warps an SM little of the load → split → mma latency
// is hidden.
//
// Structure. Four warps own one 64-row tile of one head, 16 rows each; the
// other axis is a loop in the block, its tiles streamed through a
// two-stage cp.async ring in shared memory (tile t+1 lands while tile t is
// computed). S and dP of a 16-row strip stay in registers, and p/ds feed
// the next product straight from the accumulator layout: for 16 bits two
// n8 accumulator tiles are one k16 operand; for tf32 the k order inside an
// 8-wide step is permuted (operand column t is key 2t, column t+4 is key
// 2t+1) and the B rows are loaded in the same order. Shared strides are
// padded so that every fragment load is free of bank conflicts (f32:
// stride ≡ 4 words mod 32; 16 bits: ldmatrix rows 16 bytes apart mod 128).
// Causal: flash_bwd_dq stops at the diagonal key tile, flash_bwd_dkv starts
// at the diagonal query tile, and blockIdx.y is mapped so that the blocks
// with the most tiles launch first. Rows past a ragged end load as zeros
// and are masked per element; columns past d are zero in shared memory.

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int kBlockM = 64;  // rows of a tile (queries or keys)
constexpr int kWarps = 4;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;   // cp.async ring depth of the streamed tiles
constexpr float kMaskValue = -1e30f;
constexpr float kLseFloor = -5e29f;  // lse at or below this: all-masked row

// 64 f32 values [row0, row0+64) of a length-s_len vector; zero past s_len.
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src,
                                               int row0, int s_len) {
  for (int r = threadIdx.x; r < kBlockM; r += kThreads) {
    const bool valid = row0 + r < s_len;
    cp_async4(dst + r, valid ? src + row0 + r : src, valid);
  }
}

// p of one (query, key) pair from its raw score Q·Kᵀ.
__device__ __forceinline__ float recompute_p(float raw, float scale, float lse,
                                             bool keep) {
  if (!keep || !(lse > kLseFloor)) return 0.f;
  return expf(raw * scale - lse);
}

// f32: kChunk n-tiles of B are loaded and split together, then each
// 3xTF32 term is issued across the chunk and across the kP products, so
// no mma waits on the one before it.
constexpr int kChunk = 4;

// acc[i][n] += A_i·B_iᵀ over k in [0, kD) for kP products at once, for
// one warp: a[i] is the warp's 16 rows of a [row][k] tile, b[i] the first
// of 8·kNT rows of a [n][k] tile (both stride kSD). Serves Q·Kᵀ with
// dO·Vᵀ, and K·Qᵀ with V·dOᵀ.
template <typename T, int kP, int kNT, int kSD, int kD>
__device__ __forceinline__ void warp_mma_nk(float (&acc)[kP][kNT][4], const T* const (&a)[kP],
                                            const T* const (&b)[kP]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (is_f32<T>()) {
    constexpr int kC = kChunk;
    static_assert(kNT % kC == 0, "n-tiles come in whole chunks");
#pragma unroll
    for (int k0 = 0; k0 < kD; k0 += 8) {
      uint32_t a_hi[kP][4], a_lo[kP][4];
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const float* arow = a[i] + g * kSD + k0 + t;
        split_tf32(arow[0], a_hi[i][0], a_lo[i][0]);
        split_tf32(arow[8 * kSD], a_hi[i][1], a_lo[i][1]);
        split_tf32(arow[4], a_hi[i][2], a_lo[i][2]);
        split_tf32(arow[8 * kSD + 4], a_hi[i][3], a_lo[i][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kC) {
        uint32_t b_hi[kP][kC][2], b_lo[kP][kC][2];
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float* brow = b[i] + (8 * (n0 + c) + g) * kSD + k0 + t;
            split_tf32(brow[0], b_hi[i][c][0], b_lo[i][c][0]);
            split_tf32(brow[4], b_hi[i][c][1], b_lo[i][c][1]);
          }
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c)
            mma_tf32(acc[i][n0 + c], a_lo[i], b_hi[i][c][0], b_hi[i][c][1]);
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c)
            mma_tf32(acc[i][n0 + c], a_hi[i], b_lo[i][c][0], b_lo[i][c][1]);
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c)
            mma_tf32(acc[i][n0 + c], a_hi[i], b_hi[i][c][0], b_hi[i][c][1]);
      }
    }
  } else {
    static_assert(kNT % 2 == 0, "16-bit B fragments come in n-tile pairs");
#pragma unroll
    for (int k0 = 0; k0 < kD; k0 += 16) {
      uint32_t af[kP][4];
#pragma unroll
      for (int i = 0; i < kP; ++i)
        ldsm_x4(af[i], a[i] + (lane % 16) * kSD + k0 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[kP][4];
#pragma unroll
        for (int i = 0; i < kP; ++i)
          ldsm_x4(bf[i], b[i] + (16 * np + (lane % 8) + (lane / 16) * 8) * kSD + k0 +
                             ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          mma_16<T>(acc[i][2 * np], af[i], bf[i][0], bf[i][1]);
          mma_16<T>(acc[i][2 * np + 1], af[i], bf[i][2], bf[i][3]);
        }
      }
    }
  }
}

// acc[i][n] += P_i·B_i over the 8·kKT columns of P_i for kP products at
// once, for one warp: P_i is f32 in the accumulator layout of a
// 16 × 8·kKT product (p or ds, split hi + lo here), b[i] the first of
// 8·kKT rows of a [k][n] tile (stride kSD); output columns [0, 8·kDT).
// Serves ds·K, and pᵀ·dO with dsᵀ·Q.
template <typename T, int kP, int kKT, int kDT, int kSD>
__device__ __forceinline__ void warp_mma_regs_kn(float (&acc)[kP][kDT][4],
                                                 const float (&p)[kP][kKT][4],
                                                 const T* const (&b)[kP]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (is_f32<T>()) {
    constexpr int kC = kChunk;
    static_assert(kDT % kC == 0, "n-tiles come in whole chunks");
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      // Operand column t is key 2t of the step and column t+4 key 2t+1:
      // the accumulator layout, read with B rows in the same order.
      uint32_t a_hi[kP][4], a_lo[kP][4];
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        split_tf32(p[i][j][0], a_hi[i][0], a_lo[i][0]);
        split_tf32(p[i][j][2], a_hi[i][1], a_lo[i][1]);
        split_tf32(p[i][j][1], a_hi[i][2], a_lo[i][2]);
        split_tf32(p[i][j][3], a_hi[i][3], a_lo[i][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < kDT; n0 += kC) {
        uint32_t b_hi[kP][kC][2], b_lo[kP][kC][2];
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float* brow = b[i] + (8 * j + 2 * t) * kSD + g + 8 * (n0 + c);
            split_tf32(brow[0], b_hi[i][c][0], b_lo[i][c][0]);
            split_tf32(brow[kSD], b_hi[i][c][1], b_lo[i][c][1]);
          }
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c)
            mma_tf32(acc[i][n0 + c], a_lo[i], b_hi[i][c][0], b_hi[i][c][1]);
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c)
            mma_tf32(acc[i][n0 + c], a_hi[i], b_lo[i][c][0], b_lo[i][c][1]);
#pragma unroll
        for (int i = 0; i < kP; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c)
            mma_tf32(acc[i][n0 + c], a_hi[i], b_hi[i][c][0], b_hi[i][c][1]);
      }
    }
  } else {
    static_assert(kKT % 2 == 0 && kDT % 2 == 0, "16-bit fragments come in pairs");
#pragma unroll
    for (int j = 0; j < kKT / 2; ++j) {
      // Two n8 accumulator tiles are one k16 operand.
      uint32_t a_hi[kP][4], a_lo[kP][4];
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        split_pack<T>(p[i][2 * j][0], p[i][2 * j][1], a_hi[i][0], a_lo[i][0]);
        split_pack<T>(p[i][2 * j][2], p[i][2 * j][3], a_hi[i][1], a_lo[i][1]);
        split_pack<T>(p[i][2 * j + 1][0], p[i][2 * j + 1][1], a_hi[i][2], a_lo[i][2]);
        split_pack<T>(p[i][2 * j + 1][2], p[i][2 * j + 1][3], a_hi[i][3], a_lo[i][3]);
      }
      const int row = 16 * j + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < kDT / 2; ++np) {
        uint32_t bf[kP][4];
#pragma unroll
        for (int i = 0; i < kP; ++i)
          ldsm_x4_trans(bf[i], b[i] + row * kSD + (lane / 16) * 8 + 16 * np);
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          mma_16<T>(acc[i][2 * np], a_lo[i], bf[i][0], bf[i][1]);
          mma_16<T>(acc[i][2 * np + 1], a_lo[i], bf[i][2], bf[i][3]);
        }
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          mma_16<T>(acc[i][2 * np], a_hi[i], bf[i][0], bf[i][1]);
          mma_16<T>(acc[i][2 * np + 1], a_hi[i], bf[i][2], bf[i][3]);
        }
      }
    }
  }
}

template <typename T, int kD>
constexpr size_t dq_smem_bytes() {
  // Q and dO resident, K and V in the ring.
  return sizeof(T) * (size_t)(2 + 2 * kStages) * kBlockM * smem_stride<T, kD>();
}

template <typename T, int kD>
constexpr size_t dkv_smem_bytes() {
  // K and V resident; Q, dO, lse and delta in the ring.
  return dq_smem_bytes<T, kD>() + sizeof(float) * 2 * kStages * kBlockM;
}

// Queries per S strip in flash_bwd_dkv: 32 at head_dim 128 keeps Sᵀ and
// dPᵀ (16 registers each) beside the dk and dv accumulators (64 each).
template <int kD>
__host__ __device__ constexpr int dkv_strip() { return kD > 64 ? 32 : 64; }

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ d_out,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int hq, int group, int s_len, int d,
                    float scale, int causal) {
  constexpr int kSD = smem_stride<T, kD>();
  constexpr int kTile = kBlockM * kSD;
  constexpr int kNT = kBlockM / 8;  // key n8 tiles of S
  constexpr int kDT = kD / 8;       // column n8 tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kTile;
  T* k_ring = do_s + kTile;            // kStages tiles
  T* v_ring = k_ring + kStages * kTile;  // kStages tiles

  const int n_tiles_all = (s_len + kBlockM - 1) / kBlockM;
  // Causal: the last query tiles read the most key tiles; launch them first.
  const int q_tile = causal ? n_tiles_all - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = q_tile * kBlockM;
  const int bh = blockIdx.x;
  const int hkv = hq / group;
  const int kv_row = (bh / hq) * hkv + (bh % hq) / group;
  const size_t plane = (size_t)s_len * d;
  const T* k_bh = k + (size_t)kv_row * plane;
  const T* v_bh = v + (size_t)kv_row * plane;
  const int n_tiles = causal ? min(n_tiles_all, q_tile + 1) : n_tiles_all;

  zero_tail_columns<T, kD, kSD>(q_s, (2 + 2 * kStages) * kBlockM, d);
  load_rows_async<T, kBlockM, kSD>(q_s, q + (size_t)bh * plane, q0, s_len, d);
  load_rows_async<T, kBlockM, kSD>(do_s, d_out + (size_t)bh * plane, q0, s_len, d);
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) {
      load_rows_async<T, kBlockM, kSD>(k_ring + st * kTile, k_bh, st * kBlockM, s_len, d);
      load_rows_async<T, kBlockM, kSD>(v_ring + st * kTile, v_bh, st * kBlockM, s_len, d);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int row[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 16 * warp + g + 8 * h;
    row_lse[h] = row[h] < s_len ? lse[(size_t)bh * s_len + row[h]] : kMaskValue;
    row_delta[h] = row[h] < s_len ? delta[(size_t)bh * s_len + row[h]] : 0.f;
  }
  float acc[1][kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][i][j] = 0.f;

  const T* const a_w[2] = {q_s + 16 * warp * kSD, do_s + 16 * warp * kSD};
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // key tile it has landed for every thread
    const int stage = it % kStages;
    const T* k_t = k_ring + stage * kTile;
    const T* v_t = v_ring + stage * kTile;
    const int k0 = it * kBlockM;

    float sd[2][kNT][4];  // S and dP of the warp's 16 rows
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sd[0][i][j] = sd[1][i][j] = 0.f;
    const T* const b_t[2] = {k_t, v_t};
    warp_mma_nk<T, 2, kNT, kSD, kD>(sd, a_w, b_t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int k_pos = k0 + 8 * nt + 2 * t + (i & 1);
        const bool keep = k_pos < s_len && !(causal && k_pos > row[h]);
        const float p = recompute_p(sd[0][nt][i], scale, row_lse[h], keep);
        sd[0][nt][i] = p * (sd[1][nt][i] - row_delta[h]);  // ds
      }
    const T* const k_only[1] = {k_t};
    warp_mma_regs_kn<T, 1, kNT, kDT, kSD>(
        acc, *reinterpret_cast<const float(*)[1][kNT][4]>(&sd[0]), k_only);

    __syncthreads();  // every warp is done with this stage
    const int next = it + kStages;
    if (next < n_tiles) {
      load_rows_async<T, kBlockM, kSD>(k_ring + stage * kTile, k_bh, next * kBlockM, s_len, d);
      load_rows_async<T, kBlockM, kSD>(v_ring + stage * kTile, v_bh, next * kBlockM, s_len, d);
    }
    cp_async_commit();  // possibly empty: keeps one group per tile
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= s_len) continue;
    float* dq_row = dq + (size_t)bh * plane + (size_t)row[h] * d;
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < d) dq_row[col] = scale * acc[0][nt][2 * h];
      if (col + 1 < d) dq_row[col + 1] = scale * acc[0][nt][2 * h + 1];
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ d_out,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int hq,
                     int group, int s_len, int d, float scale, int causal) {
  constexpr int kSD = smem_stride<T, kD>();
  constexpr int kTile = kBlockM * kSD;
  constexpr int kQN = dkv_strip<kD>();  // queries per Sᵀ strip
  constexpr int kNT = kQN / 8;
  constexpr int kDT = kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kTile;
  T* q_ring = v_s + kTile;               // kStages tiles
  T* do_ring = q_ring + kStages * kTile;  // kStages tiles
  float* lse_ring = reinterpret_cast<float*>(do_ring + kStages * kTile);  // [kStages][64]
  float* delta_ring = lse_ring + kStages * kBlockM;

  // One block per (batch, kv-head, key tile); blockIdx.y = 0 is key tile 0,
  // which under causal masking reads the most query tiles and so launches
  // first.
  const int hkv = hq / group;
  const int b = blockIdx.x / hkv;
  const int kv_head = blockIdx.x % hkv;
  const int key_tile = blockIdx.y;
  const int k0 = key_tile * kBlockM;
  const size_t plane = (size_t)s_len * d;
  const int n_q_tiles = (s_len + kBlockM - 1) / kBlockM;
  const int first = causal ? key_tile : 0;
  const int per_head = n_q_tiles - first;
  const int n_iter = group * per_head;  // (q-head of the group, query tile)

  auto load_step = [&](int step, int stage) {
    const int bh = b * hq + kv_head * group + step / per_head;
    const int q0 = (first + step % per_head) * kBlockM;
    load_rows_async<T, kBlockM, kSD>(q_ring + stage * kTile, q + (size_t)bh * plane, q0,
                                     s_len, d);
    load_rows_async<T, kBlockM, kSD>(do_ring + stage * kTile, d_out + (size_t)bh * plane, q0,
                                     s_len, d);
    load_vec_async(lse_ring + stage * kBlockM, lse + (size_t)bh * s_len, q0, s_len);
    load_vec_async(delta_ring + stage * kBlockM, delta + (size_t)bh * s_len, q0, s_len);
  };

  zero_tail_columns<T, kD, kSD>(k_s, (2 + 2 * kStages) * kBlockM, d);
  const size_t kv_off = (size_t)(b * hkv + kv_head) * plane;
  load_rows_async<T, kBlockM, kSD>(k_s, k + kv_off, k0, s_len, d);
  load_rows_async<T, kBlockM, kSD>(v_s, v + kv_off, k0, s_len, d);
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_iter) load_step(st, st);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float acc[2][kDT][4];  // dv and dk of the warp's 16 keys
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][i][j] = acc[1][i][j] = 0.f;

  const T* const a_w[2] = {k_s + 16 * warp * kSD, v_s + 16 * warp * kSD};
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // step it has landed for every thread
    const int stage = it % kStages;
    const int q0 = (first + it % per_head) * kBlockM;
    const float* lse_t = lse_ring + stage * kBlockM;
    const float* delta_t = delta_ring + stage * kBlockM;
#pragma unroll
    for (int strip = 0; strip < kBlockM / kQN; ++strip) {
      const T* q_t = q_ring + stage * kTile + strip * kQN * kSD;
      const T* do_t = do_ring + stage * kTile + strip * kQN * kSD;
      float sd[2][kNT][4];  // Sᵀ and dPᵀ: keys × queries
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sd[0][i][j] = sd[1][i][j] = 0.f;
      const T* const b_t[2] = {q_t, do_t};
      warp_mma_nk<T, 2, kNT, kSD, kD>(sd, a_w, b_t);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = strip * kQN + 8 * nt + 2 * t + (i & 1);
          const int q_pos = q0 + col;
          const int k_pos = key[i >> 1];
          const bool keep =
              q_pos < s_len && k_pos < s_len && !(causal && k_pos > q_pos);
          const float p = recompute_p(sd[0][nt][i], scale, lse_t[col], keep);
          sd[0][nt][i] = p;
          sd[1][nt][i] = p * (sd[1][nt][i] - delta_t[col]);  // dsᵀ
        }
      // dv += pᵀ·dO and dk += dsᵀ·Q.
      const T* const b_kn[2] = {do_t, q_t};
      warp_mma_regs_kn<T, 2, kNT, kDT, kSD>(acc, sd, b_kn);
    }

    __syncthreads();  // every warp is done with this stage
    if (it + kStages < n_iter) load_step(it + kStages, stage);
    cp_async_commit();  // possibly empty: keeps one group per step
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s_len) continue;
    float* dk_row = dk + kv_off + (size_t)key[h] * d;
    float* dv_row = dv + kv_off + (size_t)key[h] * d;
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < d) {
        dk_row[col] = scale * acc[1][nt][2 * h];
        dv_row[col] = acc[0][nt][2 * h];
      }
      if (col + 1 < d) {
        dk_row[col + 1] = scale * acc[1][nt][2 * h + 1];
        dv_row[col + 1] = acc[0][nt][2 * h + 1];
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

template <typename T, int kD>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, kD>;
  constexpr size_t smem = dq_smem_bytes<T, kD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.hq, (a.s_len + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.d_out),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.hq, a.hq / a.hkv, a.s_len, a.d, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, kD>;
  constexpr size_t smem = dkv_smem_bytes<T, kD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.hkv, (a.s_len + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.d_out),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.hq, a.hq / a.hkv,
      a.s_len, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kDkv, typename T>
cudaError_t dispatch_dim(const Args& a) {
  // Rows are copied in 16-byte pieces: d·sizeof(T) must be a multiple of 16.
  if ((a.d * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  if (a.d <= 64) return kDkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  return kDkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
}

template <bool kDkv>
int dispatch(const Args& a, int dtype) {
  if (a.b <= 0 || a.hq <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0 || a.s_len <= 0 ||
      a.d <= 0 || a.d > 128 || (a.s_len + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  const uintptr_t pointers = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                             (uintptr_t)a.d_out | (uintptr_t)a.lse | (uintptr_t)a.delta;
  if (pointers % 16 != 0) return (int)cudaErrorMisalignedAddress;
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

// dtype (of q, k, v and d_out): 0 = float32, 1 = bfloat16, 2 = float16.
// Tensors are contiguous and 16-byte aligned, with d·itemsize a multiple
// of 16: q and d_out [b, hq, s_len, d]; k, v [b, hkv, s_len, d]; lse and
// delta f32 [b, hq, s_len]; dq f32 [b, hq, s_len, d]; dk and dv f32
// [b, hkv, s_len, d]. Each returns the cudaError_t of its launch (0 on
// success).
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
