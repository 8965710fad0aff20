// xs128 content fingerprints (K4, K5) for Hopper (sm_90a).
//
// Replaces the JAX package's XLA-jitted device computations
// torchsnapshot_tpu/fingerprint.py:_fingerprint_device_jit (:123, one
// array or one sub-box) and _fingerprint_device_chunked_jit (:219, every
// fixed-size chunk of an array). Both compute, over the payload's stored
// bytes read as little-endian u32 words w_i (the tail zero-padded), four
// lanes
//
//     F_k = sum_i w_i * mix(i * GOLD + k * SALT + 1)   (mod 2^32)
//
// with mix the murmur3 finalizer; K5 restarts i at every chunk. Sums mod
// 2^32 are associative and commutative, so the result is exact whatever
// the order of the additions: the kernel equals the plain versions
// (ops/fingerprint.py) and fingerprint_host bit for bit.
//
// One launch fingerprints a whole batch of segments: a segment is one
// tensor or box (K4) or one chunk (K5), with its own output row. The
// table of segments is built on the host (ops/fingerprint.py
// plan_segments) and copied to the card with the batch.
//
// Bound on this card: every payload byte is read once (3.35 TB/s of
// HBM3). The weights mix(i * GOLD + SALT_k) depend on the index alone and
// cost about 37 integer instructions an index for the four lanes; the
// data costs four multiply-adds a word. Computed for every word, as the
// first version did, the weights made a batch integer-bound, and each
// leaf paid a launch of its own. Here one launch takes the whole batch,
// and the fast path sorts the 16-byte-aligned contiguous segments by
// length and cuts them into groups of up to kGroup. A block owns a run of
// tiles of 2,048 word indices of one group; for each tile it computes the
// weights once into registers (8 indices × 4 lanes a thread, kept there
// by an empty asm the compiler cannot recompute) and walks every segment
// of the group that reaches the tile: two 16-byte loads and 32 IMADs a
// thread a segment, the next segment's (or tile's) loads issued before
// the warps' sums of the current one. Weights are then paid once per
// index range, not per word: over the GPT-2-XL-width state (1.557 G
// words) the integer work falls well below the byte bound, which binds.
// A group's tiles that only its first segment reaches form a lone group,
// whose words are summed as their weights are computed, without holding
// them: a lone leaf (one large tensor) stays integer-bound, as before.
// At 62 registers four blocks run on an SM. Blocks map to their group
// through a prefix array with one entry a group (a binary search), so no
// block is empty. A segment's warp sums (a transposing shuffle) add up
// in shared memory over the block's run, and one u32 atomicAdd a lane
// adds them into the segment's row; the output is zero-filled first, in
// the same stream.
//
// The general path takes what the fast path cannot: segments that are
// not 16-byte aligned or not contiguous, and the sub-16-byte tail of
// every segment. Its layout is a byte stream of runs: byte j lives at
// base + (j / run) * stride + j % run (one run when run >= total), so a
// sub-box of a contiguous tensor cut along one dimension is read in
// place. It loads 4-byte words where base, run and stride allow, single
// bytes otherwise (a 1- or 2-byte view at an odd offset), and computes
// each word's weights itself. Its blocks follow the fast path's in the
// same grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: the registers a thread may take
constexpr int kWarps = kThreads / 32;
constexpr int kVecsPerThread = 2;                          // 16-byte vectors a thread a segment
constexpr long long kTileVecs = kThreads * kVecsPerThread;  // 512 vectors: 2048 word indices (TILE_WORDS)
constexpr int kGroup = 32;                               // fast segments sharing a tile's weights
constexpr unsigned kGold = 0x9E3779B1u;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kWord = 0, kBytes = 1 };

// The batch's table, in device memory: int64 arrays, one entry a segment.
struct Batch {
  // Fast path, sorted by length (descending). Group g is segments
  // [group_first[g], group_last[g]) over tiles [group_tile0[g],
  // group_tile0[g] + group_tiles[g]) of its first segment, which reaches
  // them all; it owns blocks [group_block[g], group_block[g + 1]), each a
  // run of group_per[g] consecutive tiles.
  const long long* fast_addr;   // 16-byte aligned start
  const long long* fast_vecs;   // 16-byte vectors
  const long long* fast_row;    // output row
  const long long* group_first;
  const long long* group_last;
  const long long* group_tile0;
  const long long* group_tiles;
  const long long* group_per;
  const long long* group_block;
  // General path: words [w0, w1) of a stream of `total` bytes in runs.
  const long long* gen_addr;
  const long long* gen_total;
  const long long* gen_run;
  const long long* gen_stride;
  const long long* gen_w0;
  const long long* gen_w1;
  const long long* gen_row;
  const long long* gen_mode;
  const long long* gen_block;   // first block of each (n_general + 1), after the fast blocks
  int n_groups;
  int n_general;
  long long fast_blocks;
};

struct Layout {
  const unsigned char* base;
  long long total;   // stream bytes
  long long run;     // bytes a run; run >= total: one contiguous run
  long long stride;  // bytes between the starts of two runs
};

// The murmur3 finalizer: a weight costs about 6 ALU instructions (the
// shifts and XORs) and 3 FMA-pipe ones (the multiplies and the salt).
__device__ __forceinline__ unsigned mix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Lane k's salt is k * 0x85EBCA77 + 1 mod 2^32.
__device__ __forceinline__ void lane_weights(unsigned (&m)[4], unsigned i) {
  const unsigned g = i * kGold;
  m[0] = mix32(g + 0x00000001u);
  m[1] = mix32(g + 0x85EBCA78u);
  m[2] = mix32(g + 0x0BD794EFu);
  m[3] = mix32(g + 0x91C35F66u);
}

__device__ __forceinline__ void add_word(unsigned (&acc)[4], unsigned w, unsigned i) {
  unsigned m[4];
  lane_weights(m, i);
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] += w * m[k];
}

__device__ __forceinline__ long long byte_offset(const Layout& L, long long j) {
  if (L.run >= L.total) return j;
  const long long r = j / L.run;
  return r * L.stride + (j - r * L.run);
}

// The word that starts at stream byte j0; bytes at or past the end are zero.
__device__ __forceinline__ unsigned word_of_bytes(const Layout& L, long long j0) {
  unsigned w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const long long j = j0 + b;
    if (j < L.total) w |= static_cast<unsigned>(__ldg(L.base + byte_offset(L, j))) << (8 * b);
  }
  return w;
}

// The last slot s of a strictly increasing prefix array with start[s] <= b.
__device__ __forceinline__ int find_slot(const long long* start, int n, long long b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The warp's sum of each of four lanes: a transposing butterfly, six
// shuffles. Returns lane (laneid >> 3) & 3 of the sum.
__device__ __forceinline__ unsigned warp_sum4(const unsigned (&a)[4], unsigned laneid) {
  const bool hi16 = laneid & 16;
  unsigned k0 = hi16 ? a[2] : a[0];
  unsigned k1 = hi16 ? a[3] : a[1];
  k0 += __shfl_xor_sync(kFull, hi16 ? a[0] : a[2], 16);
  k1 += __shfl_xor_sync(kFull, hi16 ? a[1] : a[3], 16);
  const bool hi8 = laneid & 8;
  unsigned c = (hi8 ? k1 : k0) + __shfl_xor_sync(kFull, hi8 ? k0 : k1, 8);
  c += __shfl_xor_sync(kFull, c, 4);
  c += __shfl_xor_sync(kFull, c, 2);
  c += __shfl_xor_sync(kFull, c, 1);
  return c;
}

// This thread's vectors of one segment in the tile that starts at vector
// tile_lo: p[j * kThreads] from p = segment + tile_lo + threadIdx.x, the
// offsets folded into the loads; masked only in a segment's last tile.
__device__ __forceinline__ void load_tile(uint4 (&q)[kVecsPerThread], long long addr, long long tile_lo,
                                          long long n_vecs) {
  const uint4* p = reinterpret_cast<const uint4*>(addr) + tile_lo + threadIdx.x;
  if (n_vecs - tile_lo >= kTileVecs) {
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) q[j] = __ldg(p + j * kThreads);
  } else {
    const int left = static_cast<int>(n_vecs - tile_lo) - static_cast<int>(threadIdx.x);
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      q[j] = j * kThreads < left ? __ldg(p + j * kThreads) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One run of tiles of one group. For each tile: the first segment's
// loads, the tile's weights once, then every segment of the group that
// reaches the tile, the next segment's (or the next tile's) loads issued
// before the warps' sums of the current one. A segment's warp sums add up
// in shared memory over the run, and one atomicAdd a lane adds the block's
// sum into the segment's row at the end.
__device__ __forceinline__ void fast_run(const Batch& B, long long block, unsigned* out,
                                         unsigned (*part)[kWarps][4]) {
  const int g = find_slot(B.group_block, B.n_groups, block);
  const long long first = B.group_first[g], last = B.group_last[g];
  const long long first_addr = B.fast_addr[first], first_vecs = B.fast_vecs[first];
  const long long t_begin = B.group_tile0[g] + (block - B.group_block[g]) * B.group_per[g];
  const long long t_end = min(t_begin + B.group_per[g], B.group_tile0[g] + B.group_tiles[g]);
  const unsigned laneid = threadIdx.x & 31, warp = threadIdx.x >> 5;

  uint4 q[kVecsPerThread];
  load_tile(q, first_addr, t_begin * kTileVecs, first_vecs);
  if (last - first == 1) {
    // A lone segment shares no weights: each word's are computed where it
    // is summed, which keeps them out of registers.
    unsigned acc[4] = {0u, 0u, 0u, 0u};
    for (long long t = t_begin;;) {
      const unsigned i0 = static_cast<unsigned>(4 * (t * kTileVecs + threadIdx.x));
#pragma unroll
      for (int j = 0; j < kVecsPerThread; ++j) {
        const unsigned i = i0 + 4u * j * kThreads;
        add_word(acc, q[j].x, i);
        add_word(acc, q[j].y, i + 1u);
        add_word(acc, q[j].z, i + 2u);
        add_word(acc, q[j].w, i + 3u);
      }
      if (++t >= t_end) break;
      load_tile(q, first_addr, t * kTileVecs, first_vecs);
    }
    const unsigned c = warp_sum4(acc, laneid);
    if ((laneid & 7) == 0) part[0][warp][laneid >> 3] = c;
    __syncthreads();
    if (threadIdx.x < 4) {
      unsigned sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += part[0][w][threadIdx.x];
      atomicAdd(out + 4 * B.fast_row[first] + threadIdx.x, sum);
    }
    return;
  }
  int rows = 0;  // segments of the first (widest) tile of the run
  for (long long t = t_begin; t < t_end; ++t) {
    const long long tile_lo = t * kTileVecs;
    const long long v0 = tile_lo + threadIdx.x;  // this thread's vectors: v0 + j * kThreads
    unsigned wt[kVecsPerThread][4][4];  // [vector][word][lane]
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lane_weights(wt[j][e], static_cast<unsigned>(4 * (v0 + static_cast<long long>(j) * kThreads) + e));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // Opaque to the compiler: the weights stay in registers for the
          // whole walk instead of being recomputed for every segment.
          asm volatile("" : "+r"(wt[j][e][k]));
        }
      }
    }
    int reached = 0;
    for (long long s = first;;) {
      unsigned acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < kVecsPerThread; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k] += q[j].x * wt[j][0][k] + q[j].y * wt[j][1][k] + q[j].z * wt[j][2][k] + q[j].w * wt[j][3][k];
        }
      }
      // Sorted by length: the first segment that ends before the tile
      // ends the walk, and the next tile starts again at the first.
      ++s;
      const long long next_vecs = s < last ? B.fast_vecs[s] : 0;
      const bool more = next_vecs > tile_lo;
      if (more) {
        load_tile(q, B.fast_addr[s], tile_lo, next_vecs);
      } else if (t + 1 < t_end) {
        load_tile(q, first_addr, tile_lo + kTileVecs, first_vecs);
      }
      const unsigned c = warp_sum4(acc, laneid);
      if ((laneid & 7) == 0) {
        // Later tiles reach no more segments than the first.
        unsigned& slot = part[reached][warp][laneid >> 3];
        slot = t == t_begin ? c : slot + c;
      }
      ++reached;
      if (!more) break;
    }
    if (t == t_begin) rows = reached;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < 4 * rows) {
    const int seg = threadIdx.x >> 2, k = threadIdx.x & 3;
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[seg][w][k];
    atomicAdd(out + 4 * B.fast_row[first + seg] + k, sum);
  }
}

// One block of one general segment: its words in a grid stride over the
// segment's blocks, each word's weights computed for it.
__device__ __forceinline__ void general_block(const Batch& B, long long block, unsigned* out,
                                              unsigned (*part)[kWarps][4]) {
  const int x = find_slot(B.gen_block, B.n_general, block);
  const long long sub = block - B.gen_block[x];
  const long long step = (B.gen_block[x + 1] - B.gen_block[x]) * kThreads;
  const Layout L{reinterpret_cast<const unsigned char*>(B.gen_addr[x]), B.gen_total[x], B.gen_run[x],
                 B.gen_stride[x]};
  const long long w1 = B.gen_w1[x];
  long long k = B.gen_w0[x] + sub * kThreads + threadIdx.x;
  unsigned acc[4] = {0u, 0u, 0u, 0u};
  if (B.gen_mode[x] == kWord) {
    // Whole words; a word never straddles two runs (run % 4 == 0).
    const long long whole = L.total / 4 < w1 ? L.total / 4 : w1;
    for (; k < whole; k += step) {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(L.base + byte_offset(L, 4 * k)));
      add_word(acc, w, static_cast<unsigned>(k));
    }
  }
  for (; k < w1; k += step) add_word(acc, word_of_bytes(L, 4 * k), static_cast<unsigned>(k));

  const unsigned laneid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned c = warp_sum4(acc, laneid);
  if ((laneid & 7) == 0) part[0][warp][laneid >> 3] = c;
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[0][w][threadIdx.x];
    atomicAdd(out + 4 * B.gen_row[x] + threadIdx.x, sum);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) xs128_batch_kernel(Batch B, unsigned* out) {
  __shared__ unsigned part[kGroup][kWarps][4];
  const long long block = blockIdx.x;
  if (block < B.fast_blocks) {
    fast_run(B, block, out, part);
  } else {
    general_block(B, block - B.fast_blocks, out, part);
  }
}

}  // namespace

extern "C" {

// K4 and K5: zero-fill out[0 .. 4 * n_rows) and fingerprint every
// segment of the batch whose table (int64, in device memory) is laid
// out as ops/fingerprint.py plan_segments writes it:
//   fast_addr, fast_vecs, fast_row        n_fast each
//   group_first, group_last, group_tile0, group_tiles, group_per
//                                         n_groups each
//   group_block                           n_groups + 1
//   gen_addr, gen_total, gen_run, gen_stride, gen_w0, gen_w1, gen_row,
//   gen_mode                              n_general each
//   gen_block                             n_general + 1
// fast_blocks = group_block[n_groups]; general_blocks = gen_block[n_general].
// Returns a cudaError_t.
int xs128_batch(const long long* table, long long n_fast, int n_groups, int n_general,
                long long fast_blocks, long long general_blocks, unsigned* out, long long n_rows,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n_rows) * 4 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = fast_blocks + general_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  Batch B;
  B.fast_addr = table;
  B.fast_vecs = B.fast_addr + n_fast;
  B.fast_row = B.fast_vecs + n_fast;
  B.group_first = B.fast_row + n_fast;
  B.group_last = B.group_first + n_groups;
  B.group_tile0 = B.group_last + n_groups;
  B.group_tiles = B.group_tile0 + n_groups;
  B.group_per = B.group_tiles + n_groups;
  B.group_block = B.group_per + n_groups;
  B.gen_addr = B.group_block + n_groups + 1;
  B.gen_total = B.gen_addr + n_general;
  B.gen_run = B.gen_total + n_general;
  B.gen_stride = B.gen_run + n_general;
  B.gen_w0 = B.gen_stride + n_general;
  B.gen_w1 = B.gen_w0 + n_general;
  B.gen_row = B.gen_w1 + n_general;
  B.gen_mode = B.gen_row + n_general;
  B.gen_block = B.gen_mode + n_general;
  B.n_groups = n_groups;
  B.n_general = n_general;
  B.fast_blocks = fast_blocks;
  xs128_batch_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(B, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
