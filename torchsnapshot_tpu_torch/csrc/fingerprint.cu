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
// the order of the additions: the kernels equal their plain versions
// (ops/fingerprint.py) and fingerprint_host bit for bit.
//
// Bound on this card: every payload byte is read once (3.35 TB/s of
// HBM3), and each word costs about ten integer instructions a lane (the
// index multiply-add, three shift-xor pairs, two multiplies, the
// multiply-add into the sum), about forty for the four lanes, against
// 64 INT32 lanes an SM: the integer work, not the bytes, binds. The
// design reads the bytes once in 16-byte loads, computes the weights in
// registers from the index (never from memory), keeps four accumulators
// a thread, reduces them with warp shuffles and shared memory, and adds
// each block's sums into its output lanes with one u32 atomicAdd each.
//
// Layouts: the payload is a segment list over a byte stream. Byte j of
// the stream lives at base + (j / run) * stride + j % run (one run when
// run >= total), so K4 takes a sub-box of a contiguous tensor split
// along one dimension (prod(sizes[:d]) runs of equal length at a fixed
// stride) without a copy. Three load paths, chosen from the layout:
// 16-byte vectors (contiguous, base and segment 16-byte aligned), 4-byte
// words (base, run and stride 4-byte aligned), and single bytes for the
// rest (a 1- or 2-byte view at an odd offset, runs of odd length).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kWordsPerThread = 32;
constexpr unsigned kGold = 0x9E3779B1u;

enum Mode { kVec16 = 0, kWord = 1, kBytes = 2 };

struct Layout {
  const unsigned char* base;
  long long total;   // payload bytes
  long long seg;     // bytes a segment (a multiple of 4); indices restart at each
  long long run;     // bytes a run; run >= total: one contiguous run
  long long stride;  // bytes between the starts of two runs
};

__device__ __forceinline__ unsigned mix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Lane k's salt is k * 0x85EBCA77 + 1 mod 2^32.
__device__ __forceinline__ void add_word(unsigned (&acc)[4], unsigned w, unsigned i) {
  const unsigned g = i * kGold;
  acc[0] += w * mix32(g + 0x00000001u);
  acc[1] += w * mix32(g + 0x85EBCA78u);
  acc[2] += w * mix32(g + 0x0BD794EFu);
  acc[3] += w * mix32(g + 0x91C35F66u);
}

__device__ __forceinline__ long long byte_offset(const Layout& L, long long j) {
  if (L.run >= L.total) return j;
  const long long r = j / L.run;
  return r * L.stride + (j - r * L.run);
}

// The word that starts at stream byte j0; bytes at or past `end` are zero.
__device__ __forceinline__ unsigned word_of_bytes(const Layout& L, long long j0, long long end) {
  unsigned w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const long long j = j0 + b;
    if (j < end) w |= static_cast<unsigned>(__ldg(L.base + byte_offset(L, j))) << (8 * b);
  }
  return w;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) xs128_kernel(Layout L, int blocks_per_seg, unsigned* out) {
  const long long seg_idx = blockIdx.x / blocks_per_seg;
  const long long sub = blockIdx.x % blocks_per_seg;
  const long long seg_start = seg_idx * L.seg;
  const long long left = L.total - seg_start;
  const long long seg_len = L.seg < left ? L.seg : left;
  const long long seg_end = seg_start + seg_len;
  const long long seg_words = (seg_len + 3) / 4;
  const long long step = static_cast<long long>(blocks_per_seg) * kThreads;
  const long long t0 = sub * kThreads + threadIdx.x;
  unsigned acc[4] = {0u, 0u, 0u, 0u};
  long long fast_words = 0;  // words [0, fast_words) go through the loop below
  if (MODE == kVec16) {
    const long long groups = seg_len / 16;
    const uint4* v = reinterpret_cast<const uint4*>(L.base + seg_start);
    for (long long g = t0; g < groups; g += step) {
      const uint4 q = __ldg(v + g);
      const unsigned i = static_cast<unsigned>(4 * g);
      add_word(acc, q.x, i);
      add_word(acc, q.y, i + 1u);
      add_word(acc, q.z, i + 2u);
      add_word(acc, q.w, i + 3u);
    }
    fast_words = groups * 4;
  } else if (MODE == kWord) {
    const long long full = seg_len / 4;
    for (long long k = t0; k < full; k += step) {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(L.base + byte_offset(L, seg_start + 4 * k)));
      add_word(acc, w, static_cast<unsigned>(k));
    }
    fast_words = full;
  }
  // Every word in kBytes mode; otherwise the segment's last few.
  for (long long k = fast_words + t0; k < seg_words; k += step) {
    add_word(acc, word_of_bytes(L, seg_start + 4 * k, seg_end), static_cast<unsigned>(k));
  }

#pragma unroll
  for (int lane = 0; lane < 4; ++lane) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[lane] += __shfl_down_sync(0xffffffffu, acc[lane], off);
  }
  __shared__ unsigned partial[kThreads / 32][4];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) partial[warp][lane] = acc[lane];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += partial[w][threadIdx.x];
    atomicAdd(out + seg_idx * 4 + threadIdx.x, s);
  }
}

int choose_mode(const Layout& L) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(L.base);
  const bool contiguous = L.run >= L.total;
  if (contiguous && a % 16 == 0 && L.seg % 16 == 0) return kVec16;
  if (a % 4 == 0 && (contiguous || (L.run % 4 == 0 && L.stride % 4 == 0))) return kWord;
  return kBytes;
}

int launch(const Layout& L, long long n_segs, unsigned* out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n_segs) * 4 * sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_segs == 0 || L.total == 0) return 0;
  const long long seg_words = ((L.seg < L.total ? L.seg : L.total) + 3) / 4;
  long long bps = (seg_words + kThreads * kWordsPerThread - 1) / (kThreads * kWordsPerThread);
  if (bps < 1) bps = 1;
  const long long max_grid = 0x7fffffffLL;
  if (bps * n_segs > max_grid) bps = max_grid / n_segs;
  if (bps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(bps * n_segs));
  switch (choose_mode(L)) {
    case kVec16:
      xs128_kernel<kVec16><<<grid, kThreads, 0, stream>>>(L, static_cast<int>(bps), out);
      break;
    case kWord:
      xs128_kernel<kWord><<<grid, kThreads, 0, stream>>>(L, static_cast<int>(bps), out);
      break;
    default:
      xs128_kernel<kBytes><<<grid, kThreads, 0, stream>>>(L, static_cast<int>(bps), out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: out[0..4) = the four lanes of the stream of `total` bytes laid out
// as runs of `run` bytes `stride` apart from `base` (run >= total: one
// contiguous run). Returns a cudaError_t.
int xs128_box(const void* base, long long total, long long run, long long stride, unsigned* out,
              void* stream) {
  Layout L{static_cast<const unsigned char*>(base), total, (total + 15) / 16 * 16 + 16, run, stride};
  return launch(L, 1, out, static_cast<cudaStream_t>(stream));
}

// K5: out[4c..4c+4) = the lanes of bytes [c*chunk, (c+1)*chunk) of the
// contiguous payload, indices restarting at each chunk; chunk_bytes is a
// positive multiple of 4.
int xs128_chunked(const void* base, long long total, long long chunk_bytes, unsigned* out, void* stream) {
  if (chunk_bytes <= 0 || chunk_bytes % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_segs = (total + chunk_bytes - 1) / chunk_bytes;
  Layout L{static_cast<const unsigned char*>(base), total, chunk_bytes, total, total};
  return launch(L, n_segs, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
