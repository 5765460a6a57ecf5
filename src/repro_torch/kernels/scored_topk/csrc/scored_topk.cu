// Fused candidate scoring + per-block top-c (K7).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scored_topk/
// scored_topk.py::_kernel, launched by scored_topk_kernel: per block of
// bm candidate rows of emb (M, D), the scores s = E_blk . q in f32, rows
// at global index >= M scored -inf, then the block's top-c values and
// global ids, in (value descending, lowest index first) order, the order
// of jax.lax.top_k.  The top-c over the nb * c survivors runs outside the
// kernel (ops.py), as it does in repro.
//
// What bounds it on an H100: emb is read once and each value feeds one
// FMA, so device memory bounds it: M * D * sizeof(T) bytes over
// 3.35 TB/s (0.119 ms at M = 10^6, D = 100, f32).  Only nb * c survivors
// are written, never the (M,) score vector.
//
// Design, in three steps per block:
// 1. Score.  q is staged in shared memory.  Each warp scores eight rows at
//    a time, its lanes striding over D; for D <= 128 all of a lane's loads
//    for the eight rows (up to 32) are issued before the first FMA, so
//    enough bytes are in flight to stream at device-memory rate with one
//    block per SM.  A butterfly of shuffles sums each row.  A row's score
//    becomes the 64-bit key
//        ordered(value) << 32 | (2^32 - 1 - global index)
//    (the encoding of kernels/dpp_greedy/tiled.py::pack_key), whose
//    unsigned order is (value, then lowest index).  Keys are unique, so
//    the selection below is exact and needs no pass for ties.  Rows at
//    index >= M are never read: they get the key of -inf at their own
//    index, as the Pallas kernel scores its zero padding.
// 2. Select.  A radix select, 8 bits a pass from the top, finds the
//    prefix that exactly c of the bm keys reach (warp-aggregated
//    shared-memory histograms; it stops as soon as the chosen bin holds
//    exactly the keys still needed), and those c keys are compacted.
// 3. Sort.  Only the c survivors are sorted, descending, by a bitonic
//    network over Q = next power of two >= c keys, and decoded.
// Shared memory: (bm + Q) * 8 + D * 4 bytes (72 KB at bm = 8192,
// c = 1000, hence the MaxDynamicSharedMemorySize attribute).
// Later work: 16-byte loads; a warp per row wastes lanes when D < 32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#define TK_THREADS 1024
#define TK_WARPS (TK_THREADS / 32)
#define TK_ROWS 8    // rows a warp scores at once
#define TK_DCHUNK 4  // D <= 32 * TK_DCHUNK takes the unrolled path

typedef unsigned long long u64;

__device__ __forceinline__ float tk_load(const float* p) { return *p; }
__device__ __forceinline__ float tk_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ u64 make_key(float v, long long g) {
  const unsigned bits = __float_as_uint(v);
  const unsigned ordered = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((u64)ordered << 32) | (u64)(0xFFFFFFFFu - (unsigned)g);
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned ordered = (unsigned)(key >> 32);
  const unsigned bits =
      (ordered & 0x80000000u) ? (ordered & 0x7FFFFFFFu) : ~ordered;
  return __uint_as_float(bits);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// Step 1: the block's bm keys into keys[].
template <typename T>
__device__ __forceinline__ void score_rows(const T* __restrict__ emb,
                                           const float* qs, u64* keys,
                                           long long base, int M, int D,
                                           int bm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // bm is a multiple of 128, so a group of TK_ROWS rows never crosses it
  for (int r0 = warp * TK_ROWS; r0 < bm; r0 += TK_WARPS * TK_ROWS) {
    float acc[TK_ROWS];
#pragma unroll
    for (int u = 0; u < TK_ROWS; ++u) acc[u] = 0.f;
    if (D <= 32 * TK_DCHUNK) {
      float x[TK_ROWS][TK_DCHUNK], qd[TK_DCHUNK];
#pragma unroll
      for (int j = 0; j < TK_DCHUNK; ++j) {
        const int d = lane + 32 * j;
        qd[j] = d < D ? qs[d] : 0.f;
#pragma unroll
        for (int u = 0; u < TK_ROWS; ++u) {
          const long long g = base + r0 + u;
          x[u][j] = (d < D && g < M) ? tk_load(emb + g * D + d) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < TK_ROWS; ++u)
#pragma unroll
        for (int j = 0; j < TK_DCHUNK; ++j)
          acc[u] = fmaf(x[u][j], qd[j], acc[u]);
    } else {
      for (int d = lane; d < D; d += 32) {
        const float q1 = qs[d];
#pragma unroll
        for (int u = 0; u < TK_ROWS; ++u) {
          const long long g = base + r0 + u;
          if (g < M) acc[u] = fmaf(tk_load(emb + g * D + d), q1, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TK_ROWS; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      const long long g = base + r0 + u;
      // + 0.f turns a -0 sum into +0, so equal scores get equal keys
      const float s = g < M ? acc[u] + 0.f : -INFINITY;
      if (lane == u) keys[r0 + u] = make_key(s, g);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TK_THREADS)
scored_topk_kernel(const T* __restrict__ emb, const T* __restrict__ q,
                   float* __restrict__ vals, int* __restrict__ idx, int M,
                   int D, int c, int bm, int Q) {
  extern __shared__ u64 keys[];     // bm keys, then Q survivors
  u64* top = keys + bm;
  float* qs = (float*)(top + Q);    // D
  __shared__ unsigned hist[256];
  __shared__ u64 s_prefix;
  __shared__ int s_need, s_done, s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < D; d += TK_THREADS) qs[d] = tk_load(q + d);
  if (tid == 0) {
    s_prefix = 0ull;
    s_need = c;
    s_done = 0;
    s_count = 0;
  }
  __syncthreads();
  score_rows(emb, qs, keys, (long long)blockIdx.x * bm, M, D, bm);

  // Step 2: radix select.  Invariant: the keys whose resolved bits equal
  // s_prefix hold the s_need-th largest still to be found.  The loops
  // over i run the same trip count on every lane of a warp (bm is a
  // multiple of 32), as __match_any_sync and __ballot_sync need.
  u64 mask = 0ull;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += TK_THREADS) hist[b] = 0u;
    __syncthreads();
    const u64 prefix = s_prefix;
    for (int i = tid; i < bm; i += TK_THREADS) {
      const u64 k = keys[i];
      const bool in = (k & mask) == prefix;
      const unsigned digit = in ? (unsigned)(k >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l, the top bins first
      const unsigned need = (unsigned)s_need;
      unsigned cnt[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[255 - 8 * lane - j];
        sum += cnt[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      unsigned above = incl - sum;  // keys in higher bins
      if (above < need && need <= incl) {  // exactly one lane
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + cnt[j] >= need) {
            s_prefix = prefix | ((u64)(255 - 8 * lane - j) << shift);
            s_need = (int)(need - above);
            s_done = (above + cnt[j] == need) || shift == 0;
            break;
          }
          above += cnt[j];
        }
      }
    }
    __syncthreads();
    mask |= 0xFFull << shift;
    if (s_done) break;
  }
  // exactly c keys have (k & mask) >= s_prefix: compact them
  const u64 prefix = s_prefix;
  for (int i = tid; i < bm; i += TK_THREADS) {
    const u64 k = keys[i];
    const bool take = (k & mask) >= prefix;
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(&s_count, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (take) top[at + __popc(ballot & ((1u << lane) - 1u))] = k;
  }
  for (int i = c + tid; i < Q; i += TK_THREADS) top[i] = 0ull;  // below all
  __syncthreads();

  // Step 3: bitonic sort of the Q survivors, descending
  for (int k = 2; k <= Q; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < Q / 2; t += TK_THREADS) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i | j;
        const u64 a = top[i], b = top[l];
        if (((i & k) == 0) ? (a < b) : (a > b)) {
          top[i] = b;
          top[l] = a;
        }
      }
      __syncthreads();
    }
  }

  float* vb = vals + (size_t)blockIdx.x * c;
  int* ib = idx + (size_t)blockIdx.x * c;
  for (int i = tid; i < c; i += TK_THREADS) {
    const u64 key = top[i];
    vb[i] = key_value(key);
    ib[i] = key_index(key);
  }
}

template <typename T>
static int launch(const T* emb, const T* q, float* vals, int* idx, int M,
                  int D, int c, int bm, int Q, int nb, int smem,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      scored_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  scored_topk_kernel<T><<<nb, TK_THREADS, smem, (cudaStream_t)stream>>>(
      emb, q, vals, idx, M, D, c, bm, Q);
  return (int)cudaGetLastError();
}

// emb (M, D), q (D,) float32 -> vals (nb, c) float32, idx (nb, c) int32
// block survivors; smem = (bm + Q) * 8 + D * 4 bytes, sized by the
// wrapper.
extern "C" int scored_topk_f32(const float* emb, const float* q, float* vals,
                               int* idx, int M, int D, int c, int bm, int Q,
                               int nb, int smem, void* stream) {
  return launch(emb, q, vals, idx, M, D, c, bm, Q, nb, smem, stream);
}

// The same for bfloat16 emb and q, scored in float32.
extern "C" int scored_topk_bf16(const __nv_bfloat16* emb,
                                const __nv_bfloat16* q, float* vals, int* idx,
                                int M, int D, int c, int bm, int Q, int nb,
                                int smem, void* stream) {
  return launch(emb, q, vals, idx, M, D, c, bm, Q, nb, smem, stream);
}
