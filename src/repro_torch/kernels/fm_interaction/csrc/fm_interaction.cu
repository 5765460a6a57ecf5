// Fused factorization-machine second-order term (K8).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fm_interaction/
// fm_interaction.py::_kernel, launched by fm_interaction_kernel: per
// example b of emb (N, F, D),
//
//     y_b = 0.5 * sum_d [ (sum_f v_bfd)^2 - sum_f v_bfd^2 ]
//
// accumulated in f32 (bf16 input is upcast on load, as the Pallas body
// does).
//
// What bounds it on an H100: every input value is read once and used for
// three FLOPs, so it is bound by device memory, N * F * D * sizeof(T)
// bytes over 3.35 TB/s (0.477 ms for DeepFM's 39 x 10 f32 embeddings of
// 1,024,000 scored rows).
//
// Design: one block per block_b examples (the Pallas grid step), which
// lie contiguously in memory.  The block walks them in tiles of `tile`
// examples (the wrapper sizes a tile to ~48 KB of shared memory, so
// several blocks share an SM and one block's copy overlaps another's
// sums).  Each tile is first copied into shared memory with consecutive
// threads on consecutive addresses, so the device-memory reads are fully
// coalesced whatever F and D are.  Then one thread per (example, d) pair
// sums over f in shared memory, and a second pass sums each example's D
// partial terms in a fixed order (d = 0, 1, ...).  The ragged last block
// is masked by example index: nothing is padded.  At DeepFM's D = 10 the
// (example, d) pass keeps every lane busy, because lanes run over
// examples as well as d.  Later work: vectorised 16-byte loads, a copy
// that overlaps the same block's sums (cp.async double buffering).
//
// The backward (fm_interaction_bwd_kernel, launched by
// fm_interaction_bwd_kernel in fm_interaction.py) has no Pallas twin:
// repro differentiates its jnp fm_second_order with jax.grad.  Per
// element of emb,
//
//     grad_bfd = g_b * (s_bd - v_bfd),   s_bd = sum_f v_bfd  (f ascending)
//
// computed in f32 and rounded once to emb's dtype.  It walks the same
// tiles as the forward: a tile is copied into shared memory coalesced,
// one thread per (example, d) pair recomputes s into shared memory, then
// consecutive threads write consecutive gradient elements.  Each value of
// emb is read once and each gradient written once, so it is bound by
// device memory: (2 * N * F * D * sizeof(T) + 4 * N) bytes over 3.35 TB/s
// (0.0611 ms at DeepFM's train batch, N = 65,536, F = 39, D = 10, f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FM_THREADS 256

__device__ __forceinline__ float fm_load(const float* p) { return *p; }
__device__ __forceinline__ float fm_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(FM_THREADS)
fm_interaction_kernel(const T* __restrict__ emb, float* __restrict__ out,
                      int N, int F, int D, int block_b, int tile) {
  extern __shared__ float sm[];
  const int per = F * D;
  float* v = sm;                          // tile * F * D staged values
  float* part = v + (size_t)tile * per;   // tile * D partial terms
  const int b0 = blockIdx.x * block_b;
  const int b1 = min(b0 + block_b, N);    // ragged last block
  for (int n0 = b0; n0 < b1; n0 += tile) {
    const int nt = min(tile, b1 - n0);
    const T* src = emb + (size_t)n0 * per;
    for (int i = threadIdx.x; i < nt * per; i += FM_THREADS)
      v[i] = fm_load(src + i);
    __syncthreads();
    for (int p = threadIdx.x; p < nt * D; p += FM_THREADS) {
      const int n = p / D, d = p - n * D;
      const float* row = v + (size_t)n * per + d;
      float s = 0.f, sq = 0.f;
      for (int f = 0; f < F; ++f) {
        const float x = row[f * D];
        s += x;
        sq = fmaf(x, x, sq);
      }
      part[p] = fmaf(s, s, -sq);
    }
    __syncthreads();
    for (int n = threadIdx.x; n < nt; n += FM_THREADS) {
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += part[n * D + d];
      out[n0 + n] = 0.5f * acc;
    }
    __syncthreads();  // the next tile overwrites v and part
  }
}

__device__ __forceinline__ void fm_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fm_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T>
__global__ void __launch_bounds__(FM_THREADS)
fm_interaction_bwd_kernel(const T* __restrict__ emb,
                          const float* __restrict__ g, T* __restrict__ grad,
                          int N, int F, int D, int block_b, int tile) {
  extern __shared__ float sm[];
  const int per = F * D;
  float* v = sm;                          // tile * F * D staged values
  float* s = v + (size_t)tile * per;      // tile * D column sums
  const int b0 = blockIdx.x * block_b;
  const int b1 = min(b0 + block_b, N);    // ragged last block
  for (int n0 = b0; n0 < b1; n0 += tile) {
    const int nt = min(tile, b1 - n0);
    const size_t base = (size_t)n0 * per;
    for (int i = threadIdx.x; i < nt * per; i += FM_THREADS)
      v[i] = fm_load(emb + base + i);
    __syncthreads();
    for (int p = threadIdx.x; p < nt * D; p += FM_THREADS) {
      const int n = p / D, d = p - n * D;
      const float* row = v + (size_t)n * per + d;
      float acc = 0.f;
      for (int f = 0; f < F; ++f) acc += row[f * D];
      s[p] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt * per; i += FM_THREADS) {
      const int n = i / per, d = (i - n * per) % D;
      fm_store(grad + base + i, g[n0 + n] * (s[n * D + d] - v[i]));
    }
    __syncthreads();  // the next tile overwrites v and s
  }
}

template <typename T>
static int launch_bwd(const T* emb, const float* g, T* grad, int N, int F,
                      int D, int block_b, int tile, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fm_interaction_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + block_b - 1) / block_b;
  fm_interaction_bwd_kernel<T>
      <<<grid, FM_THREADS, smem, (cudaStream_t)stream>>>(
          emb, g, grad, N, F, D, block_b, tile);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* emb, float* out, int N, int F, int D, int block_b,
                  int tile, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fm_interaction_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + block_b - 1) / block_b;
  fm_interaction_kernel<T><<<grid, FM_THREADS, smem, (cudaStream_t)stream>>>(
      emb, out, N, F, D, block_b, tile);
  return (int)cudaGetLastError();
}

// emb (N, F, D) float32 -> out (N,) float32.  smem = tile * (F + 1) * D
// * 4 bytes, sized by the wrapper.
extern "C" int fm_interaction_f32(const float* emb, float* out, int N, int F,
                                  int D, int block_b, int tile, int smem,
                                  void* stream) {
  return launch(emb, out, N, F, D, block_b, tile, smem, stream);
}

// emb (N, F, D) bfloat16 -> out (N,) float32, accumulated in float32.
extern "C" int fm_interaction_bf16(const __nv_bfloat16* emb, float* out,
                                   int N, int F, int D, int block_b,
                                   int tile, int smem, void* stream) {
  return launch(emb, out, N, F, D, block_b, tile, smem, stream);
}

// Backward: emb (N, F, D) float32, g (N,) float32 -> grad (N, F, D)
// float32.  smem as the forward's.
extern "C" int fm_interaction_bwd_f32(const float* emb, const float* g,
                                      float* grad, int N, int F, int D,
                                      int block_b, int tile, int smem,
                                      void* stream) {
  return launch_bwd(emb, g, grad, N, F, D, block_b, tile, smem, stream);
}

// Backward: emb (N, F, D) bfloat16, g (N,) float32 -> grad (N, F, D)
// bfloat16, computed in float32 and rounded once.
extern "C" int fm_interaction_bwd_bf16(const __nv_bfloat16* emb,
                                       const float* g, __nv_bfloat16* grad,
                                       int N, int F, int D, int block_b,
                                       int tile, int smem, void* stream) {
  return launch_bwd(emb, g, grad, N, F, D, block_b, tile, smem, stream);
}
