// Tiled per-step greedy DPP MAP kernels (K3 exact, K4 windowed).
//
// Replace the Pallas TPU kernels src/repro/kernels/dpp_greedy/tiled.py::
// _pass_full (K3, with _tile_update_full and _reduce_running_argmax) and
// ::_pass_windowed (K4, with _tile_update_windowed), launched through
// _sweep by dpp_greedy_tiled.  One launch is one greedy step over a grid
// of (ceil(M / tile_m), B) blocks: every block applies the update of the
// step's winner to its tile of columns, then folds its tile's
// (max, lowest-index argmax) into the next step's key.
//
// What bounds it on an H100: each step reads V (B x D x M) and the live
// Cholesky rows once from device memory and writes one row (exact) or
// the ring (windowed) back, for 2 (D + rows) FLOPs per 4 bytes: device
// memory bandwidth bound (3.35 TB/s), plus one launch per step.
//
// Design: the TPU kernel ran its tiles in order and carried the running
// argmax in a revisited output cell; here the tiles run in parallel, so
// the cross-block argmax is one 64-bit atomicMax per block on an
// orderable key (float bits mapped to unsigned order, inverted column
// index; common.cuh), which keeps the largest gain and, on equal gains,
// the lowest global index, as jnp.argmax does.  The next launch decodes
// the winner from that key, so the k-step loop runs with no host round
// trip and, exact, no PyTorch op between launches.  Each thread owns
// strided columns of its tile, reading V and C coalesced along M and
// updating C and d2 in place (a column is only ever touched by its own
// thread).  The ragged last tile is masked by its bounds.  FP32 FMA on
// CUDA cores.  Later work: a CUDA graph over the k launches, a fused
// multi-step persistent kernel (ROADMAP queue 2).
#include "common.cuh"

// K3: one exact step t.  keys (k+1, B) u64: row t holds this step's
// winner, row t+1 (zeroed) receives the next one.  flags (k+1, B) i32:
// the eps-stop latch.  The block of tile 0 writes sel/dh[b, t] and the
// latch for t+1.  C (B, k, M), d2 (B, M) updated in place.
__global__ void __launch_bounds__(DPP_THREADS)
tiled_step_exact_kernel(const float* __restrict__ V, float* __restrict__ C,
                        float* __restrict__ d2,
                        unsigned long long* __restrict__ keys,
                        int* __restrict__ flags, int* __restrict__ sel,
                        float* __restrict__ dh, int B, int D, int M, int k,
                        int t, int tile_m, float eps2) {
  extern __shared__ float sm[];
  float* vj = sm;                 // D
  float* cj = vj + D;             // k
  float* redv = cj + k;           // 32
  int* redi = (int*)(redv + 32);  // 32
  __shared__ float s_mx;
  __shared__ int s_am;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * tile_m;
  const int i1 = min(i0 + tile_m, M);
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * k * M;
  float* d2b = d2 + (size_t)b * M;

  float dj2;
  int j;
  unpack_key(keys[(size_t)t * B + b], dj2, j);
  const bool stop = flags[(size_t)t * B + b] != 0 || dj2 <= eps2;
  const float dj = __fsqrt_rn(fmaxf(dj2, eps2));
  if (blockIdx.x == 0 && tid == 0) {
    sel[(size_t)b * k + t] = stop ? -1 : j;
    dh[(size_t)b * k + t] = stop ? 0.f : dj;
    flags[(size_t)(t + 1) * B + b] = stop ? 1 : 0;
  }

  float bv = -INFINITY;
  int bi = INT_MAX;
  if (!stop) {
    for (int d = tid; d < D; d += DPP_THREADS) vj[d] = Vb[(size_t)d * M + j];
    for (int r = tid; r < t; r += DPP_THREADS) cj[r] = Cb[(size_t)r * M + j];
    __syncthreads();
    for (int i = i0 + tid; i < i1; i += DPP_THREADS) {
      const float v = col_exact(Vb, Cb, M, D, t, vj, cj, dj, i, j, d2b[i]);
      d2b[i] = v;
      argmax_merge(bv, bi, v, i);
    }
  } else {
    for (int i = i0 + tid; i < i1; i += DPP_THREADS)
      argmax_merge(bv, bi, d2b[i], i);
  }
  block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
  if (tid == 0)
    atomicMax(&keys[(size_t)(t + 1) * B + b], pack_key(s_mx, s_am));
}

// K4: one windowed step.  The small per-user state of the step is
// resolved between launches by the PyTorch whole-slate loop (tiled.py:
// eviction_coeffs over the (w, w) window factor) and passed in:
// flt (B, 3 + 2(w-1)) = [djp, stopped, full, cos_0.., sin_0..],
// ints (B, 2) = [j, pos], cjp (B, w) the winner's post-eviction column.
// C (B, w, M) ring and d2 (B, M) updated in place; the tile's argmax goes
// to key_out (B,) (zeroed) by atomicMax.
__global__ void __launch_bounds__(DPP_THREADS)
tiled_step_windowed_kernel(const float* __restrict__ V, float* __restrict__ C,
                           float* __restrict__ d2,
                           const float* __restrict__ cjp_in,
                           const float* __restrict__ flt,
                           const int* __restrict__ ints,
                           unsigned long long* __restrict__ key_out, int D,
                           int M, int w, int tile_m) {
  extern __shared__ float sm[];
  float* vj = sm;                 // D
  float* cjp = vj + D;            // w
  float* cs = cjp + w;            // w (w-1 used)
  float* sn = cs + w;             // w (w-1 used)
  float* redv = sn + w;           // 32
  int* redi = (int*)(redv + 32);  // 32
  __shared__ float s_mx;
  __shared__ int s_am;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int nf = 3 + 2 * (w - 1);
  const int i0 = blockIdx.x * tile_m;
  const int i1 = min(i0 + tile_m, M);
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * w * M;
  float* d2b = d2 + (size_t)b * M;
  const float* fb = flt + (size_t)b * nf;
  const float djp = fb[0];
  const bool stop = fb[1] > 0.f;
  const bool full = fb[2] > 0.f;
  const int j = ints[2 * b], pos = ints[2 * b + 1];

  float bv = -INFINITY;
  int bi = INT_MAX;
  if (!stop) {
    for (int d = tid; d < D; d += DPP_THREADS) vj[d] = Vb[(size_t)d * M + j];
    for (int r = tid; r < w; r += DPP_THREADS) cjp[r] = cjp_in[(size_t)b * w + r];
    for (int r = tid; r < w - 1; r += DPP_THREADS) {
      cs[r] = fb[3 + r];
      sn[r] = fb[3 + (w - 1) + r];
    }
    __syncthreads();
    for (int i = i0 + tid; i < i1; i += DPP_THREADS) {
      const float v = col_windowed(Vb, Cb, M, D, w, full, pos, cs, sn, vj,
                                   cjp, djp, i, j, d2b[i]);
      d2b[i] = v;
      argmax_merge(bv, bi, v, i);
    }
  } else {
    for (int i = i0 + tid; i < i1; i += DPP_THREADS)
      argmax_merge(bv, bi, d2b[i], i);
  }
  block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
  if (tid == 0) atomicMax(&key_out[b], pack_key(s_mx, s_am));
}

extern "C" int tiled_step_exact(const float* V, float* C, float* d2,
                                unsigned long long* keys, int* flags,
                                int* sel, float* dh, int B, int D, int M,
                                int k, int t, int tile_m, float eps2, int smem,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_step_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + tile_m - 1) / tile_m, B);
  tiled_step_exact_kernel<<<grid, DPP_THREADS, smem, (cudaStream_t)stream>>>(
      V, C, d2, keys, flags, sel, dh, B, D, M, k, t, tile_m, eps2);
  return (int)cudaGetLastError();
}

extern "C" int tiled_step_windowed(const float* V, float* C, float* d2,
                                   const float* cjp, const float* flt,
                                   const int* ints,
                                   unsigned long long* key_out, int B, int D,
                                   int M, int w, int tile_m, int smem,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_step_windowed_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + tile_m - 1) / tile_m, B);
  tiled_step_windowed_kernel<<<grid, DPP_THREADS, smem,
                               (cudaStream_t)stream>>>(
      V, C, d2, cjp, flt, ints, key_out, D, M, w, tile_m);
  return (int)cudaGetLastError();
}
