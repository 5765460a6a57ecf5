// Fused multi-step chunk kernels for resumable greedy DPP MAP (K5 exact,
// K6 windowed).
//
// Replace the Pallas TPU kernels src/repro/kernels/dpp_greedy/tiled.py::
// _chunk_pass_full (K5) and ::_chunk_pass_windowed (K6), with their
// running winner fold _reduce_argmax_and_cols, launched through
// _fused_chunk_call by fused_chunk_exact / fused_chunk_windowed.  One
// launch advances `chunk` greedy steps of a resumable state (C, d2, t,
// stopped, and windowed the ring ids), emitting sel / dh (B, chunk) and
// writing C, d2, stopped and the ring back in place.
//
// What bounds it on an H100: like K3/K4, each step streams the lane's V
// (D x M) and the live Cholesky rows through the SMs for two GEMVs,
// 2 (D + rows) FLOPs per 4 bytes, then an argmax across the whole lane:
// L2 / device-memory bandwidth and the per-step grid barrier, not FLOPs.
//
// Design: the Pallas grid (B, chunk, nt) ran its tiles in order and
// carried C/d2 across steps in output blocks revisited out of order;
// neither holds on a GPU.  Here one persistent cooperative launch
// (cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident) runs a grid of (nt, B) blocks: each block owns one M-tile
// of one lane for all `chunk` steps, keeps the tile's gains d2 in shared
// memory, and meets the other blocks at a grid barrier between steps.
// The barrier is grid_barrier() below, on a counter the wrapper zeroes
// per launch, rather than cooperative_groups' grid.sync(): in the exact
// kernel the latter compiled to a call that held the column loop to 40
// registers with spills, and tripled the step time on an H100.  Every
// block of a lane
// folds its tile's (max, lowest-index argmax) into one 64-bit atomicMax
// on an orderable key (common.cuh), one key slot per step, so after the
// barrier every block decodes the same winner with jnp.argmax's
// lowest-index tie rule; the chunk's first winner comes from the same
// fold over the state's d2 before the first barrier.  Cross-block data
// (keys, the winner's columns, the window factor) is read with __ldcg,
// from L2, never from a stale L1 line.
//
// Exact: the winner's V column is read-only and its Cholesky rows
// [0, t) were written before earlier barriers, while this step writes
// only row t, so every block stages them straight from C.  Windowed: the
// owner of the winner's column rotates it in place during the step, so
// each block also publishes its tile argmax's column (cand), and the
// owners of the ring's members publish the (w, w) window factor C[:, win]
// (wcol), both before the barrier into step-parity double buffers; every
// block then derives the eviction's Givens pairs from its own copy with
// the same evict_coeffs_warp() as K2, so all blocks agree bit for bit
// with no further barrier.  The per-column updates are common.cuh's
// col_exact / col_windowed, and the initial gains are init_gains', so a
// stream's concatenated chunks equal the resident K1/K2 slate bit for
// bit.  Nothing leaves the card inside a chunk.
#include "common.cuh"

// Grid-wide barrier of a co-resident grid: bar[0] counts the arrived
// blocks, bar[1] is the generation (both zero at launch).  Thread 0 of
// each block fences the block's writes device-wide, arrives, and the
// last arrival resets the count and opens the next generation while the
// others spin on it; the closing fence and block barrier order every
// later read after the others' writes.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x * gridDim.y - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Fold the tile's gains (shared d2, columns [i0, i1)) into this block's
// (max, lowest-index argmax); all threads call it, the result lands in
// *mx / *am.
__device__ __forceinline__ void tile_argmax(const float* d2, int i0, int i1,
                                            float* redv, int* redi,
                                            float* mx, int* am) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = i0 + (int)threadIdx.x; i < i1; i += DPP_THREADS)
    argmax_merge(bv, bi, d2[i - i0], i);
  block_argmax(bv, bi, redv, redi, mx, am);
}

// K5: `chunk` exact steps.  V (B, D, M), C (B, R, M) row layout (row t
// written at step t), d2 (B, M); t (B,) the lanes' step counters;
// stopped (B,) the eps-stop latch, updated; keys (chunk+1, B) and the
// barrier bar (2,) zeroed.
// A lane whose counter reaches R (the state's capacity) latches stopped.
__global__ void __launch_bounds__(DPP_THREADS)
fused_chunk_exact_kernel(const float* __restrict__ V, float* __restrict__ C,
                         float* __restrict__ d2g,
                         const int* __restrict__ t_in,
                         unsigned char* stopped, unsigned long long* keys,
                         unsigned int* bar, int* __restrict__ sel,
                         float* __restrict__ dh,
                         int B, int D, int M, int R, int chunk, int tile_m,
                         float eps2) {
  extern __shared__ float sm[];
  float* d2 = sm;                 // tile_m  the tile's gains
  float* vj = d2 + tile_m;        // D       winner's V column
  float* cj = vj + D;             // R       winner's Cholesky column
  float* redv = cj + R;           // 32
  int* redi = (int*)(redv + 32);  // 32
  __shared__ float s_mx;
  __shared__ int s_am;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * tile_m;
  const int i1 = min(i0 + tile_m, M);
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * R * M;
  float* d2b = d2g + (size_t)b * M;
  const bool lead = blockIdx.x == 0 && tid == 0;
  const int t0 = t_in[b];
  bool stop = stopped[b] != 0;

  for (int i = i0 + tid; i < i1; i += DPP_THREADS) d2[i - i0] = d2b[i];
  __syncthreads();
  tile_argmax(d2, i0, i1, redv, redi, &s_mx, &s_am);
  if (tid == 0) atomicMax(&keys[b], pack_key(s_mx, s_am));
  grid_barrier(bar);

  for (int s = 0; s < chunk; ++s) {
    const int t = t0 + s;
    float dj2;
    int j;
    unpack_key(__ldcg(&keys[(size_t)s * B + b]), dj2, j);
    stop = stop || dj2 <= eps2 || t >= R;
    const float dj = __fsqrt_rn(fmaxf(dj2, eps2));
    if (lead) {
      sel[(size_t)b * chunk + s] = stop ? -1 : j;
      dh[(size_t)b * chunk + s] = stop ? 0.f : dj;
    }
    if (!stop) {
      for (int d = tid; d < D; d += DPP_THREADS)
        vj[d] = Vb[(size_t)d * M + j];
      for (int r = tid; r < t; r += DPP_THREADS)
        cj[r] = __ldcg(&Cb[(size_t)r * M + j]);
      __syncthreads();
      for (int i = i0 + tid; i < i1; i += DPP_THREADS)
        d2[i - i0] = col_exact(Vb, Cb, M, D, t, vj, cj, dj, i, j, d2[i - i0]);
      __syncthreads();
      tile_argmax(d2, i0, i1, redv, redi, &s_mx, &s_am);
      if (tid == 0)
        atomicMax(&keys[(size_t)(s + 1) * B + b], pack_key(s_mx, s_am));
    }
    grid_barrier(bar);
  }
  for (int i = i0 + tid; i < i1; i += DPP_THREADS) d2b[i] = d2[i - i0];
  if (lead) stopped[b] = stop ? 1 : 0;
}

// K6: `chunk` sliding-window steps.  C (B, w, M) ring in window order,
// win (B, w) ring ids (-1 = empty), updated; cand (2, B, nt, w) and
// wcol (2, B, w, w) the step-parity exchange buffers (no initial
// contents needed).  Per step, as K2: select, derive the eviction from
// the window factor, rotate + repair + append every column of the tile,
// then shift the ring.
__global__ void __launch_bounds__(DPP_THREADS)
fused_chunk_windowed_kernel(const float* __restrict__ V,
                            float* __restrict__ C, float* __restrict__ d2g,
                            const int* __restrict__ t_in,
                            unsigned char* stopped, int* win_g,
                            unsigned long long* keys, unsigned int* bar,
                            float* cand,
                            float* wcol, int* __restrict__ sel,
                            float* __restrict__ dh, int B, int D, int M,
                            int w, int chunk, int tile_m, float eps2) {
  extern __shared__ float sm[];
  float* d2 = sm;                  // tile_m  the tile's gains
  float* vj = d2 + tile_m;         // D       winner's V column
  float* cj = vj + D;              // w       pre-eviction winner column
  float* cjp = cj + w;             // w       post-eviction winner column
  float* Cw = cjp + w;             // w*w     window factor, Cw[r*w+s]
  float* uw = Cw + w * w;          // w       residue row on the window
  float* cs = uw + w;              // w       cos (w-1 used)
  float* sn = cs + w;              // w       sin (w-1 used)
  int* win = (int*)(sn + w);       // w       ring ids, -1 = empty
  float* redv = (float*)(win + w); // 32
  int* redi = (int*)(redv + 32);   // 32
  __shared__ float s_mx, s_d2j;
  __shared__ int s_am;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nt = gridDim.x, blk = blockIdx.x;
  const int i0 = blk * tile_m;
  const int i1 = min(i0 + tile_m, M);
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * w * M;
  float* d2b = d2g + (size_t)b * M;
  const bool lead = blk == 0 && tid == 0;
  const int t0 = t_in[b];
  bool stop = stopped[b] != 0;
  const size_t ww = (size_t)w * w;

  // publish this block's tile argmax column and its ring members'
  // columns into parity slot p (after a __syncthreads that follows the
  // column writes and the ring update)
  auto publish = [&](int p) {
    float* cb = cand + (((size_t)p * B + b) * nt + blk) * w;
    for (int r = tid; r < w; r += DPP_THREADS)
      cb[r] = Cb[(size_t)r * M + s_am];
    float* wb = wcol + ((size_t)p * B + b) * ww;
    for (int q = tid; q < w * w; q += DPP_THREADS) {
      const int r = q / w, m = win[q % w];
      if (m >= i0 && m < i1) wb[q] = Cb[(size_t)r * M + m];
    }
  };

  for (int s = tid; s < w; s += DPP_THREADS) win[s] = win_g[(size_t)b * w + s];
  for (int i = i0 + tid; i < i1; i += DPP_THREADS) d2[i - i0] = d2b[i];
  __syncthreads();
  tile_argmax(d2, i0, i1, redv, redi, &s_mx, &s_am);
  if (tid == 0) atomicMax(&keys[b], pack_key(s_mx, s_am));
  publish(0);
  grid_barrier(bar);

  for (int s = 0; s < chunk; ++s) {
    const int t = t0 + s;
    const int p = s & 1;
    float dj2;
    int j;
    unpack_key(__ldcg(&keys[(size_t)s * B + b]), dj2, j);
    stop = stop || dj2 <= eps2;
    if (lead) {
      sel[(size_t)b * chunk + s] = stop ? -1 : j;
      dh[(size_t)b * chunk + s] = stop ? 0.f : __fsqrt_rn(fmaxf(dj2, eps2));
    }
    if (!stop) {
      const bool full = t >= w;
      const int pos = t < w - 1 ? t : w - 1;
      const int live = t < w ? t : w;
      const float* cb = cand + (((size_t)p * B + b) * nt + j / tile_m) * w;
      const float* wb = wcol + ((size_t)p * B + b) * ww;
      for (int d = tid; d < D; d += DPP_THREADS)
        vj[d] = Vb[(size_t)d * M + j];
      for (int r = tid; r < live; r += DPP_THREADS) cj[r] = __ldcg(&cb[r]);
      if (full)
        for (int q = tid; q < w * w; q += DPP_THREADS) Cw[q] = __ldcg(&wb[q]);
      __syncthreads();
      if (warp == 0)
        evict_coeffs_warp(lane, w, full, live, Cw, cj, dj2, uw, cs, sn, cjp,
                          &s_d2j);
      __syncthreads();
      const float djp = __fsqrt_rn(fmaxf(s_d2j, eps2));
      for (int i = i0 + tid; i < i1; i += DPP_THREADS)
        d2[i - i0] = col_windowed(Vb, Cb, M, D, w, full, pos, cs, sn, vj, cjp,
                                  djp, i, j, d2[i - i0]);
      __syncthreads();
      tile_argmax(d2, i0, i1, redv, redi, &s_mx, &s_am);
      if (tid == 0) {
        atomicMax(&keys[(size_t)(s + 1) * B + b], pack_key(s_mx, s_am));
        if (full) {
          for (int q = 0; q < w - 1; ++q) win[q] = win[q + 1];
          win[w - 1] = -1;
        }
        win[pos] = j;
      }
      __syncthreads();
      publish(p ^ 1);
    }
    grid_barrier(bar);
  }
  for (int i = i0 + tid; i < i1; i += DPP_THREADS) d2b[i] = d2[i - i0];
  if (lead) {
    stopped[b] = stop ? 1 : 0;
    for (int q = 0; q < w; ++q) win_g[(size_t)b * w + q] = win[q];
  }
}

// Host entry points: plain C interface for ctypes.  Each returns the
// cudaError_t of the attribute call, the occupancy query or the
// cooperative launch (0 = success); the caller raises on anything else
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot co-reside).
static void* chunk_kernel(int windowed) {
  return windowed ? (void*)fused_chunk_windowed_kernel
                  : (void*)fused_chunk_exact_kernel;
}

// Blocks of one fused-chunk kernel that can be co-resident on the
// current device at `smem` bytes of dynamic shared memory per block.
extern "C" int fused_chunk_capacity(int windowed, int smem, int* blocks) {
  const void* fn = chunk_kernel(windowed);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      DPP_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return 0;
}

extern "C" int fused_chunk_exact(const float* V, float* C, float* d2,
                                 const int* t, unsigned char* stopped,
                                 unsigned long long* keys, unsigned int* bar,
                                 int* sel,
                                 float* dh, int B, int D, int M, int R,
                                 int chunk, int tile_m, float eps2, int smem,
                                 void* stream) {
  const void* fn = chunk_kernel(0);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&V, &C, &d2, &t, &stopped, &keys, &bar, &sel, &dh,
                  &B, &D, &M, &R, &chunk, &tile_m, &eps2};
  dim3 grid((M + tile_m - 1) / tile_m, B);
  return (int)cudaLaunchCooperativeKernel(fn, grid, dim3(DPP_THREADS), args,
                                          (size_t)smem,
                                          (cudaStream_t)stream);
}

extern "C" int fused_chunk_windowed(const float* V, float* C, float* d2,
                                    const int* t, unsigned char* stopped,
                                    int* win, unsigned long long* keys,
                                    unsigned int* bar, float* cand,
                                    float* wcol, int* sel,
                                    float* dh, int B, int D, int M, int w,
                                    int chunk, int tile_m, float eps2,
                                    int smem, void* stream) {
  const void* fn = chunk_kernel(1);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&V, &C, &d2, &t, &stopped, &win, &keys, &bar, &cand,
                  &wcol,
                  &sel, &dh, &B, &D, &M, &w, &chunk, &tile_m, &eps2};
  dim3 grid((M + tile_m - 1) / tile_m, B);
  return (int)cudaLaunchCooperativeKernel(fn, grid, dim3(DPP_THREADS), args,
                                          (size_t)smem,
                                          (cudaStream_t)stream);
}
