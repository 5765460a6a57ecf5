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
// L2 / device-memory bandwidth and the per-step barrier, not FLOPs.
//
// Design: the Pallas grid (B, chunk, nt) ran its tiles in order and
// carried C/d2 across steps in output blocks revisited out of order;
// neither holds on a GPU.  Here one persistent cooperative launch
// (cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident) runs a grid of (nt, B) blocks: each block owns one M-tile
// of one lane for all `chunk` steps, keeps the tile's gains d2 in shared
// memory, and meets the other blocks of its lane at a barrier between
// steps (lane_barrier: the lanes share nothing, so they need not wait
// for each other), on per-lane counters the wrapper zeroes per launch,
// rather than cooperative_groups' grid.sync(), which in the exact kernel
// compiled to a call that held the column loop to 40 registers with
// spills.  Every block of a lane folds its tile's (max, lowest-index
// argmax) into one 64-bit atomicMax on an orderable key (common.cuh),
// one key slot per step, so after the barrier every block decodes the
// same winner with jnp.argmax's lowest-index tie rule; the chunk's
// first winner comes from the same fold over the state's d2 before the
// first barrier.  Cross-block data (keys, the winner's columns, the
// window factor) is read with __ldcg, from L2, never from a stale L1
// line.
//
// Exact: the winner's V column is read-only and its Cholesky rows
// [0, t) were written before earlier barriers, while this step writes
// only row t, so every block stages them straight from device memory
// (__ldcg: another block of the lane owns column j).  Windowed: the
// owner of the winner's column rotates it in place during the step, so
// each block also publishes its tile argmax's column (cand), and the
// owners of the ring's members publish the (w, w) window factor C[:, win]
// (wcol), both before the barrier into step-parity double buffers; every
// block then derives the eviction's Givens pairs from its own copy with
// the same evict_coeffs_warp() as K2, so all blocks agree bit for bit
// with no further barrier.  The initial gains are init_gains', and the
// per-column updates are common.cuh's cols_exact and cols_windowed,
// which the resident K1/K2 run too, so a stream's concatenated chunks
// equal the resident K1/K2 slate bit for bit.  Nothing leaves the
// card inside a chunk.
//
// Windowed, the block alone owns its tile's slice of the ring for the
// whole chunk, so the slice lives in shared memory: loaded once per
// launch (cp.async, every copy in flight), rotated, repaired and
// appended there every step, published from there, and written back to
// C once at the end.  In both kernels, where the tile's V slice fits
// beside the rest (tiling.chunk_v_resident: one block's 227 KB, and the
// grid still co-resident), V is loaded into shared memory once per
// launch too, and every step of the chunk reads it from there (at
// B = 64, C = 1000, D = 100: two tiles of 512 per lane, one block per
// SM, exact with k = 50 and windowed with w = 10); otherwise V streams
// from device memory every step with the evict-first hint.  The exact
// kernel's Cholesky rows stay in device memory (L2 at that shape): with
// V they would not fit.
#include "common.cuh"

// Barrier of the co-resident blocks of one lane (the lanes share
// nothing, so they need not wait for each other) on the lane's own
// arrival counter (zero at launch), which only grows: the n-th barrier
// of the launch waits until it reaches n * (the lane's block count),
// `target`.  Thread 0 arrives with a release add and spins on acquire
// loads, so the block's writes before it are visible to every block of
// the lane after it, with two round trips to L2 and no reset.
__device__ __forceinline__ void lane_barrier(unsigned int* ctr,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int v;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], 1;"
                 : "=r"(v) : "l"(ctr) : "memory");
    for (++v; v < target;)
      asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                   : "=r"(v) : "l"(ctr) : "memory");
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
// stopped (B,) the eps-stop latch, updated; keys (chunk+1, B) zeroed;
// bar (B, 2) u32, the lanes' barrier counters in column 0, zeroed.  The
// block keeps its tile's gains in shared memory for the whole chunk and,
// with vres, its (D, tile_m) slice of V as well; otherwise V streams
// from device memory every step.  A lane whose counter reaches R (the
// state's capacity) latches stopped.
__global__ void __launch_bounds__(DPP_THREADS, 2)
fused_chunk_exact_kernel(const float* __restrict__ V, float* __restrict__ C,
                         float* __restrict__ d2g,
                         const int* __restrict__ t_in,
                         unsigned char* stopped, unsigned long long* keys,
                         unsigned int* bar, int* __restrict__ sel,
                         float* __restrict__ dh,
                         int B, int D, int M, int R, int chunk, int tile_m,
                         int vres, float eps2) {
  extern __shared__ float sm[];
  float* d2 = sm;                                    // tile_m  the gains
  float* Vs = d2 + tile_m;                           // D*tile_m  with vres
  float* vj = Vs + (vres ? (size_t)D * tile_m : 0);  // D  winner's V column
  float* cj = vj + D;             // R       winner's Cholesky column
  float* redv = cj + R;           // 32
  int* redi = (int*)(redv + 32);  // 32
  __shared__ float s_mx;
  __shared__ int s_am;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int nt = gridDim.x;
  const int i0 = blockIdx.x * tile_m;
  const int i1 = min(i0 + tile_m, M);
  const int n = i1 - i0;
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * R * M;
  float* d2b = d2g + (size_t)b * M;
  const bool lead = blockIdx.x == 0 && tid == 0;
  const int t0 = t_in[b];
  bool stop = stopped[b] != 0;
  unsigned int* lbar = bar + 2 * b;  // the lane's arrival counter

  stage_async(d2, 0, d2b + i0, 0, 1, n);
  if (vres) stage_async(Vs, tile_m, Vb + i0, M, D, n);
  cp_async_wait_all();
  __syncthreads();
  tile_argmax(d2, i0, i1, redv, redi, &s_mx, &s_am);
  if (tid == 0) atomicMax(&keys[b], pack_key(s_mx, s_am));
  lane_barrier(lbar, nt);  // the launch's first barrier

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
        vj[d] = __ldcg(&Vb[(size_t)d * M + j]);
      for (int r = tid; r < t; r += DPP_THREADS)
        cj[r] = __ldcg(&Cb[(size_t)r * M + j]);
      __syncthreads();
      float bv = -INFINITY;
      int bi = INT_MAX;
      if (vres)
        cols_exact<2, LoadPlain>(Vs, tile_m, Cb + i0, M, d2, n, i0, D, t, vj,
                                 cj, dj, j, bv, bi);
      else
        cols_exact<4, LoadStreaming>(Vb + i0, M, Cb + i0, M, d2, n, i0, D, t,
                                     vj, cj, dj, j, bv, bi);
      block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
      if (tid == 0)
        atomicMax(&keys[(size_t)(s + 1) * B + b], pack_key(s_mx, s_am));
    }
    lane_barrier(lbar, (unsigned int)nt * (s + 2));
  }
  for (int x = tid; x < n; x += DPP_THREADS) d2b[i0 + x] = d2[x];
  if (lead) stopped[b] = stop ? 1 : 0;
}

// K6: `chunk` sliding-window steps.  C (B, w, M) ring in window order,
// win (B, w) ring ids (-1 = empty), updated; cand (2, B, nt, w) and
// wcol (2, B, w, w) the step-parity exchange buffers (no initial
// contents needed); bar (B, 2) u32, the lanes' barrier counters in
// column 0, zeroed.  Per step, as K2: select, derive the eviction from
// the window factor, rotate + repair + append every column of the tile,
// then shift the ring.  The block keeps its tile's gains and its
// (w, tile_m) slice of the ring in shared memory for the whole chunk
// (loaded at the start, written back at the end) and, with vres, its
// (D, tile_m) slice of V as well; otherwise V streams from device
// memory every step.
__global__ void __launch_bounds__(DPP_THREADS, 2)
fused_chunk_windowed_kernel(const float* __restrict__ V,
                            float* __restrict__ C, float* __restrict__ d2g,
                            const int* __restrict__ t_in,
                            unsigned char* stopped, int* win_g,
                            unsigned long long* keys, unsigned int* bar,
                            float* cand,
                            float* wcol, int* __restrict__ sel,
                            float* __restrict__ dh, int B, int D, int M,
                            int w, int chunk, int tile_m, int vres,
                            float eps2) {
  extern __shared__ float sm[];
  float* d2 = sm;                              // tile_m    the tile's gains
  float* ring = d2 + tile_m;                   // w*tile_m  the tile's ring
  float* Vs = ring + (size_t)w * tile_m;       // D*tile_m  with vres
  float* vj = Vs + (vres ? (size_t)D * tile_m : 0);  // D  winner's V column
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
  const int n = i1 - i0;
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * w * M;
  float* d2b = d2g + (size_t)b * M;
  const bool lead = blk == 0 && tid == 0;
  const int t0 = t_in[b];
  bool stop = stopped[b] != 0;
  const size_t ww = (size_t)w * w;
  unsigned int* lbar = bar + 2 * b;  // the lane's arrival counter

  // publish this block's tile argmax column and its ring members'
  // columns into parity slot p, from the shared ring (after a
  // __syncthreads that follows the column writes and the ring update)
  auto publish = [&](int p) {
    float* cb = cand + (((size_t)p * B + b) * nt + blk) * w;
    for (int r = tid; r < w; r += DPP_THREADS)
      cb[r] = ring[(size_t)r * tile_m + (s_am - i0)];
    float* wb = wcol + ((size_t)p * B + b) * ww;
    for (int q = tid; q < w * w; q += DPP_THREADS) {
      const int r = q / w, m = win[q % w];
      if (m >= i0 && m < i1) wb[q] = ring[(size_t)r * tile_m + (m - i0)];
    }
  };

  for (int s = tid; s < w; s += DPP_THREADS) win[s] = win_g[(size_t)b * w + s];
  stage_async(d2, 0, d2b + i0, 0, 1, n);
  stage_async(ring, tile_m, Cb + i0, M, w, n);
  if (vres) stage_async(Vs, tile_m, Vb + i0, M, D, n);
  cp_async_wait_all();
  __syncthreads();
  tile_argmax(d2, i0, i1, redv, redi, &s_mx, &s_am);
  if (tid == 0) atomicMax(&keys[b], pack_key(s_mx, s_am));
  publish(0);
  lane_barrier(lbar, nt);  // the launch's first barrier

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
      auto ready = [&]() {
        if (warp == 0 && w <= 32)
          evict_coeffs_warp_reg(lane, w, full, live, Cw, cj, dj2, cs, sn,
                                cjp, &s_d2j);
        else if (warp == 0)
          evict_coeffs_warp(lane, w, full, live, Cw, cj, dj2, uw, cs, sn,
                            cjp, &s_d2j);
        __syncthreads();
        return __fsqrt_rn(fmaxf(s_d2j, eps2));
      };
      float bv = -INFINITY;
      int bi = INT_MAX;
      if (vres)
        cols_windowed<3, LoadPlain>(Vs, tile_m, ring, tile_m, d2, n, i0, D,
                                    w, full, pos, cs, sn, vj, cjp, ready, j,
                                    bv, bi);
      else
        cols_windowed<5, LoadStreaming>(Vb + i0, M, ring, tile_m, d2, n, i0,
                                        D, w, full, pos, cs, sn, vj, cjp,
                                        ready, j, bv, bi);
      // ends in a __syncthreads: the ring writes are visible to publish
      block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
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
    lane_barrier(lbar, (unsigned int)nt * (s + 2));
  }
  for (int x = tid; x < n; x += DPP_THREADS) d2b[i0 + x] = d2[x];
  for (int r = 0; r < w; ++r)
    for (int x = tid; x < n; x += DPP_THREADS)
      Cb[(size_t)r * M + i0 + x] = ring[(size_t)r * tile_m + x];
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
                                 int chunk, int tile_m, int vres, float eps2,
                                 int smem, void* stream) {
  const void* fn = chunk_kernel(0);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&V, &C, &d2, &t, &stopped, &keys, &bar, &sel, &dh,
                  &B, &D, &M, &R, &chunk, &tile_m, &vres, &eps2};
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
                                    int chunk, int tile_m, int vres,
                                    float eps2, int smem, void* stream) {
  const void* fn = chunk_kernel(1);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&V, &C, &d2, &t, &stopped, &win, &keys, &bar, &cand,
                  &wcol, &sel, &dh, &B, &D, &M, &w, &chunk, &tile_m,
                  &vres, &eps2};
  dim3 grid((M + tile_m - 1) / tile_m, B);
  return (int)cudaLaunchCooperativeKernel(fn, grid, dim3(DPP_THREADS), args,
                                          (size_t)smem,
                                          (cudaStream_t)stream);
}
