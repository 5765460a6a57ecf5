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
// memory bandwidth bound (3.35 TB/s), plus one launch per step.  V does
// not stay on the chip past the resident budget (at B = 4, M = 65,536 it
// is 104.9 MB), so every step streams it: 31.3 us a step at best.
//
// Design: the TPU kernel ran its tiles in order and carried the running
// argmax in a revisited output cell; here the tiles run in parallel, so
// the cross-block argmax is one 64-bit atomicMax per block on an
// orderable key (float bits mapped to unsigned order, inverted column
// index; common.cuh), which keeps the largest gain and, on equal gains,
// the lowest global index, as jnp.argmax does.  The next launch decodes
// the winner from that key, so the k-step loop runs with no host round
// trip and no PyTorch op between launches, exact or windowed: the
// windowed step's small per-user state (the winner's pre-eviction
// column, the (w, w) window factor, the ring ids) crosses from one
// launch to the next through step-parity buffers, with the kernel
// boundary as the barrier, and every block derives the eviction's
// Givens pairs itself with K2's evict_coeffs_warp.  Both steps run
// several columns per thread with their loads in flight (common.cuh):
// K3 cols_exact, four columns per thread of all eight warps with eight
// rows of V (four of C) loaded ahead of the FMAs; K4 cols_windowed, five
// columns per thread of warps 1-7 with eight rows of V (four of the
// ring) loaded ahead, while warp 0 derives the eviction.  Both read V
// with the evict-first hint, so the live rows of C (the ring) and d2
// stay in L2 between launches, and both ask for two co-resident blocks
// per SM (at most 128 registers a thread), so a step's 256 blocks at
// B = 4, M = 65,536 run in one wave on 132 SMs.  C and d2 are updated
// in place (a column is only ever touched by its own thread).  The
// ragged last tile is masked by its bounds.  FP32 FMA on CUDA cores.
//
// The host entry points launch only: the wrapper raises each kernel's
// dynamic shared-memory limit once per size (tiled_set_smem), not per
// launch, and works out its operands once per whole-slate call.
#include "common.cuh"

// K3: one exact step t.  keys (k+1, B) u64: row t holds this step's
// winner, row t+1 (zeroed) receives the next one.  flags (k+1, B) i32:
// the eps-stop latch.  The block of tile 0 writes sel/dh[b, t] and the
// latch for t+1.  C (B, k, M), d2 (B, M) updated in place.
__global__ void __launch_bounds__(DPP_THREADS, 2)
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
    cols_exact<4, LoadStreaming>(Vb + i0, M, Cb + i0, M, d2b + i0, i1 - i0,
                                 i0, D, t, vj, cj, dj, j, bv, bi);
  } else {
    for (int i = i0 + tid; i < i1; i += DPP_THREADS)
      argmax_merge(bv, bi, d2b[i], i);
  }
  block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
  if (tid == 0)
    atomicMax(&keys[(size_t)(t + 1) * B + b], pack_key(s_mx, s_am));
}

// K4: one windowed step t, with its small per-user state resolved on
// the card (nothing runs between launches).  keys / flags / sel / dh as
// K3.  Step-parity buffers, parity p = t & 1 read, p ^ 1 written:
// win (2, B, w) the ring ids (-1 = empty), cand (2, B, nt, w) each
// tile's argmax column after its update, wcol (2, B, w, w) the window
// factor C[:, win] after the update, published by the members' owners
// (all three zero / empty at parity 0 before step 0).  Each block
// decodes the winner j from keys[t], stages j's pre-eviction column from
// its tile's cand and the window factor from wcol, derives the Givens
// pairs with evict_coeffs_warp (as K2 and K6), updates its tile with
// cols_windowed, folds its argmax into keys[t + 1], and publishes parity
// p ^ 1; block 0 writes the next ring ids.  C (B, w, M) ring and
// d2 (B, M) updated in place.
__global__ void __launch_bounds__(DPP_THREADS, 2)
tiled_step_windowed_kernel(const float* __restrict__ V, float* __restrict__ C,
                           float* __restrict__ d2,
                           unsigned long long* __restrict__ keys,
                           int* __restrict__ flags, int* __restrict__ sel,
                           float* __restrict__ dh, int* __restrict__ win_g,
                           float* __restrict__ cand,
                           float* __restrict__ wcol, int B, int D, int M,
                           int w, int k, int t, int tile_m, float eps2) {
  extern __shared__ float sm[];
  float* vj = sm;                  // D       winner's V column
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
  const int p = t & 1;
  const size_t ww = (size_t)w * w;
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * w * M;
  float* d2b = d2 + (size_t)b * M;

  float dj2;
  int j;
  unpack_key(keys[(size_t)t * B + b], dj2, j);
  const bool stop = flags[(size_t)t * B + b] != 0 || dj2 <= eps2;
  if (blk == 0 && tid == 0) {
    sel[(size_t)b * k + t] = stop ? -1 : j;
    dh[(size_t)b * k + t] = stop ? 0.f : __fsqrt_rn(fmaxf(dj2, eps2));
    flags[(size_t)(t + 1) * B + b] = stop ? 1 : 0;
  }
  for (int s = tid; s < w; s += DPP_THREADS)
    win[s] = win_g[((size_t)p * B + b) * w + s];

  const bool full = t >= w;
  const int pos = t < w - 1 ? t : w - 1;
  float bv = -INFINITY;
  int bi = INT_MAX;
  if (!stop) {
    const int live = t < w ? t : w;
    const float* cb = cand + (((size_t)p * B + b) * nt + j / tile_m) * w;
    const float* wb = wcol + ((size_t)p * B + b) * ww;
    for (int d = tid; d < D; d += DPP_THREADS) vj[d] = Vb[(size_t)d * M + j];
    for (int r = tid; r < live; r += DPP_THREADS) cj[r] = cb[r];
    if (full)
      for (int q = tid; q < w * w; q += DPP_THREADS) Cw[q] = wb[q];
    __syncthreads();
    auto ready = [&]() {
      if (warp == 0 && w <= 32)
        evict_coeffs_warp_reg(lane, w, full, live, Cw, cj, dj2, cs, sn, cjp,
                              &s_d2j);
      else if (warp == 0)
        evict_coeffs_warp(lane, w, full, live, Cw, cj, dj2, uw, cs, sn, cjp,
                          &s_d2j);
      __syncthreads();
      return __fsqrt_rn(fmaxf(s_d2j, eps2));
    };
    cols_windowed<5, LoadStreaming>(Vb + i0, M, Cb + i0, M, d2b + i0,
                                    i1 - i0, i0, D, w, full, pos, cs, sn, vj,
                                    cjp, ready, j, bv, bi);
  } else {
    for (int i = i0 + tid; i < i1; i += DPP_THREADS)
      argmax_merge(bv, bi, d2b[i], i);
  }
  // ends in a __syncthreads: the tile's column writes are visible below
  block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
  if (tid == 0) {
    atomicMax(&keys[(size_t)(t + 1) * B + b], pack_key(s_mx, s_am));
    if (!stop) {
      if (full) {
        for (int q = 0; q < w - 1; ++q) win[q] = win[q + 1];
        win[w - 1] = -1;
      }
      win[pos] = j;
    }
  }
  __syncthreads();
  const int pn = p ^ 1;
  if (!stop) {
    float* co = cand + (((size_t)pn * B + b) * nt + blk) * w;
    for (int r = tid; r < w; r += DPP_THREADS)
      co[r] = Cb[(size_t)r * M + s_am];
    float* wo = wcol + ((size_t)pn * B + b) * ww;
    for (int q = tid; q < w * w; q += DPP_THREADS) {
      const int r = q / w, m = win[q % w];
      if (m >= i0 && m < i1) wo[q] = Cb[(size_t)r * M + m];
    }
  }
  if (blk == 0)
    for (int s = tid; s < w; s += DPP_THREADS)
      win_g[((size_t)pn * B + b) * w + s] = win[s];
}

// ---------------------------------------------------------------------------
// The shard-local update entries of K3 / K4 (the candidate-sharded path).
//
// Replace src/repro/kernels/dpp_greedy/tiled.py::tiled_update_exact and
// ::tiled_update_windowed, which run _pass_full / _pass_windowed through
// _sweep on one column shard of a candidate-sharded greedy step
// (repro.core.sharded).  There the step's winner comes from outside:
// the cross-shard argmax picks it and the shard that owns it broadcasts
// its columns, so a shard that does not own it never holds them.  These
// entries therefore take the winner's global id j and its columns (V[:,j]
// and its Cholesky column; windowed, its post-eviction column, the
// repaired sqrt gain and the eviction's Givens pairs, derived on every
// rank from the replicated window factor) as arguments, stage them in
// shared memory, and run K3's / K4's per-column code (cols_exact /
// cols_windowed) over the shard's tile with column ids offset by the
// shard's base, so only the owner (base <= j < base + M) masks its
// column to -inf.  Each block folds its tile's (max, lowest global
// index) into the shard's key with one atomicMax; the caller exchanges
// the shards' keys.  The same bound and design notes as
// K3 / K4 above (one read of the shard's V and live state, one write of
// row t or the ring a step, device-memory bandwidth bound); warp 0 of
// the windowed entry takes no columns, as in K4, but has no eviction
// to derive.  Two kernels of their own, so K3 / K4 stay as they are.
//
// Each lane b reads its own step counter t[b] (the continuous-batching
// router's lanes sit at different depths; the whole slate and the stream
// pass one value for every lane): it appends Cholesky row t[b] (exact)
// or ring row min(t[b], w - 1) (windowed) and reads rows [0, t[b]) of
// its winner's column.  An exact lane whose counter has reached the
// state's k rows is stopped (it writes no row).  The shard keys hold two
// rows a lane, used in turn: step t reads row t & 1 (on the host,
// before the launch), the block of tile 0 zeroes that row and every
// block folds into row (t + 1) & 1, which the step before zeroed.  So a
// lane runs any number of steps, and a lane admitted again at t = 0
// needs only its two keys reset.
// ---------------------------------------------------------------------------

// Exact update on a shard: V (B, D, M), C (B, k, M) (row t[b] written),
// d2 (B, M) updated in place; vj (B, D), cj (B, k) (rows [0, t[b])
// read), dj (B,), stopped (B,) bool, j (B,) global winner ids, t (B,)
// step counters; keys (2, B) u64, row (t[b] + 1) & 1 zero.
__global__ void __launch_bounds__(DPP_THREADS, 2)
tiled_update_exact_kernel(const float* __restrict__ V, float* __restrict__ C,
                          float* __restrict__ d2,
                          const float* __restrict__ vj_g,
                          const float* __restrict__ cj_g,
                          const float* __restrict__ dj_g,
                          const unsigned char* __restrict__ stopped,
                          const int* __restrict__ j_g,
                          const int* __restrict__ t_g,
                          unsigned long long* __restrict__ keys, int B, int D,
                          int M, int k, int base, int tile_m) {
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
  const int t = t_g[b];
  const bool stop = stopped[b] != 0 || t >= k;
  const int j = j_g[b];

  float bv = -INFINITY;
  int bi = INT_MAX;
  if (!stop) {
    for (int d = tid; d < D; d += DPP_THREADS) vj[d] = vj_g[(size_t)b * D + d];
    for (int r = tid; r < t; r += DPP_THREADS) cj[r] = cj_g[(size_t)b * k + r];
    __syncthreads();
    cols_exact<4, LoadStreaming>(Vb + i0, M, Cb + i0, M, d2b + i0, i1 - i0,
                                 base + i0, D, t, vj, cj, dj_g[b], j, bv, bi);
  } else {
    for (int i = i0 + tid; i < i1; i += DPP_THREADS)
      argmax_merge(bv, bi, d2b[i], base + i);
  }
  block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
  if (tid == 0) {
    if (blockIdx.x == 0) keys[(size_t)(t & 1) * B + b] = 0ull;
    atomicMax(&keys[(size_t)((t + 1) & 1) * B + b], pack_key(s_mx, s_am));
  }
}

// Windowed update on a shard: evict with the given Givens pairs
// cs / sn (B, w-1) where full[b], then append e against the
// post-eviction ring at row pos = min(t[b], w - 1).  C (B, w, M) ring,
// d2 (B, M) updated in place; vj (B, D), cjp (B, w) the winner's
// post-eviction column, djp (B,) its repaired sqrt gain; stopped, full
// (B,) bool; j (B,) global winner ids; t (B,) and keys as the exact
// entry.
__global__ void __launch_bounds__(DPP_THREADS, 2)
tiled_update_windowed_kernel(const float* __restrict__ V,
                             float* __restrict__ C, float* __restrict__ d2,
                             const float* __restrict__ vj_g,
                             const float* __restrict__ cjp_g,
                             const float* __restrict__ djp_g,
                             const unsigned char* __restrict__ stopped,
                             const unsigned char* __restrict__ full_g,
                             const float* __restrict__ cs_g,
                             const float* __restrict__ sn_g,
                             const int* __restrict__ j_g,
                             const int* __restrict__ t_g,
                             unsigned long long* __restrict__ keys, int B,
                             int D, int M, int w, int base, int tile_m) {
  extern __shared__ float sm[];
  float* vj = sm;                  // D
  float* cjp = vj + D;             // w
  float* cs = cjp + w;             // w (w-1 used)
  float* sn = cs + w;              // w (w-1 used)
  float* redv = sn + w;            // 32
  int* redi = (int*)(redv + 32);   // 32
  __shared__ float s_mx;
  __shared__ int s_am;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * tile_m;
  const int i1 = min(i0 + tile_m, M);
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * w * M;
  float* d2b = d2 + (size_t)b * M;
  const int t = t_g[b];
  const int pos = min(t, w - 1);
  const bool stop = stopped[b] != 0;
  const bool full = full_g[b] != 0;
  const int j = j_g[b];

  float bv = -INFINITY;
  int bi = INT_MAX;
  if (!stop) {
    for (int d = tid; d < D; d += DPP_THREADS) vj[d] = vj_g[(size_t)b * D + d];
    for (int r = tid; r < w; r += DPP_THREADS) cjp[r] = cjp_g[(size_t)b * w + r];
    for (int r = tid; r < w - 1; r += DPP_THREADS) {
      cs[r] = cs_g[(size_t)b * (w - 1) + r];
      sn[r] = sn_g[(size_t)b * (w - 1) + r];
    }
    __syncthreads();
    const float djp = djp_g[b];
    auto ready = [&]() { return djp; };
    cols_windowed<5, LoadStreaming>(Vb + i0, M, Cb + i0, M, d2b + i0,
                                    i1 - i0, base + i0, D, w, full, pos, cs,
                                    sn, vj, cjp, ready, j, bv, bi);
  } else {
    for (int i = i0 + tid; i < i1; i += DPP_THREADS)
      argmax_merge(bv, bi, d2b[i], base + i);
  }
  block_argmax(bv, bi, redv, redi, &s_mx, &s_am);
  if (tid == 0) {
    if (blockIdx.x == 0) keys[(size_t)(t & 1) * B + b] = 0ull;
    atomicMax(&keys[(size_t)((t + 1) & 1) * B + b], pack_key(s_mx, s_am));
  }
}

// Host entry points: plain C interface for ctypes.  Each returns a
// cudaError_t (0 = success); the caller raises on anything else.
// tiled_set_smem raises the dynamic shared-memory limit of one kernel
// (0: K3, 1: K4, 2: the exact update entry, 3: the windowed one) to
// smem bytes, once per size; the launches assume it.
extern "C" int tiled_set_smem(int which, int smem) {
  const void* fns[] = {(const void*)tiled_step_exact_kernel,
                       (const void*)tiled_step_windowed_kernel,
                       (const void*)tiled_update_exact_kernel,
                       (const void*)tiled_update_windowed_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      fns[which], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" int tiled_step_exact(const float* V, float* C, float* d2,
                                unsigned long long* keys, int* flags,
                                int* sel, float* dh, int B, int D, int M,
                                int k, int t, int tile_m, float eps2, int smem,
                                void* stream) {
  dim3 grid((M + tile_m - 1) / tile_m, B);
  tiled_step_exact_kernel<<<grid, DPP_THREADS, smem, (cudaStream_t)stream>>>(
      V, C, d2, keys, flags, sel, dh, B, D, M, k, t, tile_m, eps2);
  return (int)cudaGetLastError();
}

extern "C" int tiled_step_windowed(const float* V, float* C, float* d2,
                                   unsigned long long* keys, int* flags,
                                   int* sel, float* dh, int* win, float* cand,
                                   float* wcol, int B, int D, int M, int w,
                                   int k, int t, int tile_m, float eps2,
                                   int smem, void* stream) {
  dim3 grid((M + tile_m - 1) / tile_m, B);
  tiled_step_windowed_kernel<<<grid, DPP_THREADS, smem,
                               (cudaStream_t)stream>>>(
      V, C, d2, keys, flags, sel, dh, win, cand, wcol, B, D, M, w, k, t,
      tile_m, eps2);
  return (int)cudaGetLastError();
}

extern "C" int tiled_update_exact(const float* V, float* C, float* d2,
                                  const float* vj, const float* cj,
                                  const float* dj,
                                  const unsigned char* stopped, const int* j,
                                  const int* t, unsigned long long* keys,
                                  int B, int D, int M, int k, int base,
                                  int tile_m, int smem, void* stream) {
  dim3 grid((M + tile_m - 1) / tile_m, B);
  tiled_update_exact_kernel<<<grid, DPP_THREADS, smem,
                              (cudaStream_t)stream>>>(
      V, C, d2, vj, cj, dj, stopped, j, t, keys, B, D, M, k, base, tile_m);
  return (int)cudaGetLastError();
}

extern "C" int tiled_update_windowed(
    const float* V, float* C, float* d2, const float* vj, const float* cjp,
    const float* djp, const unsigned char* stopped, const unsigned char* full,
    const float* cs, const float* sn, const int* j, const int* t,
    unsigned long long* keys, int B, int D, int M, int w, int base,
    int tile_m, int smem, void* stream) {
  dim3 grid((M + tile_m - 1) / tile_m, B);
  tiled_update_windowed_kernel<<<grid, DPP_THREADS, smem,
                                 (cudaStream_t)stream>>>(
      V, C, d2, vj, cjp, djp, stopped, full, cs, sn, j, t, keys, B, D, M, w,
      base, tile_m);
  return (int)cudaGetLastError();
}
