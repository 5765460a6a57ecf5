// Resident whole-slate greedy DPP MAP kernels (K1 exact, K2 windowed).
//
// Replace the Pallas TPU kernels src/repro/kernels/dpp_greedy/
// dpp_greedy.py::_kernel (K1) and ::_kernel_windowed (K2), launched by
// dpp_greedy_kernel.  One launch runs every user's whole k-step greedy
// loop, for the whole batch at once.
//
// What bounds it on an H100: each step reads the user's V (D x M) and
// the live Cholesky rows once for two GEMVs, 2 (D + t) M FP32 FLOPs,
// then takes an argmax over all M candidates.  Streamed from L2 or device
// memory that is a few FLOPs a byte, far from the FP32 roof; what is left
// once V sits on the chip is the latency of each step's dependent FMA
// chains and of the argmax's barrier.
//
// Design: each user is one thread-block cluster of s CTAs (s = 1, 2, 4
// or 8, tiling.resident_cluster's choice), launched non-cooperatively
// (cudaLaunchKernelEx with a cluster dimension; clusters need not all
// be co-resident, so no batch size is refused).  CTA r owns the
// contiguous slice [r * tile, (r + 1) * tile) of the user's candidates
// for the whole slate and keeps its gains d2 there in shared memory and,
// where they fit, its (D, tile) slice of V (VRES) and its slice of the
// greedy state (K1's Cholesky rows with CRES, K2's ring with ring_res),
// V loaded once by cp.async.  Otherwise V streams from device memory
// every step with the evict-first hint, and the state lives in device
// memory.  The per-column update is common.cuh's cols_exact /
// cols_windowed (several columns a thread, loads in flight), the same
// arithmetic as the tiled (K3, K4) and fused-chunk (K5, K6) kernels, so
// all six give the same bits.  The argmax is folded into that column
// pass; then block_argmax, then cluster_argmax: each CTA's key in its own
// shared memory, one hardware cluster barrier, every CTA reads the s
// keys through DSMEM and decodes the same winner with the lowest-index
// tie rule.  That is the step's only cluster barrier.  The winner's
// columns are read from their owner's shared memory through DSMEM where
// they live there (V is read-only; the state's rows < t are not written
// again).  Every CTA decodes the same winner, so every CTA stops at the
// same eps-stop step; rank 0 writes sel / d_hist.  Every CTA passes one
// more cluster barrier before it exits, so that none leaves while a
// peer still reads its shared memory.
//
// Shared memory of one CTA, in floats, in the order carved below (the
// layout tiling.cluster_smem_bytes counts; tile = round_up(ceil(M / s),
// 4)): the header (CLUSTER_HDR: two u64 argmax keys, the warps'
// reduction scratch, the block argmax and the repaired gain), d2
// (tile), [the state slice, resident: K1's Cholesky rows (k, tile), K2's
// ring (w, tile)], [VRES: the V slice (D, tile)], the winner's V column
// (D); exact: its Cholesky column (k); windowed: cj, cjp, the (w, w)
// window factor, uw, cs, sn and the ring ids (w each but the factor)
// and, when s > 1, the published exchange buffers pcand (2, w) and
// pwcol (2, w, w).
#include "common.cuh"

// Header floats: keys (2 x u64 = 4), redv (8), redi (8), block argmax
// value and index, the repaired gain, one pad: a multiple of 4, so the
// slices after it stay 16-byte aligned for cp.async.
#define CLUSTER_HDR 24

struct ClusterHeader {
  unsigned long long* keys;
  float* redv;
  int* redi;
  float* mx;
  int* am;
  float* d2j;
};

__device__ __forceinline__ ClusterHeader carve_header(float* sm) {
  ClusterHeader h;
  h.keys = (unsigned long long*)sm;
  h.redv = sm + 4;
  h.redi = (int*)(h.redv + DPP_WARPS);
  h.mx = (float*)(h.redi + DPP_WARPS);
  h.am = (int*)(h.mx + 1);
  h.d2j = (float*)(h.am + 1);
  return h;
}

// The initial cluster argmax over the CTA's staged gains d2 (columns
// [i0, i0 + n)).
__device__ __forceinline__ void first_winner(const ClusterHeader& h,
                                             const float* d2, int n, int i0,
                                             unsigned int s, float& dj2,
                                             int& j) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int x = threadIdx.x; x < n; x += DPP_THREADS)
    argmax_merge(bv, bi, d2[x], i0 + x);
  block_argmax(bv, bi, h.redv, h.redi, h.mx, h.am);
  cluster_argmax(h.keys, 0, s, *h.mx, *h.am, dj2, j);
}

// Eps-stop (eq. 20): the state stops changing, so every later step would
// stop again; the tail [t, k) holds -1 / 0, written by rank 0.
__device__ __forceinline__ void write_tail(int* sel, float* dh, int t,
                                           int k) {
  for (int q = t + threadIdx.x; q < k; q += DPP_THREADS) {
    sel[q] = -1;
    dh[q] = 0.f;
  }
}

// K1: exact Algorithm 1.  V (B, D, M), d2_init (B, M) with masked
// candidates at -inf, sel / dh (B, k).  The Cholesky rows (k, M), row t
// written at step t by each column's owner, live slice by slice in each
// CTA's shared memory for the whole slate with CRES, else in C (B, k, M)
// in device memory (L2 at the default shortlist).  Either way the
// winner's column C[:t, j] is read from its owner's copy at later steps:
// through DSMEM, or with __ldcg, and the cluster barrier that ends each
// step (release, then acquire, at cluster scope) orders the owner's
// writes of row t before those reads.
template <bool VRES, bool CRES>
__global__ void __launch_bounds__(DPP_THREADS, 2)
dpp_resident_exact_kernel(const float* __restrict__ V,
                          const float* __restrict__ d2_init,
                          float* __restrict__ C, int* __restrict__ sel,
                          float* __restrict__ dh, int D, int M, int k,
                          int tile, float eps2) {
  extern __shared__ __align__(16) float sm[];
  const ClusterHeader h = carve_header(sm);
  float* d2 = sm + CLUSTER_HDR;                  // tile  the slice's gains
  float* Cs = d2 + tile;                         // k*tile  with CRES
  float* Vs = Cs + (CRES ? (size_t)k * tile : 0);  // D*tile  with VRES
  float* vj = Vs + (VRES ? (size_t)D * tile : 0);  // D  winner's V column
  float* cj = vj + D;                            // k  winner's C column

  const unsigned int s = cluster_ctas(), rank = cluster_rank();
  const int b = blockIdx.x / s, tid = threadIdx.x;
  const int i0 = (int)rank * tile;
  const int n = max(min(i0 + tile, M) - i0, 0);
  const float* Vb = V + (size_t)b * D * M;
  // the slice's Cholesky rows: row r of column x at Ct[r * cs + x]
  float* Cb = CRES ? nullptr : C + (size_t)b * k * M;
  float* Ct = CRES ? Cs : Cb + i0;
  const size_t cs = CRES ? (size_t)tile : (size_t)M;
  int* selb = sel + (size_t)b * k;
  float* dhb = dh + (size_t)b * k;

  stage_async(d2, 0, d2_init + (size_t)b * M + i0, 0, 1, n);
  if (VRES) stage_async(Vs, tile, Vb + i0, M, D, n);
  cp_async_wait_all();
  __syncthreads();
  float dj2;
  int j;
  first_winner(h, d2, n, i0, s, dj2, j);

  for (int t = 0;; ++t) {
    if (dj2 <= eps2) {
      if (rank == 0) write_tail(selb, dhb, t, k);
      break;
    }
    const float dj = __fsqrt_rn(fmaxf(dj2, eps2));
    if (rank == 0 && tid == 0) {
      selb[t] = j;
      dhb[t] = dj;
    }
    if (t == k - 1) break;
    const unsigned int owner = (unsigned int)(j / tile);
    if (VRES) {
      const float* vo = cluster_peer(Vs, owner) + (j - (int)owner * tile);
      for (int d = tid; d < D; d += DPP_THREADS) vj[d] = vo[(size_t)d * tile];
    } else {
      for (int d = tid; d < D; d += DPP_THREADS)
        vj[d] = __ldg(&Vb[(size_t)d * M + j]);
    }
    if (CRES) {
      const float* co = cluster_peer(Cs, owner) + (j - (int)owner * tile);
      for (int r = tid; r < t; r += DPP_THREADS) cj[r] = co[(size_t)r * tile];
    } else {
      for (int r = tid; r < t; r += DPP_THREADS)
        cj[r] = __ldcg(&Cb[(size_t)r * M + j]);
    }
    __syncthreads();
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (VRES)
      cols_exact<2, LoadPlain>(Vs, tile, Ct, cs, d2, n, i0, D, t, vj, cj,
                               dj, j, bv, bi);
    else
      cols_exact<4, LoadStreaming>(Vb + i0, M, Ct, cs, d2, n, i0, D, t, vj,
                                   cj, dj, j, bv, bi);
    block_argmax(bv, bi, h.redv, h.redi, h.mx, h.am);
    cluster_argmax(h.keys, (t + 1) & 1, s, *h.mx, *h.am, dj2, j);
  }
  cluster_sync();  // no CTA leaves while a peer reads its shared memory
}

// K2: sliding window of w picks.  The ring (w, M) in window order (row
// 0 = oldest pick) lives, slice by slice, in each CTA's shared memory for
// the whole slate (ring_res), else in C (B, w, M) in device memory, each
// CTA working its own columns in place.  Per step, as in K6: every CTA
// gathers the winner's pre-eviction column cj and, when the ring is
// full, the (w, w) window factor C[:, win]; warp 0 derives the w-1 Givens
// pairs of the first-row downdate, the winner's post-eviction column cjp
// and its repaired gain (evict_coeffs_warp_reg, or evict_coeffs_warp for
// w > 32), the values the in-place sweep of repro.core.windowed computes;
// then every CTA rotates, repairs and appends its columns.  With s > 1
// the columns a CTA needs from its peers change during their own step,
// so before the step's barrier each CTA publishes into step-parity
// buffers in its own shared memory its candidate's ring column (pcand)
// and the window-factor entries of the ring members it owns (pwcol), and
// after the barrier every CTA gathers them through DSMEM (K6 publishes
// the same data through device memory).  A CTA running ahead writes the
// other parity, and writes this one again only after the next barrier,
// so one barrier a step is enough.  With s = 1 the CTA reads its own ring
// directly.  The ring is never written back: the wrapper returns only
// the slate.  One CTA an SM is the launch bound: with V and the ring
// resident a CTA takes most of an SM's shared memory anyway, and at two
// the compiler spilled to stay within 128 registers.
template <bool VRES>
__global__ void __launch_bounds__(DPP_THREADS, 1)
dpp_resident_windowed_kernel(const float* __restrict__ V,
                             const float* __restrict__ d2_init,
                             float* __restrict__ C, int* __restrict__ sel,
                             float* __restrict__ dh, int D, int M, int k,
                             int w, int tile, int ring_res, float eps2) {
  extern __shared__ __align__(16) float sm[];
  const ClusterHeader h = carve_header(sm);
  float* d2 = sm + CLUSTER_HDR;                      // tile
  float* ring = d2 + tile;                           // w*tile, ring_res
  float* Vs = ring + (ring_res ? (size_t)w * tile : 0);  // D*tile, VRES
  float* vj = Vs + (VRES ? (size_t)D * tile : 0);    // D
  float* cj = vj + D;               // w    pre-eviction winner column
  float* cjp = cj + w;              // w    post-eviction winner column
  float* Cw = cjp + w;              // w*w  window factor, Cw[r*w+s]
  float* uw = Cw + w * w;           // w    residue row on the window
  float* cs = uw + w;               // w    cos (w-1 used)
  float* sn = cs + w;               // w    sin (w-1 used)
  int* win = (int*)(sn + w);        // w    ring ids, -1 = empty
  float* pcand = (float*)(win + w);  // 2*w    published, s > 1
  float* pwcol = pcand + 2 * w;     // 2*w*w  published, s > 1

  const unsigned int s = cluster_ctas(), rank = cluster_rank();
  const bool solo = s == 1;
  const int b = blockIdx.x / s, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i0 = (int)rank * tile;
  const int n = max(min(i0 + tile, M) - i0, 0);
  const size_t ww = (size_t)w * w;
  const float* Vb = V + (size_t)b * D * M;
  // the ring slice: row r of column x at Rt[r * rs + x]
  float* Rt = ring_res ? ring : C + (size_t)b * w * M + i0;
  const size_t rs = ring_res ? (size_t)tile : (size_t)M;
  int* selb = sel + (size_t)b * k;
  float* dhb = dh + (size_t)b * k;

  for (int q = tid; q < w; q += DPP_THREADS) win[q] = -1;
  stage_async(d2, 0, d2_init + (size_t)b * M + i0, 0, 1, n);
  if (VRES) stage_async(Vs, tile, Vb + i0, M, D, n);
  cp_async_wait_all();
  __syncthreads();
  float dj2;
  int j;
  first_winner(h, d2, n, i0, s, dj2, j);

  for (int t = 0;; ++t) {
    const int p = t & 1;
    if (dj2 <= eps2) {
      if (rank == 0) write_tail(selb, dhb, t, k);
      break;
    }
    if (rank == 0 && tid == 0) {
      selb[t] = j;
      dhb[t] = __fsqrt_rn(fmaxf(dj2, eps2));
    }
    if (t == k - 1) break;
    const bool full = t >= w;
    const int pos = t < w - 1 ? t : w - 1;
    // rows >= min(t, w) of the ring are not yet written: the not-full
    // path only reads rows < pos, the full path only full rows
    const int live = t < w ? t : w;
    const unsigned int owner = (unsigned int)(j / tile);
    if (VRES) {
      const float* vo = cluster_peer(Vs, owner) + (j - (int)owner * tile);
      for (int d = tid; d < D; d += DPP_THREADS) vj[d] = vo[(size_t)d * tile];
    } else {
      for (int d = tid; d < D; d += DPP_THREADS)
        vj[d] = __ldg(&Vb[(size_t)d * M + j]);
    }
    if (solo) {
      for (int r = tid; r < live; r += DPP_THREADS)
        cj[r] = Rt[(size_t)r * rs + j];
      if (full)
        for (int q = tid; q < w * w; q += DPP_THREADS)
          Cw[q] = Rt[(size_t)(q / w) * rs + win[q % w]];
    } else {
      const float* cb = cluster_peer(pcand, owner) + (size_t)p * w;
      for (int r = tid; r < live; r += DPP_THREADS) cj[r] = cb[r];
      if (full)
        for (int q = tid; q < w * w; q += DPP_THREADS)
          Cw[q] = cluster_peer(pwcol, (unsigned int)(win[q % w] / tile))
              [(size_t)p * ww + q];
    }
    __syncthreads();
    auto ready = [&]() {
      if (warp == 0 && w <= 32)
        evict_coeffs_warp_reg(lane, w, full, live, Cw, cj, dj2, cs, sn, cjp,
                              h.d2j);
      else if (warp == 0)
        evict_coeffs_warp(lane, w, full, live, Cw, cj, dj2, uw, cs, sn, cjp,
                          h.d2j);
      __syncthreads();
      return __fsqrt_rn(fmaxf(*h.d2j, eps2));
    };
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (VRES)
      cols_windowed<3, LoadPlain>(Vs, tile, Rt, rs, d2, n, i0, D, w, full,
                                  pos, cs, sn, vj, cjp, ready, j, bv, bi);
    else
      cols_windowed<5, LoadStreaming>(Vb + i0, M, Rt, rs, d2, n, i0, D, w,
                                      full, pos, cs, sn, vj, cjp, ready, j,
                                      bv, bi);
    // ends in a __syncthreads: the ring writes are visible to the publish
    block_argmax(bv, bi, h.redv, h.redi, h.mx, h.am);
    if (tid == 0) {
      if (full) {
        for (int q = 0; q < w - 1; ++q) win[q] = win[q + 1];
        win[w - 1] = -1;
      }
      win[pos] = j;
    }
    __syncthreads();
    if (!solo) {
      // the next step's gather data, from this CTA's ring after the step
      const int q1 = p ^ 1;
      if (n > 0)
        for (int r = tid; r < w; r += DPP_THREADS)
          pcand[(size_t)q1 * w + r] = Rt[(size_t)r * rs + (*h.am - i0)];
      for (int q = tid; q < w * w; q += DPP_THREADS) {
        const int m = win[q % w];
        if (m >= i0 && m < i0 + n)
          pwcol[(size_t)q1 * ww + q] = Rt[(size_t)(q / w) * rs + (m - i0)];
      }
    }
    // the barrier inside orders the publish before the peers' gather
    cluster_argmax(h.keys, p ^ 1, s, *h.mx, *h.am, dj2, j);
  }
  cluster_sync();  // no CTA leaves while a peer reads its shared memory
}

// ---------------------------------------------------------------------------
// Host entry points: plain C interface for ctypes.  Each returns a
// cudaError_t (0 = success); the caller raises on anything else.  `which`
// names one kernel instantiation: 2 * windowed + vres, plus 4 for K1 with
// its Cholesky rows resident.
// ---------------------------------------------------------------------------

static const void* resident_kernel(int which) {
  switch (which) {
    case 0: return (const void*)dpp_resident_exact_kernel<false, false>;
    case 1: return (const void*)dpp_resident_exact_kernel<true, false>;
    case 2: return (const void*)dpp_resident_windowed_kernel<false>;
    case 3: return (const void*)dpp_resident_windowed_kernel<true>;
    case 4: return (const void*)dpp_resident_exact_kernel<false, true>;
    default: return (const void*)dpp_resident_exact_kernel<true, true>;
  }
}

// Raise the dynamic shared-memory limit of kernel `which` to smem bytes,
// once per size; the launches assume it.
extern "C" int dpp_resident_set_smem(int which, int smem) {
  return (int)cudaFuncSetAttribute(
      resident_kernel(which), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
}

static cudaLaunchConfig_t cluster_config(int clusters, int s, int smem,
                                         void* stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(clusters * s));
  cfg.blockDim = dim3(DPP_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of s CTAs of kernel `which`, at smem bytes of dynamic shared
// memory each, that the current device can hold at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot place one).  The caller
// has raised the kernel's shared-memory limit to smem.  An error of the
// query itself is returned and cleared.
extern "C" int dpp_resident_capacity(int which, int s, int smem,
                                     int* clusters) {
  *clusters = 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, s, smem, nullptr, attr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      clusters, resident_kernel(which), &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" int dpp_resident_exact(const float* V, const float* d2_init,
                                  float* C, int* sel, float* dh, int B, int D,
                                  int M, int k, int s, int tile, int vres,
                                  int cres, float eps2, int smem,
                                  void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(B, s, smem, stream, attr);
  auto fn = vres ? (cres ? dpp_resident_exact_kernel<true, true>
                         : dpp_resident_exact_kernel<true, false>)
                 : (cres ? dpp_resident_exact_kernel<false, true>
                         : dpp_resident_exact_kernel<false, false>);
  return (int)cudaLaunchKernelEx(&cfg, fn, V, d2_init, C, sel, dh, D, M, k,
                                 tile, eps2);
}

extern "C" int dpp_resident_windowed(const float* V, const float* d2_init,
                                     float* C, int* sel, float* dh, int B,
                                     int D, int M, int k, int w, int s,
                                     int tile, int vres, int ring_res,
                                     float eps2, int smem, void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(B, s, smem, stream, attr);
  if (vres)
    return (int)cudaLaunchKernelEx(&cfg, dpp_resident_windowed_kernel<true>,
                                   V, d2_init, C, sel, dh, D, M, k, w, tile,
                                   ring_res, eps2);
  return (int)cudaLaunchKernelEx(&cfg, dpp_resident_windowed_kernel<false>,
                                 V, d2_init, C, sel, dh, D, M, k, w, tile,
                                 ring_res, eps2);
}
