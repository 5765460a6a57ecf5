// Resident whole-slate greedy DPP MAP kernels (K1 exact, K2 windowed).
//
// Replace the Pallas TPU kernels src/repro/kernels/dpp_greedy/
// dpp_greedy.py::_kernel (K1) and ::_kernel_windowed (K2), launched by
// dpp_greedy_kernel.  One thread block per user runs the user's whole
// k-step greedy loop in a single launch, for the whole batch at once.
//
// What bounds it on an H100: each step streams the user's V (D x M) and
// the live Cholesky rows through the SM to form two GEMVs, then a
// block-wide argmax; 2 (D + t) M FP32 FLOPs per step against the same
// number of bytes, so it is bound by the bytes each SM can pull from L2
// and by the per-step barrier latency, far from the FP32 roof.  At the
// default shortlist (C = 1000, D = 100, B = 64) all users' V (26 MB) sits
// in the 50 MB L2, so device memory is read about once.
//
// Design: the gains d2 (M floats) live in dynamic shared memory for the
// whole loop (the resident budget of tiling.py is exactly this carve-up),
// so the argmax never touches device memory; the winner's V column and
// Cholesky column are staged into shared memory once per step and then
// read by every thread; each thread owns a strided set of columns and
// reads V and C coalesced along M.  FP32 FMA on CUDA cores, no tensor
// cores: a (1 x D) x (D x M) GEMV has nothing for them to amortise.
// Later work: clusters with DSMEM to hold V on chip, more blocks per
// user when B is small.
#include "common.cuh"

// K1: exact Algorithm 1.  C (B, k, M) row layout (row t written at step
// t), d2_init (B, M) with masked candidates at -inf.
__global__ void __launch_bounds__(DPP_THREADS)
dpp_resident_exact_kernel(const float* __restrict__ V,
                          const float* __restrict__ d2_init,
                          float* __restrict__ C, int* __restrict__ sel,
                          float* __restrict__ dh, int D, int M, int k,
                          float eps2) {
  extern __shared__ float sm[];
  float* d2 = sm;                       // M
  float* vj = d2 + M;                   // D
  float* cj = vj + D;                   // k
  float* redv = cj + k;                 // DPP_WARPS (32 reserved)
  int* redi = (int*)(redv + 32);        // DPP_WARPS (32 reserved)
  __shared__ float s_mx;
  __shared__ int s_j;

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * k * M;
  for (int i = tid; i < M; i += DPP_THREADS) d2[i] = d2_init[(size_t)b * M + i];
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < M; i += DPP_THREADS) argmax_merge(bv, bi, d2[i], i);
    block_argmax(bv, bi, redv, redi, &s_mx, &s_j);
    const int j = s_j;
    const float dj2 = s_mx;
    // eps-stop (eq. 20): the state stops changing, so every later step
    // would stop again; the tail holds -1 / 0
    if (dj2 <= eps2) {
      for (int s = t + tid; s < k; s += DPP_THREADS) {
        sel[(size_t)b * k + s] = -1;
        dh[(size_t)b * k + s] = 0.f;
      }
      return;
    }
    const float dj = __fsqrt_rn(fmaxf(dj2, eps2));
    if (tid == 0) {
      sel[(size_t)b * k + t] = j;
      dh[(size_t)b * k + t] = dj;
    }
    for (int d = tid; d < D; d += DPP_THREADS) vj[d] = Vb[(size_t)d * M + j];
    for (int r = tid; r < t; r += DPP_THREADS) cj[r] = Cb[(size_t)r * M + j];
    __syncthreads();
    for (int i = tid; i < M; i += DPP_THREADS)
      d2[i] = col_exact(Vb, Cb, M, D, t, vj, cj, dj, i, j, d2[i]);
    __syncthreads();
  }
}

// K2: sliding window of w picks.  C (B, w, M) ring in window order
// (row 0 = oldest pick).  Per step: argmax, then one warp derives the
// w-1 Givens pairs of the first-row downdate from the (w, w) window
// factor C[:, win] with the eviction_coeffs recurrence, the winner's
// post-eviction column cjp and its repaired gain d2j.  Those are the
// values the in-place sweep of repro.core.windowed computes: at sweep
// iteration r it reads row r+1 before any rotation wrote it, and the
// warp applies the same givens() to the same operands, so the
// coefficients are bit-equal to what the sweep derives column by column.
// Then every thread rotates its columns, repairs d2 by u^2 and appends.
__global__ void __launch_bounds__(DPP_THREADS)
dpp_resident_windowed_kernel(const float* __restrict__ V,
                             const float* __restrict__ d2_init,
                             float* __restrict__ C, int* __restrict__ sel,
                             float* __restrict__ dh, int D, int M, int k,
                             int w, float eps2) {
  extern __shared__ float sm[];
  float* d2 = sm;                       // M
  float* vj = d2 + M;                   // D
  float* cj = vj + D;                   // w   pre-eviction winner column
  float* cjp = cj + w;                  // w   post-eviction winner column
  float* Cw = cjp + w;                  // w*w window factor, Cw[r*w+s]
  float* uw = Cw + w * w;               // w   residue row on the window
  float* cs = uw + w;                   // w   cos (w-1 used)
  float* sn = cs + w;                   // w   sin (w-1 used)
  int* win = (int*)(sn + w);            // w   ring ids, -1 = empty
  float* redv = (float*)(win + w);      // 32
  int* redi = (int*)(redv + 32);        // 32
  __shared__ float s_mx, s_d2j;
  __shared__ int s_j;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* Vb = V + (size_t)b * D * M;
  float* Cb = C + (size_t)b * w * M;
  for (int i = tid; i < M; i += DPP_THREADS) d2[i] = d2_init[(size_t)b * M + i];
  for (int s = tid; s < w; s += DPP_THREADS) win[s] = -1;
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < M; i += DPP_THREADS) argmax_merge(bv, bi, d2[i], i);
    block_argmax(bv, bi, redv, redi, &s_mx, &s_j);
    const int j = s_j;
    const float dj2 = s_mx;
    if (dj2 <= eps2) {
      for (int s = t + tid; s < k; s += DPP_THREADS) {
        sel[(size_t)b * k + s] = -1;
        dh[(size_t)b * k + s] = 0.f;
      }
      return;
    }
    if (tid == 0) {
      sel[(size_t)b * k + t] = j;
      dh[(size_t)b * k + t] = __fsqrt_rn(fmaxf(dj2, eps2));
    }
    const bool full = t >= w;
    const int pos = t < w - 1 ? t : w - 1;
    // rows >= min(t, w) of the ring are not yet written: the not-full
    // path only reads rows < pos, the full path only full rows
    const int live = t < w ? t : w;
    for (int d = tid; d < D; d += DPP_THREADS) vj[d] = Vb[(size_t)d * M + j];
    for (int r = tid; r < live; r += DPP_THREADS) cj[r] = Cb[(size_t)r * M + j];
    if (full)
      for (int q = tid; q < w * w; q += DPP_THREADS) {
        const int r = q / w, s = q % w;
        Cw[q] = Cb[(size_t)r * M + win[s]];
      }
    __syncthreads();

    if (warp == 0)
      evict_coeffs_warp(lane, w, full, live, Cw, cj, dj2, uw, cs, sn, cjp,
                        &s_d2j);
    __syncthreads();
    const float djp = __fsqrt_rn(fmaxf(s_d2j, eps2));
    for (int i = tid; i < M; i += DPP_THREADS)
      d2[i] = col_windowed(Vb, Cb, M, D, w, full, pos, cs, sn, vj, cjp, djp,
                           i, j, d2[i]);
    __syncthreads();
    if (tid == 0) {
      if (full) {
        for (int s = 0; s < w - 1; ++s) win[s] = win[s + 1];
        win[w - 1] = -1;
      }
      win[pos] = j;
    }
    __syncthreads();
  }
}

// Host entry points: plain C interface for ctypes.  Each returns a
// cudaError_t (0 = success); the caller raises on anything else.
// dpp_resident_set_smem raises the dynamic shared-memory limit of K2
// (windowed) or K1 to smem bytes, once per size; the launches assume it.
extern "C" int dpp_resident_set_smem(int windowed, int smem) {
  const void* fn = windowed ? (const void*)dpp_resident_windowed_kernel
                            : (const void*)dpp_resident_exact_kernel;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" int dpp_resident_exact(const float* V, const float* d2_init,
                                  float* C, int* sel, float* dh, int B, int D,
                                  int M, int k, float eps2, int smem,
                                  void* stream) {
  dpp_resident_exact_kernel<<<B, DPP_THREADS, smem, (cudaStream_t)stream>>>(
      V, d2_init, C, sel, dh, D, M, k, eps2);
  return (int)cudaGetLastError();
}

extern "C" int dpp_resident_windowed(const float* V, const float* d2_init,
                                     float* C, int* sel, float* dh, int B,
                                     int D, int M, int k, int w, float eps2,
                                     int smem, void* stream) {
  dpp_resident_windowed_kernel<<<B, DPP_THREADS, smem,
                                 (cudaStream_t)stream>>>(
      V, d2_init, C, sel, dh, D, M, k, w, eps2);
  return (int)cudaGetLastError();
}
