// Device helpers shared by the resident (dpp_greedy.cu), tiled
// (tiled.cu) and fused-chunk (chunk.cu) greedy DPP kernels.
//
// The per-column update of one greedy step is written once here and
// used by both kernel families, with explicitly rounded intrinsics
// (__fmaf_rn, __fdiv_rn, ...) so the compiler cannot contract or
// reorder it differently in the two: a resident and a tiled run of the
// same inputs compute bit-identical gains and pick identical slates.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#define DPP_THREADS 256
#define DPP_WARPS (DPP_THREADS / 32)

// (value, index) argmax merge with the lowest-index tie rule of
// jnp.argmax / torch.argmax.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmax of each thread's (v, i).  Every thread must call it;
// the result lands in *out_v / *out_i (shared) and is visible to all
// threads on return.  redv / redi hold DPP_WARPS entries.
__device__ __forceinline__ void block_argmax(float v, int i, float* redv,
                                             int* redi, float* out_v,
                                             int* out_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
  if (lane == 0) {
    redv[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < DPP_WARPS ? redv[lane] : -INFINITY;
    i = lane < DPP_WARPS ? redi[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, v, off);
      int oi = __shfl_down_sync(0xffffffffu, i, off);
      argmax_merge(v, i, ov, oi);
    }
    if (lane == 0) {
      *out_v = v;
      *out_i = i;
    }
  }
  __syncthreads();
}

// One Givens rotation of a (row, u) pair, as the in-place downdate sweep
// of repro.core.windowed computes it.
__device__ __forceinline__ void givens(float c, float s, float row, float u,
                                       float& new_row, float& new_u) {
  new_row = __fadd_rn(__fmul_rn(c, row), __fmul_rn(s, u));
  new_u = __fsub_rn(__fmul_rn(c, u), __fmul_rn(s, row));
}

// The windowed eviction's small per-user state, run by one whole warp
// (every lane calls it): from the (w, w) window factor Cw (Cw[r*w+s] =
// C[r, win[s]]) and the winner's pre-eviction column cj, derive the w-1
// Givens pairs (cs, sn) of the first-row downdate with the
// eviction_coeffs recurrence, the winner's post-eviction column cjp and
// its repaired gain *d2j.  These are the values the in-place sweep of
// repro.core.windowed computes: at iteration r it reads row r+1 before
// any rotation wrote it, and the same givens() runs on the same
// operands.  Not full: no eviction, cjp = cj over the live rows.  uw (w)
// is scratch.  Shared by the resident (K2) and fused-chunk (K6) kernels
// so both derive identical bits.
__device__ __forceinline__ void evict_coeffs_warp(
    int lane, int w, bool full, int live, const float* Cw, const float* cj,
    float dj2, float* uw, float* cs, float* sn, float* cjp, float* d2j) {
  if (full) {
    for (int s = lane; s < w; s += 32) uw[s] = Cw[s];
    float uc = cj[0];
    __syncwarp();
    for (int r = 0; r < w - 1; ++r) {
      const float a = Cw[(r + 1) * w + (r + 1)];
      const float bb = uw[r + 1];
      const float rho = fmaxf(
          __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(bb, bb))), 1e-30f);
      const float c = __fdiv_rn(a, rho), s_ = __fdiv_rn(bb, rho);
      __syncwarp();
      for (int s = lane; s < w; s += 32) {
        float unused;
        givens(c, s_, Cw[(r + 1) * w + s], uw[s], unused, uw[s]);
      }
      if (lane == 0) {
        cs[r] = c;
        sn[r] = s_;
        givens(c, s_, cj[r + 1], uc, cjp[r], uc);
      }
      __syncwarp();
    }
    if (lane == 0) {
      cjp[w - 1] = 0.f;
      *d2j = __fmaf_rn(uc, uc, dj2);
    }
  } else {
    for (int r = lane; r < live; r += 32) cjp[r] = cj[r];
    if (lane == 0) *d2j = dj2;
  }
}

// Exact step, column i: e = (V[:,j]^T V[:,i] - C[:t,j]^T C[:t,i]) / d_j,
// C[t,i] = e, returns the updated gain (-inf for the winner j).  Rows
// >= t of C are zero in Algorithm 1, so the dot stops at t.
__device__ __forceinline__ float col_exact(const float* __restrict__ Vb,
                                           float* __restrict__ Cb, int M,
                                           int D, int t,
                                           const float* vj, const float* cj,
                                           float dj, int i, int j,
                                           float d2v) {
  float lj = 0.f;
  for (int d = 0; d < D; ++d)
    lj = __fmaf_rn(vj[d], Vb[(size_t)d * M + i], lj);
  float dots = 0.f;
  for (int r = 0; r < t; ++r)
    dots = __fmaf_rn(cj[r], Cb[(size_t)r * M + i], dots);
  const float e = __fdiv_rn(__fsub_rn(lj, dots), dj);
  Cb[(size_t)t * M + i] = e;
  return i == j ? -INFINITY : __fmaf_rn(-e, e, d2v);
}

// Windowed step, column i: when the ring is full, rotate the column by
// the w-1 precomputed Givens pairs (cs, sn) in place (row r <- row r+1)
// and repair its gain by the residue u^2; then append the winner's row
// e at ring row pos against the post-eviction rows [0, pos).
__device__ __forceinline__ float col_windowed(
    const float* __restrict__ Vb, float* __restrict__ Cb, int M, int D, int w,
    bool full, int pos, const float* cs, const float* sn, const float* vj,
    const float* cjp, float djp, int i, int j, float d2v) {
  if (full) {
    float u = Cb[i];
    for (int r = 0; r < w - 1; ++r) {
      float nr;
      givens(cs[r], sn[r], Cb[(size_t)(r + 1) * M + i], u, nr, u);
      Cb[(size_t)r * M + i] = nr;
    }
    Cb[(size_t)(w - 1) * M + i] = 0.f;
    d2v = __fmaf_rn(u, u, d2v);
  }
  float lj = 0.f;
  for (int d = 0; d < D; ++d)
    lj = __fmaf_rn(vj[d], Vb[(size_t)d * M + i], lj);
  float dots = 0.f;
  for (int r = 0; r < pos; ++r)
    dots = __fmaf_rn(cjp[r], Cb[(size_t)r * M + i], dots);
  const float e = __fdiv_rn(__fsub_rn(lj, dots), djp);
  Cb[(size_t)pos * M + i] = e;
  return i == j ? -INFINITY : __fmaf_rn(-e, e, d2v);
}

// Orderable 64-bit argmax key: the float's bits mapped so that unsigned
// order is float order, over the inverted index, so one atomicMax keeps
// the largest gain and, among equal gains, the lowest index.
__device__ __forceinline__ unsigned long long pack_key(float v, int i) {
  const unsigned int u = __float_as_uint(v);
  const unsigned int ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned int)i);
}

__device__ __forceinline__ void unpack_key(unsigned long long key, float& v,
                                           int& i) {
  const unsigned int ord = (unsigned int)(key >> 32);
  const unsigned int u = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  v = __uint_as_float(u);
  i = (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}
