// Device helpers shared by the resident (dpp_greedy.cu), tiled
// (tiled.cu) and fused-chunk (chunk.cu) greedy DPP kernels.
//
// The per-column update of one greedy step is written here and used by
// every kernel family, with explicitly rounded intrinsics (__fmaf_rn,
// __fdiv_rn, ...) so the compiler cannot contract or reorder it
// differently in two kernels: a resident, a tiled and a chunked run of
// the same inputs compute bit-identical gains and pick identical
// slates.  Each update exists twice, one column at a time (col_exact,
// K1; col_windowed, K2) and several columns per thread with their loads
// in flight (cols_exact, K3 and K5; cols_windowed, K4 and K6), with the
// same arithmetic per column.
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

// evict_coeffs_warp with the residue row in registers, for w <= 32:
// lane s holds uw[s], and iteration r takes uw[r + 1] from its lane by
// a shuffle instead of a shared-memory round trip and two __syncwarp.
// The same operations on the same operands in the same order, so the
// same bits (K4, K6; K2 keeps evict_coeffs_warp).  uw is not touched.
__device__ __forceinline__ void evict_coeffs_warp_reg(
    int lane, int w, bool full, int live, const float* Cw, const float* cj,
    float dj2, float* cs, float* sn, float* cjp, float* d2j) {
  if (full) {
    float uw = lane < w ? Cw[lane] : 0.f;
    float uc = cj[0];
    for (int r = 0; r < w - 1; ++r) {
      const float a = Cw[(r + 1) * w + (r + 1)];
      const float cw = lane < w ? Cw[(r + 1) * w + lane] : 0.f;
      const float bb = __shfl_sync(0xffffffffu, uw, r + 1);
      const float rho = fmaxf(
          __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(bb, bb))), 1e-30f);
      const float c = __fdiv_rn(a, rho), s_ = __fdiv_rn(bb, rho);
      float unused;
      givens(c, s_, cw, uw, unused, uw);
      if (lane == 0) {
        cs[r] = c;
        sn[r] = s_;
        givens(c, s_, cj[r + 1], uc, cjp[r], uc);
      }
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

// ---------------------------------------------------------------------------
// The windowed step over a whole tile, several columns per thread with
// their loads in flight (K4, K6).
//
// col_windowed above runs one column at a time: one dependent FMA chain
// over D whose every iteration waits on its own load of V, then w - 1
// rotations that each read and write a ring row.  So a thread has about
// one load in flight, far below what device memory needs to stream.
// cols_windowed computes the same bits for NC columns of a thread at
// once, issuing the loads of COLS_DU rows of V (COLS_RB rows of the
// ring) for all of them before the arithmetic that uses them.  Per
// column nothing changes: the same givens() for r = 0..w-2 in order, the
// d2 repair by u^2, one __fmaf_rn chain over d = 0..D-1 and one over the
// post-eviction rows [0, pos), then the same __fdiv_rn.  The dots chain
// runs while the rotations produce the rows it reads (when the ring is
// full, pos = w - 1 is the number of rotated rows), and col_windowed's
// zeroing of row w - 1 is left out because the append then writes that
// row.
//
// Warp 0 takes no columns: it derives the step's eviction (the Givens
// pairs, cjp and d2j, evict_coeffs_warp) inside ready(), while the other
// warps run the V dot products of their first columns, which do not
// depend on it; ready() ends in a block barrier and returns the
// repaired d_j, after which the ring part runs.
// ---------------------------------------------------------------------------

#define COLS_DU 8  // rows of V loaded ahead
#define COLS_RB 4  // rows of the ring (exact: of C) loaded ahead
#define COLS_WORKERS (DPP_THREADS - 32)  // warps 1.. take the columns

// Where V comes from: device memory, read once per step, with the
// evict-first hint so the stream does not push the ring (exact: the
// live rows of C) and d2 out of L2 (LoadStreaming); or shared memory
// (LoadPlain).
struct LoadStreaming {
  __device__ __forceinline__ float operator()(const float* p) const {
    return __ldcs(p);
  }
};
struct LoadPlain {
  __device__ __forceinline__ float operator()(const float* p) const {
    return *p;
  }
};

// The windowed step over the n columns x = 0..n-1 of one tile, whose
// global ids are i0 + x: V row d of column x at Vt[d * vs + x], ring
// row r at Rt[r * rs + x] (updated in place), the gain at d2t[x]
// (updated; the winner j gets -inf).  Folds the new gains into this
// thread's (bv, bi) argmax.  Every thread of the block calls it; ready()
// is called once by every thread (see above) and returns djp; cs / sn /
// cjp (as in col_windowed) are read only after it.
template <int NC, typename VLoad, typename Ready>
__device__ __forceinline__ void cols_windowed(
    const float* __restrict__ Vt, size_t vs, float* __restrict__ Rt,
    size_t rs, float* __restrict__ d2t, int n, int i0, int D, int w,
    bool full, int pos, const float* cs, const float* sn, const float* vj,
    const float* cjp, Ready ready, int j, float& bv, int& bi) {
  const VLoad vld{};
  const int span = NC * COLS_WORKERS;
  const int groups = n > span ? (n + span - 1) / span : 1;
  const int me = (int)threadIdx.x - 32;  // < 0: warp 0, no columns
  float djp = 0.f;
  for (int g = 0; g < groups; ++g) {
    int x[NC];
    bool ok[NC];
    float d2v[NC], u[NC], dots[NC], lj[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x[c] = g * span + me + c * COLS_WORKERS;
      ok[c] = me >= 0 && x[c] < n;
      d2v[c] = ok[c] ? d2t[x[c]] : 0.f;
      u[c] = (full && ok[c]) ? Rt[x[c]] : 0.f;
      dots[c] = 0.f;
      lj[c] = 0.f;
    }
    const bool any = ok[0];  // x[0] is the thread's lowest column
    // L_j row: V^T v_j, d ascending
    if (any) {
      int d = 0;
      for (; d + COLS_DU <= D; d += COLS_DU) {
        float v[COLS_DU][NC];
#pragma unroll
        for (int q = 0; q < COLS_DU; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            v[q][c] = ok[c] ? vld(Vt + (size_t)(d + q) * vs + x[c]) : 0.f;
#pragma unroll
        for (int q = 0; q < COLS_DU; ++q) {
          const float a = vj[d + q];
#pragma unroll
          for (int c = 0; c < NC; ++c) lj[c] = __fmaf_rn(a, v[q][c], lj[c]);
        }
      }
      for (; d < D; ++d) {
        float v[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          v[c] = ok[c] ? vld(Vt + (size_t)d * vs + x[c]) : 0.f;
        const float a = vj[d];
#pragma unroll
        for (int c = 0; c < NC; ++c) lj[c] = __fmaf_rn(a, v[c], lj[c]);
      }
    }
    if (g == 0) djp = ready();
    if (!any) continue;
    // ring: full, row r <- givens(row r+1, u) for r = 0..w-2 (pos = w-1
    // of them); not full, rows [0, pos) as they are; either way dotted
    // with cjp in row order
    const int src = full ? 1 : 0;
    for (int r0 = 0; r0 < pos; r0 += COLS_RB) {
      float row[COLS_RB][NC];
#pragma unroll
      for (int q = 0; q < COLS_RB; ++q)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          row[q][c] = (r0 + q < pos && ok[c])
                          ? Rt[(size_t)(r0 + q + src) * rs + x[c]]
                          : 0.f;
#pragma unroll
      for (int q = 0; q < COLS_RB; ++q) {
        const int r = r0 + q;
        if (r < pos) {
          if (full) {
            const float cr = cs[r], sr = sn[r];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              float nr;
              givens(cr, sr, row[q][c], u[c], nr, u[c]);
              row[q][c] = nr;
              if (ok[c]) Rt[(size_t)r * rs + x[c]] = nr;
            }
          }
          const float a = cjp[r];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            dots[c] = __fmaf_rn(a, row[q][c], dots[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!ok[c]) continue;
      if (full) d2v[c] = __fmaf_rn(u[c], u[c], d2v[c]);
      const float e = __fdiv_rn(__fsub_rn(lj[c], dots[c]), djp);
      Rt[(size_t)pos * rs + x[c]] = e;
      const int i = i0 + x[c];
      const float g2 = i == j ? -INFINITY : __fmaf_rn(-e, e, d2v[c]);
      d2t[x[c]] = g2;
      argmax_merge(bv, bi, g2, i);
    }
  }
}

// ---------------------------------------------------------------------------
// The exact step over a whole tile, several columns per thread with their
// loads in flight (K3, K5).
//
// col_exact runs one column at a time: one dependent FMA chain over D
// whose every iteration waits on its own load of V, then one over the t
// rows of C that does the same, so a thread has about one load in
// flight.  cols_exact computes the same bits for NC columns of a thread
// at once: it issues the loads of COLS_DU rows of V for all of them
// ahead of the FMAs that use them, then of COLS_RB rows of C ahead of
// the dots chain, then the division and the gain.  Per column nothing
// changes: one __fmaf_rn chain over d = 0..D-1 and one over
// r = 0..t-1, both ascending, the same __fdiv_rn(__fsub_rn(lj, dots),
// dj), the same __fmaf_rn(-e, e, d2) and -inf for the winner.  There is
// no eviction to derive, so every warp takes columns.
// ---------------------------------------------------------------------------

// The exact step t over the n columns x = 0..n-1 of one tile, whose
// global ids are i0 + x: V row d of column x at Vt[d * vs + x] (read
// with VLoad), Cholesky row r at Ct[r * cs + x] (rows [0, t) read, row
// t written), the gain at d2t[x] (updated; the winner j gets -inf).
// vj / cj / dj are the winner's staged columns and sqrt gain.  Folds the
// new gains into this thread's (bv, bi) argmax; no barrier inside.
template <int NC, typename VLoad>
__device__ __forceinline__ void cols_exact(
    const float* __restrict__ Vt, size_t vs, float* __restrict__ Ct,
    size_t cs, float* __restrict__ d2t, int n, int i0, int D, int t,
    const float* vj, const float* cj, float dj, int j, float& bv, int& bi) {
  const VLoad vld{};
  const int span = NC * DPP_THREADS;
  for (int g0 = 0; g0 < n; g0 += span) {
    int x[NC];
    bool ok[NC];
    float d2v[NC], lj[NC], dots[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x[c] = g0 + (int)threadIdx.x + c * DPP_THREADS;
      ok[c] = x[c] < n;
      d2v[c] = ok[c] ? d2t[x[c]] : 0.f;
      lj[c] = 0.f;
      dots[c] = 0.f;
    }
    if (!ok[0]) break;  // x[0] is the thread's lowest column
    // L_j row: V^T v_j, d ascending
    int d = 0;
    for (; d + COLS_DU <= D; d += COLS_DU) {
      float v[COLS_DU][NC];
#pragma unroll
      for (int q = 0; q < COLS_DU; ++q)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          v[q][c] = ok[c] ? vld(Vt + (size_t)(d + q) * vs + x[c]) : 0.f;
#pragma unroll
      for (int q = 0; q < COLS_DU; ++q) {
        const float a = vj[d + q];
#pragma unroll
        for (int c = 0; c < NC; ++c) lj[c] = __fmaf_rn(a, v[q][c], lj[c]);
      }
    }
    for (; d < D; ++d) {
      float v[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        v[c] = ok[c] ? vld(Vt + (size_t)d * vs + x[c]) : 0.f;
      const float a = vj[d];
#pragma unroll
      for (int c = 0; c < NC; ++c) lj[c] = __fmaf_rn(a, v[c], lj[c]);
    }
    // <c_j, c_i> over the rows [0, t), r ascending
    for (int r0 = 0; r0 < t; r0 += COLS_RB) {
      float row[COLS_RB][NC];
#pragma unroll
      for (int q = 0; q < COLS_RB; ++q)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          row[q][c] = (r0 + q < t && ok[c])
                          ? Ct[(size_t)(r0 + q) * cs + x[c]]
                          : 0.f;
#pragma unroll
      for (int q = 0; q < COLS_RB; ++q) {
        if (r0 + q < t) {
          const float a = cj[r0 + q];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            dots[c] = __fmaf_rn(a, row[q][c], dots[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!ok[c]) continue;
      const float e = __fdiv_rn(__fsub_rn(lj[c], dots[c]), dj);
      Ct[(size_t)t * cs + x[c]] = e;
      const int i = i0 + x[c];
      const float g2 = i == j ? -INFINITY : __fmaf_rn(-e, e, d2v[c]);
      d2t[x[c]] = g2;
      argmax_merge(bv, bi, g2, i);
    }
  }
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
