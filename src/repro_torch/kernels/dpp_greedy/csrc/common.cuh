// Device helpers shared by the resident (dpp_greedy.cu), tiled
// (tiled.cu) and fused-chunk (chunk.cu) greedy DPP kernels.
//
// The per-column update of one greedy step is written here once and used
// by every kernel family, with explicitly rounded intrinsics (__fmaf_rn,
// __fdiv_rn, ...) so the compiler cannot contract or reorder it
// differently in two kernels: a resident, a tiled and a chunked run of
// the same inputs compute bit-identical gains and pick identical
// slates.  cols_exact (K1, K3, K5) and cols_windowed (K2, K4, K6) run
// several columns per thread with their loads in flight.
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
// is scratch.  Used for w > 32 by the resident (K2), tiled (K4) and
// fused-chunk (K6) kernels, so all derive identical bits.
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
// same bits (K2, K4, K6 for w <= 32).  uw is not touched.
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

// ---------------------------------------------------------------------------
// The windowed step over a whole tile, several columns per thread with
// their loads in flight (K2, K4, K6).
//
// Per column: when the ring is full, rotate the column by the w-1
// Givens pairs (cs, sn) of the step's eviction (row r <- row r+1,
// givens() for r = 0..w-2 in order) and repair its gain by the residue
// u^2; then append the winner's row e = (V[:,j]^T V[:,i] - cjp^T c_i) /
// djp at ring row pos (one __fmaf_rn chain over d = 0..D-1, one over the
// post-eviction rows [0, pos), one __fdiv_rn).  A thread takes NC
// columns at once and issues the loads of COLS_DU rows of V (COLS_RB
// rows of the ring) for all of them before the arithmetic that uses
// them, so it keeps many loads in flight.  The dots chain runs while
// the rotations produce the rows it reads (when the ring is full,
// pos = w - 1 is the number of rotated rows).
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
// is called once by every thread (see above) and returns djp, the
// winner's repaired sqrt gain; cs / sn (the Givens pairs) and cjp (the
// winner's post-eviction column) are read only after it.
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
// loads in flight (K1, K3, K5).
//
// Per column i: e = (V[:,j]^T V[:,i] - C[:t,j]^T C[:t,i]) / d_j (one
// __fmaf_rn chain over d = 0..D-1 and one over r = 0..t-1, both
// ascending; rows >= t of C are zero in Algorithm 1, so the dot stops
// at t), C[t,i] = e, and the gain __fmaf_rn(-e, e, d2), -inf for the
// winner j.  A thread takes NC columns at once: it issues the loads of
// COLS_DU rows of V for all of them ahead of the FMAs that use them,
// then of COLS_RB rows of C ahead of the dots chain.  There is no
// eviction to derive, so every warp takes columns.
// ---------------------------------------------------------------------------

// The exact step t over the n columns x = 0..n-1 of one tile, whose
// global ids are i0 + x: V row d of column x at Vt[d * vs + x] (read
// with VLoad), Cholesky row r at Ct[r * cs + x] (rows [0, t) read, row
// t written), the gain at d2t[x] (updated; the winner j gets -inf).
// vj / cj / dj are the winner's staged columns and sqrt gain (cj with
// the t rows of C at column j).  Folds the
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

// Copy rows [0, rows) x columns [0, n) from device memory (row stride
// gs) to shared memory (row stride ss) with cp.async: every copy of the
// thread is in flight at once, none through registers; 16 bytes a copy
// where both sides' rows start 16-byte aligned, else 4.  The caller
// waits with cp_async_wait_all() and a __syncthreads.
__device__ __forceinline__ void stage_async(float* dst, size_t ss,
                                            const float* src, size_t gs,
                                            int rows, int n) {
  const bool wide = ((uintptr_t)src & 15) == 0 && (gs & 3) == 0 &&
                    (__cvta_generic_to_shared(dst) & 15) == 0 &&
                    (ss & 3) == 0;
  const int n4 = wide ? n / 4 : 0;
  for (int r = 0; r < rows; ++r) {
    float* d = dst + (size_t)r * ss;
    const float* g = src + (size_t)r * gs;
    for (int q = threadIdx.x; q < n4; q += DPP_THREADS) {
      const unsigned int a = (unsigned int)__cvta_generic_to_shared(d + 4 * q);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                   "l"(g + 4 * q));
    }
    for (int x = 4 * n4 + threadIdx.x; x < n; x += DPP_THREADS) {
      const unsigned int a = (unsigned int)__cvta_generic_to_shared(d + x);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
                   "l"(g + x));
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// ---------------------------------------------------------------------------
// Thread-block clusters (K1, K2): the CTAs of one cluster run on
// neighbouring SMs, read each other's shared memory (DSMEM) and meet at
// a hardware barrier.
// ---------------------------------------------------------------------------

// This CTA's rank in its cluster, and the cluster's CTA count.
__device__ __forceinline__ unsigned int cluster_rank() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned int cluster_ctas() {
  unsigned int n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// Barrier of every thread of every CTA of the cluster.  The arrive has
// release and the wait acquire semantics at cluster scope, so every
// write a thread of the cluster made before it (to its own shared
// memory, or to device memory) is visible to every thread of the
// cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The generic address of the shared-memory object at p (an address in
// this CTA's shared memory) in the shared memory of CTA `rank` of the
// cluster; an ordinary load through it reads that CTA's copy (DSMEM).
template <typename T>
__device__ __forceinline__ T* cluster_peer(T* p, unsigned int rank) {
  T* out;
  asm("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return out;
}

// The argmax of the whole cluster, with jnp.argmax's lowest-index tie
// rule.  Thread 0 stores this CTA's block argmax (v, i) as a pack_key
// into slot[p] of its own shared memory (two slots, p the step parity);
// one cluster barrier; then every thread reads slot[p] of each of the n
// CTAs through DSMEM and decodes the largest key, so every thread of
// every CTA gets the same (*ov, *oi).  Every thread must call it.  The
// parity slots make one barrier a step enough: a CTA that runs ahead
// writes slot[p ^ 1] next, and writes slot[p] again only after the next
// barrier, which no CTA passes before every CTA has read slot[p].
__device__ __forceinline__ void cluster_argmax(unsigned long long* slot,
                                               int p, unsigned int n,
                                               float v, int i, float& ov,
                                               int& oi) {
  if (threadIdx.x == 0) slot[p] = pack_key(v, i);
  cluster_sync();
  unsigned long long best = 0;
  for (unsigned int r = 0; r < n; ++r) {
    const unsigned long long key = *cluster_peer(slot + p, r);
    best = key > best ? key : best;
  }
  unpack_key(best, ov, oi);
}
