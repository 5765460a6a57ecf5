// Fused factorization-machine second-order term (K8) and its gradient.
//
// The forward replaces the Pallas TPU kernel src/repro/kernels/
// fm_interaction/fm_interaction.py::_kernel, launched by
// fm_interaction_kernel: per example n of emb (N, F, D),
//
//     y_n = 0.5 * sum_d [ (sum_f v_nfd)^2 - sum_f v_nfd^2 ]
//
// accumulated in f32 (bf16 input widened on load, as the Pallas body
// does).  The backward replaces no Pallas kernel: repro differentiates
// its jnp fm_second_order (src/repro/models/recsys.py:108) with jax.grad.
// Per element of emb,
//
//     grad_nfd = g_n * (s_nd - v_nfd),   s_nd = sum_f v_nfd  (f ascending)
//
// computed in f32 and rounded once to emb's type.
//
// What bounds them on an H100: every input value is read once and used
// for two or three FLOPs, so both are bound by device memory over
// 3.35 TB/s: the forward by N * F * D * sizeof(T) + 4 * N bytes (0.478 ms
// for DeepFM's 39 x 10 f32 embeddings of 1,024,000 scored rows, 0.0306 ms
// at its train batch of 65,536), the backward by 2 * N * F * D *
// sizeof(T) + 4 * N (0.0611 ms at the train batch).
//
// Design (both kernels; the plan is fm_interaction.py::fm_plan, which the
// wrapper, the tests and the static checks read).
// * A persistent grid.  A tile is T consecutive examples, one contiguous
//   span of T * F * D * sizeof(T) bytes.  The grid is min(tiles, the
//   blocks the card keeps co-resident at the plan's shared memory), and
//   block b walks tiles b, b + gridDim.x, ... so the fill and drain of a
//   grid of short blocks are paid once, not once a block.  Where the
//   tiles take several rounds of the grid, the plan shortens T (to no
//   less than half) so the last round is nearly full: at DeepFM's train
//   batch a block walks 13 or 14 tiles of 18 f32 examples, not 12 or 13
//   of 20.
// * A ring of S stages in shared memory, fed by bulk copies.  Thread 0
//   copies a tile's 16-byte-aligned interior with one
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes
//   into its stage, on the stage's mbarrier armed by expect_tx, and keeps
//   the block's next S - 1 tiles in flight while the block sums the
//   current one: with the plan's three stages of about 31 KB and two
//   blocks of 512 threads an SM, some 125 KB a SM are in flight, where
//   the earlier design (a scalar copy, then the sums, four blocks an SM)
//   kept a few KB.  (One block an SM with four 46 KB stages, or more
//   stages of less, was no faster on an H100: PERF.md.)  A stage is
//   released by a block barrier: every thread's reads of it
//   (and its plain writes, below) are ordered before the async proxy by
//   fence.proxy.async, then __syncthreads, then thread 0 issues the copy
//   of the tile S ahead into it.  Stages hold the input in its own type,
//   so a bf16 stage holds twice the examples of an f32 one.
// * Alignment.  T is a multiple of 16 / gcd(F * D * sizeof(T), 16) (where
//   a stage holds that many), so a tile of a 16-byte-aligned emb starts
//   aligned.  A view that starts off
//   16 bytes (emb[1:] at 1,560 bytes an f32 example) and the ragged last
//   tile leave at most 15 bytes at each end of a span outside the bulk
//   copy: those elements are loaded plainly into the stage by the
//   threads before the block's barrier.  Element 0 of a tile sits at
//   byte (its address & 15) of the stage, so the bulk destination is
//   16-byte aligned too.  A plan with S = 0 (an example too long for one
//   stage beside the rest) reads every element plainly from device
//   memory through the same code.
// * The sums keep the earlier kernel's order, so its outputs are equal
//   bit for bit: per (example, d) pair `s += x; sq = fmaf(x, x, sq)` over
//   f ascending, then fmaf(s, s, -sq); per example the D terms in d
//   ascending, times 0.5f.  Consecutive threads take consecutive (example,
//   d) pairs, so at F = 39, D = 10 a warp reads words 390 n + d + 10 f of
//   a stage: at most 2-way bank conflicts.  The pairs' terms go to one of
//   two small shared arrays (alternating tiles, so a tile's sums never
//   wait on the last tile's readers), and the block's last threads, idle
//   in the pair loop where T * D is below the block, sum each example's
//   terms and write the tile's T outputs, consecutive threads on
//   consecutive outputs.  A stage is read with shared-memory loads: the
//   pair loop is inlined once with a stage's pointer and once with device
//   memory's (S = 0).
// * The backward reads the same ring.  Per tile, s goes into a small
//   shared array (the same pair loop, f ascending) and g's T values are
//   read once into shared memory; then each thread reads 16 bytes of the
//   stage (4 f32 or 8 bf16 elements) and writes their gradient as one
//   16-byte store from registers (the at most 15 bytes at each end of the
//   tile's span that are not 16-byte aligned by plain stores, and the
//   stage's elements by plain loads where a view's offset leaves them
//   off 16 bytes).  The (example, d) of an element comes from a
//   multiply-high by reciprocals the wrapper computes (fast_div), once a
//   vector, then stepped: no element divides by a runtime value.
// * The wrapper queries the co-resident blocks and raises the kernels'
//   shared-memory limit once a card and size (cuda.raise_smem), not before
//   every launch.  A copy that does not land within 10 s traps rather
//   than hanging the card.
//
// Dynamic shared memory (fm_plan's smem_bytes):
//   [FM_HEADER: S mbarriers, where S > 0][S stages of stage_bytes]
//   [aux: 2 * T * D floats (the forward's two term arrays; the backward's
//    s, then g's T values)]
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#define FM_MAX_THREADS 1024  // a block's threads: the plan's, at most this
#define FM_MAX_STAGES 8
#define FM_HEADER 64  // FM_MAX_STAGES mbarriers
#define FM_TIMEOUT_NS 10000000000ull

typedef unsigned long long u64;

// The plan of one launch (fm_plan), passed by value.
struct FMArgs {
  int N, F, D;
  int T;            // examples a tile
  int S;            // ring stages (0: plain loads from device memory)
  int stage_bytes;  // a stage: T * F * D * sizeof(T) rounded to 16, + 16
  unsigned per_mul, per_shr;  // fast_div by F * D
  unsigned d_mul, d_shr;      // fast_div by D
};

// x / dv for 0 <= x < 2^31 without a division: the multiply-high by the
// reciprocal fm_interaction.py::divmod_magic computes (CUTLASS's
// FastDivmod).
__device__ __forceinline__ int fast_div(int x, int dv, unsigned mul,
                                        unsigned shr) {
  return dv == 1 ? x : (int)(__umulhi((unsigned)x, mul) >> shr);
}

__device__ __forceinline__ float fm_load(const float* p) { return *p; }
__device__ __forceinline__ float fm_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void fm_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fm_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// 16 bytes of emb widened into registers: 4 f32 or 8 bf16 values.
__device__ __forceinline__ void fm_load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void fm_load16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
    x[2 * k] = __low2float(h);
    x[2 * k + 1] = __high2float(h);
  }
}

// 16 bytes of gradient from registers: 4 f32 or 8 bf16 values.
__device__ __forceinline__ void fm_store16(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void fm_store16(__nv_bfloat16* p, const float* r) {
  uint4 u;
  __nv_bfloat162 h;
  h = __floats2bfloat162_rn(r[0], r[1]);
  u.x = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(r[2], r[3]);
  u.y = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(r[4], r[5]);
  u.z = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(r[6], r[7]);
  u.w = *reinterpret_cast<unsigned*>(&h);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  unsigned ok;
  u64 t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (ok) return;
    if (t0 == 0) t0 = now_ns();
    else if (now_ns() - t0 > FM_TIMEOUT_NS) __trap();
  }
}

// A tile's byte span [a, b) and its 16-byte-aligned interior [lo, hi),
// the bulk copy; lo = hi = b where the span holds no aligned 16 bytes
// (fm_interaction.py::tile_copy mirrors it).
struct Span {
  uintptr_t a, b, lo, hi;
};

template <typename T>
__device__ __forceinline__ Span tile_span(const T* emb, const FMArgs& p,
                                          int n0, int nt) {
  const size_t per = (size_t)p.F * p.D;
  Span s;
  s.a = (uintptr_t)(emb + (size_t)n0 * per);
  s.b = (uintptr_t)(emb + ((size_t)n0 + nt) * per);
  const uintptr_t lo = (s.a + 15) & ~(uintptr_t)15, hi = s.b & ~(uintptr_t)15;
  s.lo = hi > lo ? lo : s.b;
  s.hi = hi > lo ? hi : s.b;
  return s;
}

__device__ __forceinline__ int tile_rows(const FMArgs& p, int t) {
  return min(p.T, p.N - t * p.T);
}

// Thread 0: tile t into stage st (local tile i of the block uses stage
// i % S, phase (i / S) & 1).
template <typename T>
__device__ __forceinline__ void fetch(const T* emb, const FMArgs& p,
                                      unsigned char* ring, u64* full, int st,
                                      int t) {
  const Span sp = tile_span(emb, p, t * p.T, tile_rows(p, t));
  u64* bar = &full[st];
  if (sp.hi > sp.lo) {
    unsigned char* dst = ring + (size_t)st * p.stage_bytes + (sp.a & 15) +
                         (sp.lo - sp.a);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"((unsigned)(sp.hi - sp.lo))
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(sp.lo), "r"((unsigned)(sp.hi - sp.lo)),
           "r"(smem_u32(bar))
        : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
  }
}

// Init the ring's barriers and issue the block's first S tiles.
template <typename T>
__device__ __forceinline__ void ring_start(const T* emb, const FMArgs& p,
                                           unsigned char* ring, u64* full,
                                           int tiles) {
  if (threadIdx.x == 0 && p.S) {
    for (int i = 0; i < p.S; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&full[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < p.S; ++i) {
      const int t = blockIdx.x + i * gridDim.x;
      if (t < tiles) fetch(emb, p, ring, full, i, t);
    }
  }
  __syncthreads();
}

// The block's local tile i (tile t) in its stage: wait for the bulk
// copy, load the ends of its span outside it plainly, and return its
// elements.
template <typename T>
__device__ __forceinline__ T* stage_in(const T* emb, const FMArgs& p,
                                       unsigned char* ring, u64* full, int i,
                                       int t) {
  const int n0 = t * p.T, nt = tile_rows(p, t);
  const int st = i % p.S;
  mbar_wait(&full[st], (unsigned)(i / p.S) & 1u);
  const Span sp = tile_span(emb, p, n0, nt);
  T* xs = reinterpret_cast<T*>(ring + (size_t)st * p.stage_bytes +
                               (sp.a & 15));
  const int head = (int)((sp.lo - sp.a) / sizeof(T));
  const int tail = (int)((sp.b - sp.hi) / sizeof(T));
  if (head + tail > 0) {  // uniform across the block
    const T* src = emb + (size_t)n0 * p.F * p.D;
    const int t0 = (int)((sp.hi - sp.a) / sizeof(T));
    for (int j = threadIdx.x; j < head + tail; j += blockDim.x) {
      const int e = j < head ? j : t0 + (j - head);
      xs[e] = src[e];
    }
    __syncthreads();
  }
  return xs;
}

// Every thread is done with local tile i's stage: hand it to the async
// proxy and have thread 0 copy the tile S ahead into it.
template <typename T>
__device__ __forceinline__ void tile_done(const T* emb, const FMArgs& p,
                                          unsigned char* ring, u64* full,
                                          int i, int t, int tiles) {
  if (p.S) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int next = t + p.S * gridDim.x;
  if (p.S && threadIdx.x == 0 && next < tiles)
    fetch(emb, p, ring, full, i % p.S, next);
}

// The forward's (example, d) terms of one tile: xs in a stage, or in
// device memory where S = 0 (each call site is inlined with the pointer's
// own address space, so a stage is read by shared-memory loads).
template <typename T>
__device__ __forceinline__ void fwd_terms(const T* xs, const FMArgs& p,
                                          int nt, float* part) {
  const int per = p.F * p.D;
  for (int q = threadIdx.x; q < nt * p.D; q += blockDim.x) {
    const int n = fast_div(q, p.D, p.d_mul, p.d_shr), d = q - n * p.D;
    const T* row = xs + n * per + d;
    float s = 0.f, sq = 0.f;
#pragma unroll 8
    for (int f = 0; f < p.F; ++f) {
      const float x = fm_load(row + f * p.D);
      s += x;
      sq = fmaf(x, x, sq);
    }
    part[q] = fmaf(s, s, -sq);
  }
}

template <typename T>
__global__ void __launch_bounds__(FM_MAX_THREADS)
fm_interaction_kernel(const T* __restrict__ emb, float* __restrict__ out,
                      FMArgs p) {
  extern __shared__ __align__(16) unsigned char sm[];
  u64* full = reinterpret_cast<u64*>(sm);
  unsigned char* ring = sm + (p.S ? FM_HEADER : 0);
  float* aux = reinterpret_cast<float*>(ring + (size_t)p.S * p.stage_bytes);
  const int tiles = (p.N + p.T - 1) / p.T;
  ring_start(emb, p, ring, full, tiles);
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int nt = tile_rows(p, t);
    float* part = aux + (i & 1) * p.T * p.D;
    if (p.S)
      fwd_terms(stage_in(emb, p, ring, full, i, t), p, nt, part);
    else
      fwd_terms(emb + (size_t)t * p.T * p.F * p.D, p, nt, part);
    tile_done(emb, p, ring, full, i, t, tiles);
    // the block's last threads, which the pair loop leaves idle where
    // nt * D < blockDim.x, sum each example's terms
    float* o = out + (size_t)t * p.T;
    for (int n = blockDim.x - 1 - threadIdx.x; n < nt; n += blockDim.x) {
      float acc = 0.f;
      for (int d = 0; d < p.D; ++d) acc += part[n * p.D + d];
      o[n] = 0.5f * acc;
    }
  }
}

// The backward of one tile (n0, nt): s and g into shared memory, then the
// gradient's tile [0, nt * F * D) of dst: the ends that are not 16-byte
// aligned by plain stores, the rest by 16-byte vectors from registers.
template <typename T>
__device__ __forceinline__ void bwd_tile(const T* xs, const float* g,
                                         T* dst, const FMArgs& p, int n0,
                                         int nt, float* s) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte store
  float* gs = s + p.T * p.D;
  const int per = p.F * p.D;
  for (int q = threadIdx.x; q < nt * p.D; q += blockDim.x) {
    const int n = fast_div(q, p.D, p.d_mul, p.d_shr), d = q - n * p.D;
    const T* row = xs + n * per + d;
    float acc = 0.f;
#pragma unroll 8
    for (int f = 0; f < p.F; ++f) acc += fm_load(row + f * p.D);
    s[q] = acc;
  }
  for (int n = blockDim.x - 1 - threadIdx.x; n < nt; n += blockDim.x)
    gs[n] = g[n0 + n];
  __syncthreads();
  const int count = nt * per;
  const int head = min(count, (int)(((16 - ((uintptr_t)dst & 15)) & 15) /
                                    sizeof(T)));
  const int nvec = (count - head) / V;
  const int t0 = head + nvec * V;
  for (int j = threadIdx.x; j < head + (count - t0); j += blockDim.x) {
    const int e = j < head ? j : t0 + (j - head);
    const int n = fast_div(e, per, p.per_mul, p.per_shr);
    const int r = e - n * per;
    const int d = r - fast_div(r, p.D, p.d_mul, p.d_shr) * p.D;
    fm_store(dst + e, gs[n] * (s[n * p.D + d] - fm_load(xs + e)));
  }
  // the vectors' elements in xs are 16-byte aligned too where emb and
  // grad start alike (always, for an aligned emb)
  const bool aligned = (((uintptr_t)(xs + head)) & 15) == 0;
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const int e = head + j * V;
    int n = fast_div(e, per, p.per_mul, p.per_shr);
    int r = e - n * per;
    int d = r - fast_div(r, p.D, p.d_mul, p.d_shr) * p.D;
    float v[V];
    if (aligned) {
      fm_load16(xs + e, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = fm_load(xs + e + k);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = gs[n] * (s[n * p.D + d] - v[k]);
      if (++d == p.D) d = 0;
      if (++r == per) {
        r = 0;
        ++n;
      }
    }
    fm_store16(dst + e, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(FM_MAX_THREADS)
fm_interaction_bwd_kernel(const T* __restrict__ emb,
                          const float* __restrict__ g, T* __restrict__ grad,
                          FMArgs p) {
  extern __shared__ __align__(16) unsigned char sm[];
  u64* full = reinterpret_cast<u64*>(sm);
  unsigned char* ring = sm + (p.S ? FM_HEADER : 0);
  float* s = reinterpret_cast<float*>(ring + (size_t)p.S * p.stage_bytes);
  const int tiles = (p.N + p.T - 1) / p.T;
  ring_start(emb, p, ring, full, tiles);
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int n0 = t * p.T, nt = tile_rows(p, t);
    const size_t e0 = (size_t)n0 * p.F * p.D;
    if (p.S)
      bwd_tile(stage_in(emb, p, ring, full, i, t), g, grad + e0, p, n0, nt,
               s);
    else
      bwd_tile(emb + e0, g, grad + e0, p, n0, nt, s);
    tile_done(emb, p, ring, full, i, t, tiles);
  }
}

// Kernel `which`: 0 forward f32, 1 forward bf16, 2 backward f32,
// 3 backward bf16.
static const void* kernel_of(int which) {
  switch (which) {
    case 0: return (const void*)fm_interaction_kernel<float>;
    case 1: return (const void*)fm_interaction_kernel<__nv_bfloat16>;
    case 2: return (const void*)fm_interaction_bwd_kernel<float>;
    default: return (const void*)fm_interaction_bwd_kernel<__nv_bfloat16>;
  }
}

// Let kernel `which` take `smem` bytes of dynamic shared memory
// (cuda.raise_smem calls it once a card and size).
extern "C" int fm_interaction_set_smem(int which, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel_of(which), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Blocks of kernel `which` of `threads` threads the current device keeps
// co-resident at `smem` bytes of dynamic shared memory a block (its limit
// already raised to at least `smem`).
extern "C" int fm_interaction_capacity(int which, int threads, int smem,
                                       int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(which), threads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return 0;
}

// One launch as the wrapper plans it (fm_interaction.py::_launch_args).
struct FMLaunch {
  FMArgs p;
  int grid, threads, smem;
};

// Kernel `which` over emb (N, F, D) float32 or bfloat16 on `grid` blocks
// of `threads` threads, the plan's tiles: the forward writes out (N,)
// float32 (g unused); the backward reads g (N,) float32 and writes out,
// the gradient (N, F, D) in emb's type.  The plan's numbers (fm_plan)
// and the reciprocals of F * D and D (divmod_magic) come from the
// wrapper.
extern "C" int fm_interaction_launch(int which, const void* emb,
                                     const float* g, void* out,
                                     const FMLaunch* a, void* stream) {
  const FMArgs& p = a->p;
  const int grid = a->grid, threads = a->threads, smem = a->smem;
  cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case 0:
      fm_interaction_kernel<float><<<grid, threads, smem, st>>>(
          (const float*)emb, (float*)out, p);
      break;
    case 1:
      fm_interaction_kernel<__nv_bfloat16><<<grid, threads, smem, st>>>(
          (const __nv_bfloat16*)emb, (float*)out, p);
      break;
    case 2:
      fm_interaction_bwd_kernel<float><<<grid, threads, smem, st>>>(
          (const float*)emb, g, (float*)out, p);
      break;
    default:
      fm_interaction_bwd_kernel<__nv_bfloat16>
          <<<grid, threads, smem, st>>>(
              (const __nv_bfloat16*)emb, g, (__nv_bfloat16*)out, p);
  }
  return (int)cudaGetLastError();
}
