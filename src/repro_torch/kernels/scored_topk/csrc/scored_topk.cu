// Fused candidate scoring + exact top-c per segment of rows (K7).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scored_topk/
// scored_topk.py::_kernel, launched by scored_topk_kernel (the top-c of
// each block of bm rows), and the top-c over the block survivors that
// repro's ops.py::scored_topk runs after it.  For every segment of `seg`
// consecutive rows of emb (M, D), the scores s = E . q in f32, rows at
// index >= M scored -inf, then the segment's top-c values and ids in
// (value descending, lowest index first) order, the order of
// jax.lax.top_k.  With seg = the block rows this is the Pallas kernel's
// (nb, c) survivors; with seg = M it is the global top-c, in this one
// launch.
//
// What bounds it on an H100: emb is read once and each value feeds one
// FMA, so device memory bounds it: M * D * sizeof(T) bytes over
// 3.35 TB/s (0.119 ms at M = 10^6, D = 100, f32).  Only c results a
// segment are written, never the (M,) score vector.
//
// Design.  One persistent launch of `cps` CTAs a segment (cooperative,
// so the grid is refused unless it is co-resident, when cps > 1; the
// wrapper sizes it from the card's occupancy).
// 1. Stream and score.  A segment is cut into tiles of `tile_rows` rows
//    and each CTA owns an even, contiguous run of them.  A CTA streams
//    its tiles through a ring of TK_STAGES stages in shared memory: a
//    tile is one contiguous byte range of emb, and thread 0 copies its
//    16-byte-aligned interior with one bulk copy (cp.async.bulk,
//    completing on the stage's mbarrier) into the stage freed by the
//    tile before, so TK_STAGES tiles are in flight.  The unaligned head
//    and tail of a range (bf16 rows of odd 16-byte count, a view's
//    offset, the ragged last tile) are at most 15 bytes each, taken by
//    plain loads.  Each warp scores 8 rows at a time from shared memory:
//    lane l sums x[d] * q[d] over d = l, l + 32, ... in order with FP32
//    FMAs, then a reduce-scatter of shuffles (each step keeps half the
//    rows, so 9 shuffles for 8 rows) adds the lanes in the order of a
//    full xor butterfly, the first K7's order.  The plan makes a tile 64
//    rows where it can, one group of 8 for every warp: the CTA waits for
//    its slowest warp before it refills a stage, and 40-row tiles, which
//    idled 3 of 8 warps, were slower on an H100.  Rows longer than a
//    stage holds (26 KB) are taken 64 at a time and scored the same way
//    by plain loads from device memory.  Tiles handed out on demand from
//    a segment counter balanced the CTAs but lost more to the atomics
//    than they gained (H100).
// 2. Keys.  A row's score becomes the 64-bit key
//        ordered(value) << 32 | (2^32 - 1 - global index)
//    (kernels/dpp_greedy/tiled.py::pack_key's encoding), whose unsigned
//    order is (value, then lowest index).  Keys are unique, so the top-c
//    is exact however the rows are split.  Rows at index >= M are never
//    read: they get the key of -inf at their own index, as the Pallas
//    kernel scores its zero padding.  The CTA keeps its keys in shared
//    memory (in device memory when they do not fit beside the ring) and
//    counts the first radix digit (the top bits0 bits) as it makes them.
// 3. Select across the segment.  A radix select from the top, bits0 bits
//    in round 0 (10, or 8 where a 4 KB histogram does not fit beside a
//    long q) and 8 a round after: the CTAs add their histograms' nonzero
//    bins into the segment's histogram in device memory, meet at the
//    segment's barrier (the segments share nothing, so only a segment's
//    CTAs wait), and each resolves the same digit from the sum: the bin
//    that holds the c-th key.  Three histogram buffers rotate, so one
//    barrier a round suffices: CTA 0 of the segment clears the buffer of
//    the next round during this one.  The rounds stop as soon as the
//    keys at or above the resolved bin, the candidates, number at most
//    `gather` (a power of two >= c); at shift 0 they are exactly c.  At
//    phase 12's 10^6 Gaussian scores and c = 1000, round 0's 10 bits
//    leave about c candidates, so the select ends with the histogram made
//    while scoring, where 8 bits took one more round.
// 4. Gather and place.  Each CTA counts its candidates, takes a base
//    from the segment's counter and writes them to the segment's
//    `gather` slots in device memory.  After one more barrier the top c
//    go to vals / idx.  With TK_RANK_CTAS or more CTAs a segment, every
//    CTA ranks its share of the candidates against all of them (a key's
//    rank is the number above it) and writes those of rank below c to
//    their slots, since one CTA's bitonic sort of c keys, in shared
//    memory or in registers alike, took several times as long on an H100
//    as the ranking of a few keys a CTA.  With fewer CTAs, CTA 0 sorts the
//    candidates descending, a bitonic sort in shared memory over the next
//    power of two.
// The segment's counters and histograms (TK_SCRATCH words, zero at
// launch) are left zero again: CTA 0 clears them once the others have
// left the last barrier, so the wrapper keeps one buffer and launches
// nothing else.  A barrier or copy that does not complete within 10 s
// traps rather than hanging the card.
//
// Dynamic shared memory (the wrapper's launch_plan sizes it):
//   [header 128 B: mbarriers, select state][histogram 4 << bits0 B]
//   [q as f32, D * 4 rounded to 16]
//   [region: max(ring TK_STAGES * stage + keys on chip, sort)]
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#define TK_THREADS 256
#define TK_WARPS (TK_THREADS / 32)
#define TK_ROWS 8       // rows a warp scores at once
#define TK_STAGES 3     // ring stages
#define TK_HEADER 128   // bytes
#define TK_RANK_CTAS 8  // from this many CTAs a segment, they rank its top c
#define TK_BINS 1024    // round 0's digit: the top bits0 <= 10 bits
#define TK_SCRATCH (4 + 3 * TK_BINS)  // u32 a segment: bar, count, left, -, 3 histograms
#define TK_TIMEOUT_NS 10000000000ull

typedef unsigned long long u64;

struct Header {
  u64 full[TK_STAGES];  // a stage's bulk copy has landed
  u64 prefix;           // the resolved high bits of the c-th key
  int need;             // keys still needed inside the prefix's bin
  int cand;             // keys at or above the resolved bin
  int done;
  int count;
  int base;             // this CTA's first gather slot
  int rank[8];          // ranks of the candidates being placed
};
static_assert(sizeof(Header) <= TK_HEADER, "header");

__device__ __forceinline__ float tk_load(const float* p) { return *p; }
__device__ __forceinline__ float tk_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ u64 make_key(float v, long long g) {
  const unsigned bits = __float_as_uint(v);
  const unsigned ordered = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((u64)ordered << 32) | (u64)(0xFFFFFFFFu - (unsigned)g);
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned ordered = (unsigned)(key >> 32);
  const unsigned bits =
      (ordered & 0x80000000u) ? (ordered & 0x7FFFFFFFu) : ~ordered;
  return __uint_as_float(bits);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
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
    else if (now_ns() - t0 > TK_TIMEOUT_NS) __trap();
  }
}

// Barrier of the co-resident CTAs of one segment on the segment's
// arrival counter (zero at launch), which only grows: the n-th barrier
// waits until it reaches n * (the segment's CTA count), `target`.
// Thread 0 arrives with a release add and spins on acquire loads, so the
// CTA's writes before it are visible to every CTA of the segment after
// it (kernels/dpp_greedy/csrc/chunk.cu's lane_barrier).
__device__ __forceinline__ void seg_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], 1;"
                 : "=r"(v) : "l"(ctr) : "memory");
    const u64 t0 = now_ns();
    for (++v; v < target;) {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                   : "=r"(v) : "l"(ctr) : "memory");
      if (v < target && now_ns() - t0 > TK_TIMEOUT_NS) __trap();
    }
  }
  __syncthreads();
}

// A lane's row key into keys[i] and its first digit into the CTA's
// histogram (warp-aggregated).  Every lane of the warp calls it.
__device__ __forceinline__ void emit(bool valid, float s, long long g,
                                     u64* keys, int i, unsigned* hist,
                                     int shift0, int lane) {
  unsigned digit = TK_BINS;
  if (valid) {
    const u64 key = make_key(s, g);
    keys[i] = key;
    digit = (unsigned)(key >> shift0);
  }
  const unsigned peers = __match_any_sync(0xffffffffu, digit);
  if (valid && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
}

// Score rows [0, nr) of x (row stride D; shared or device memory), rows
// g0 + i of emb, into keys[i], their digits above bit shift0 into hist;
// rows [nr, nt) lie past M and get -inf.  Warp w takes rows 8w, 8w + 64,
// ... eight at a time.
template <typename T>
__device__ __forceinline__ void score_rows(const T* x, int nr, int nt,
                                           long long g0, int D,
                                           const float* qs, u64* keys,
                                           unsigned* hist, int shift0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rg = warp * TK_ROWS; rg < nr; rg += TK_WARPS * TK_ROWS) {
    float acc[TK_ROWS];
#pragma unroll
    for (int u = 0; u < TK_ROWS; ++u) acc[u] = 0.f;
    const T* xr = x + (size_t)rg * D;
    for (int d = lane; d < D; d += 32) {
      const float qd = qs[d];
#pragma unroll
      for (int u = 0; u < TK_ROWS; ++u)
        if (rg + u < nr) acc[u] = fmaf(tk_load(xr + (size_t)u * D + d), qd,
                                       acc[u]);
    }
    // Reduce-scatter: after the steps over lane bits 4, 3 and 2, lane l
    // holds row (l >> 2) summed over its four-lane group; bits 1 and 0
    // finish as a butterfly.  Each add is own + partner, as in a full
    // xor butterfly, so the sums are the same bits.
    const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float send = h4 ? acc[k] : acc[k + 4];
      const float keep = h4 ? acc[k + 4] : acc[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
    float w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float send = h3 ? v[k] : v[k + 2];
      const float keep = h3 ? v[k + 2] : v[k];
      w[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    float s = (h2 ? w[1] : w[0]) +
              __shfl_xor_sync(0xffffffffu, h2 ? w[0] : w[1], 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    const int row = rg + (lane >> 2);
    // + 0.f turns a -0 sum into +0, so equal scores get equal keys
    emit((lane & 3) == 0 && row < nr, s + 0.f, g0 + row, keys, row, hist,
         shift0, lane);
  }
  // rows past M: -inf at their own index, never read
  for (int base = nr + warp * 32; base < nt; base += TK_THREADS) {
    const int i = base + lane;
    emit(i < nt, -INFINITY, g0 + i, keys, i, hist, shift0, lane);
  }
}

// Bitonic sort, descending, of Q keys (a power of two) in shared memory:
// a stage whose pairs lie within blocks of Q / TK_WARPS keys runs warp by
// warp, each on its own block; a block barrier comes only before a stage
// that is not.
__device__ void bitonic_smem(u64* top, int Q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wb = Q / TK_WARPS;  // a warp's block
  for (int k = 2; k <= Q; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool local = j < wb, next_local = (j > 1 ? j >> 1 : k) < wb;
      const int t0 = local ? warp * (wb / 2) + lane : tid;
      const int t1 = local ? (warp + 1) * (wb / 2) : Q / 2;
      for (int t = t0; t < t1; t += local ? 32 : TK_THREADS) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i | j;
        const u64 a = top[i], b = top[l];
        if (((i & k) == 0) ? (a < b) : (a > b)) {
          top[i] = b;
          top[l] = a;
        }
      }
      if (local && next_local) __syncwarp();
      else __syncthreads();
    }
  }
  __syncthreads();
}

// The tile's byte range [a, b) of emb and its 16-byte-aligned interior
// [lo, hi) (empty when the range holds no aligned 16 bytes).
struct TileSpan {
  uintptr_t a, b, lo, hi;
};

__device__ __forceinline__ TileSpan tile_span(const void* first,
                                              const void* end) {
  TileSpan t;
  t.a = (uintptr_t)first;
  t.b = (uintptr_t)end;
  const uintptr_t lo = (t.a + 15) & ~(uintptr_t)15, hi = t.b & ~(uintptr_t)15;
  t.lo = hi > lo ? lo : t.b;
  t.hi = hi > lo ? hi : t.b;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(TK_THREADS, 2)
scored_topk_kernel(const T* __restrict__ emb, const T* __restrict__ q,
                   float* __restrict__ vals, int* __restrict__ idx,
                   u64* __restrict__ keys_g, u64* __restrict__ cand_g,
                   unsigned* __restrict__ scratch, int M, int D, int c,
                   int seg, int cps, int tile_rows, int stages, int gather,
                   int key_slots, int bits0) {
  extern __shared__ __align__(16) unsigned char smem[];
  Header& h = *reinterpret_cast<Header*>(smem);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + TK_HEADER);
  float* qs = reinterpret_cast<float*>(smem + TK_HEADER + (4 << bits0));
  unsigned char* region =
      smem + TK_HEADER + (4 << bits0) + ((4 * D + 15) & ~15);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x / cps, part = blockIdx.x % cps;
  // this CTA's tiles [t_lo, t_hi) of segment s; tile t holds rows
  // [seg0 + t * tile_rows, ...), those at or past M scored -inf
  const long long seg0 = (long long)s * seg;
  const int ntiles = (seg + tile_rows - 1) / tile_rows;
  const int t_lo = (int)((long long)ntiles * part / cps);
  const int t_hi = (int)((long long)ntiles * (part + 1) / cps);
  const size_t stage_bytes =
      stages ? (((size_t)tile_rows * D * sizeof(T) + 15) & ~(size_t)15) + 16
             : 0;
  u64* keys = keys_g ? keys_g + (size_t)blockIdx.x * key_slots
                     : reinterpret_cast<u64*>(region + stages * stage_bytes);
  unsigned* sc = scratch + (size_t)s * TK_SCRATCH;

  for (int d = tid; d < D; d += TK_THREADS) qs[d] = tk_load(q + d);
  for (int b = tid; b < 1 << bits0; b += TK_THREADS) hist[b] = 0u;
  if (tid == 0) {
    h.prefix = 0ull;
    h.need = c;
    h.cand = 0;
    h.done = 0;
    h.count = 0;
    for (int i = 0; i < stages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&h.full[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Step 1: tile t's first row, rows and rows below M.
  auto rows_of = [&](int t, long long* ta, int* nt) {
    *ta = seg0 + (long long)t * tile_rows;
    *nt = min(tile_rows, seg - t * tile_rows);
    return (int)max(0ll, min((long long)*nt, (long long)M - *ta));
  };
  auto fetch = [&](int t) {  // thread 0: tile t into stage t % stages
    long long ta;
    int nt;
    const int nr = rows_of(t, &ta, &nt);
    u64* bar = &h.full[(t - t_lo) % stages];
    const TileSpan sp = tile_span(emb + ta * D, emb + (ta + nr) * D);
    if (nr && sp.hi > sp.lo) {
      unsigned char* dst = region + ((t - t_lo) % stages) * stage_bytes +
                           (sp.a & 15) + (sp.lo - sp.a);
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
  };
  if (tid == 0 && stages)
    for (int t = t_lo; t < t_hi && t < t_lo + stages; ++t) fetch(t);
  int n = 0;  // keys made
  for (int t = t_lo; t < t_hi; ++t) {
    long long ta;
    int nt;
    const int nr = rows_of(t, &ta, &nt);
    if (stages) {
      const int st = (t - t_lo) % stages;
      mbar_wait(&h.full[st], (unsigned)((t - t_lo) / stages) & 1u);
      // element 0 of row ta sits at the stage's byte (a & 15); the
      // unaligned head and tail of the range come by plain loads
      const TileSpan sp = tile_span(emb + ta * D, emb + (ta + nr) * D);
      T* xs = reinterpret_cast<T*>(region + st * stage_bytes + (sp.a & 15));
      const int head = nr ? (int)((sp.lo - sp.a) / sizeof(T)) : 0;
      const int tail = nr ? (int)((sp.b - sp.hi) / sizeof(T)) : 0;
      if (head + tail > 0) {
        const T* src = emb + ta * D;
        const int t0 = (int)((sp.hi - sp.a) / sizeof(T));
        for (int i = tid; i < head + tail; i += TK_THREADS) {
          const int e = i < head ? i : t0 + (i - head);
          xs[e] = src[e];
        }
        __syncthreads();
      }
      score_rows(xs, nr, nt, ta, D, qs, keys + n, hist, 64 - bits0);
      // the stage's generic-proxy reads and writes come before the next
      // bulk copy into it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (tid == 0 && t + stages < t_hi) fetch(t + stages);
    } else {
      score_rows(emb + ta * D, nr, nt, ta, D, qs, keys + n, hist,
                 64 - bits0);
    }
    n += nt;
  }
  __syncthreads();

  // Step 3: radix select over the segment.  Invariant: the keys whose
  // resolved bits equal the prefix hold the need-th largest still to be
  // found.  The loops over i run the same trip count on every lane of a
  // warp, as __match_any_sync and __ballot_sync need.
  u64 mask = 0ull, prefix = 0ull;
  unsigned nbar = 0;
  for (int r = 0, width = bits0, shift = 64 - bits0; r < 8; ++r) {
    const int bins = 1 << width;
    if (r > 0) {  // this round's digit counts (round 0's came with the keys)
      for (int b = tid; b < bins; b += TK_THREADS) hist[b] = 0u;
      __syncthreads();
      for (int base = warp * 32; base < n; base += TK_THREADS) {
        const int i = base + lane;
        const u64 k = i < n ? keys[i] : 0ull;
        const bool in = i < n && (k & mask) == prefix;
        const unsigned digit =
            in ? (unsigned)(k >> shift) & (bins - 1) : TK_BINS;
        const unsigned peers = __match_any_sync(0xffffffffu, digit);
        if (in && lane == __ffs(peers) - 1)
          atomicAdd(&hist[digit], __popc(peers));
      }
      __syncthreads();
    }
    if (cps > 1) {  // the segment's sum
      unsigned* H = sc + 4 + (r % 3) * TK_BINS;
      unsigned* next = sc + 4 + ((r + 1) % 3) * TK_BINS;
      for (int b = tid; b < TK_BINS; b += TK_THREADS) {
        if (b < bins && hist[b]) atomicAdd(H + b, hist[b]);
        if (part == 0) next[b] = 0u;  // read last in round r - 2
      }
      seg_barrier(sc, ++nbar * (unsigned)cps);
      for (int b = tid; b < bins; b += TK_THREADS) hist[b] = __ldcg(H + b);
      __syncthreads();
    }
    if (warp == 0) {
      // lane l holds bins / 32 bins from bin bins - 1 - l * bins / 32 down,
      // the top bins first
      const unsigned need = (unsigned)h.need;
      const int per = bins / 32, hi = bins - 1 - per * lane;
      unsigned sum = 0u;
      for (int j = 0; j < per; ++j) sum += hist[hi - j];
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      unsigned above = incl - sum;  // keys in higher bins
      if (above < need && need <= incl) {  // exactly one lane
        for (int j = 0; j < per; ++j) {
          const unsigned cnt = hist[hi - j];
          if (above + cnt >= need) {
            h.prefix = prefix | ((u64)(hi - j) << shift);
            h.need = (int)(need - above);
            h.cand = c - (int)(need - above) + (int)cnt;
            h.done = h.cand <= gather || shift == 0;
            break;
          }
          above += cnt;
        }
      }
    }
    __syncthreads();
    prefix = h.prefix;
    mask |= (u64)(bins - 1) << shift;
    if (h.done) break;
    width = min(8, shift);
    shift -= width;
  }

  // Step 4: the h.cand candidates of the segment have (k & mask) >=
  // prefix.  Count this CTA's, take a base, write them to the gather
  // slots.
  u64* cands = cand_g + (size_t)s * gather;
  for (int base = warp * 32; base < n; base += TK_THREADS) {
    const int i = base + lane;
    const bool take = i < n && (keys[i] & mask) >= prefix;
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    if (lane == 0 && ballot) atomicAdd(&h.count, __popc(ballot));
  }
  __syncthreads();
  if (tid == 0) {
    h.base = cps > 1 ? (int)atomicAdd(sc + 1, (unsigned)h.count) : 0;
    h.count = 0;
  }
  __syncthreads();
  for (int base = warp * 32; base < n; base += TK_THREADS) {
    const int i = base + lane;
    const u64 k = i < n ? keys[i] : 0ull;
    const bool take = i < n && (k & mask) >= prefix;
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(&h.count, __popc(ballot));
    at = h.base + __shfl_sync(0xffffffffu, at, 0);
    if (take) cands[at + __popc(ballot & ((1u << lane) - 1u))] = k;
  }
  if (cps > 1) seg_barrier(sc, ++nbar * (unsigned)cps);
  else __syncthreads();

  const int nc = h.cand;
  float* vout = vals + (size_t)s * c;
  int* iout = idx + (size_t)s * c;
  if (cps >= TK_RANK_CTAS) {
    // Every CTA places its share of the candidates: a key's rank is the
    // number of candidates above it (keys are unique), and the c of rank
    // below c are the top c, so no CTA sorts.  The region (ring and keys
    // spent) holds the candidates.
    u64* cs = reinterpret_cast<u64*>(region);
    for (int i = tid; i < nc; i += TK_THREADS) cs[i] = __ldcg(cands + i);
    if (tid < 8) h.rank[tid] = 0;
    __syncthreads();
    const int m1 = (int)((long long)nc * (part + 1) / cps);
    for (int x0 = (int)((long long)nc * part / cps); x0 < m1; x0 += 8) {
      u64 own[8];
      int above[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        own[u] = x0 + u < m1 ? cs[x0 + u] : ~0ull;
        above[u] = 0;
      }
      for (int y = tid; y < nc; y += TK_THREADS) {
        const u64 k = cs[y];
#pragma unroll
        for (int u = 0; u < 8; ++u) above[u] += k > own[u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int w = __reduce_add_sync(0xffffffffu, above[u]);
        if (lane == 0 && w) atomicAdd(&h.rank[u], w);
      }
      __syncthreads();
      if (tid < 8 && x0 + tid < m1) {
        const int r = h.rank[tid];
        if (r < c) {
          vout[r] = key_value(cs[x0 + tid]);
          iout[r] = key_index(cs[x0 + tid]);
        }
      }
      __syncthreads();
      if (tid < 8) h.rank[tid] = 0;
      __syncthreads();
    }
  } else if (part == 0) {
    // CTA 0 sorts the candidates descending (the region holds them) and
    // writes the top c.
    const int Q = nc > 1 ? 1 << (32 - __clz(nc - 1)) : 1;
    u64* top = reinterpret_cast<u64*>(region);
    for (int i = tid; i < Q; i += TK_THREADS)
      top[i] = i < nc ? __ldcg(cands + i) : 0ull;  // 0: below every key
    __syncthreads();
    bitonic_smem(top, Q);
    for (int i = tid; i < c; i += TK_THREADS) {
      const u64 key = top[i];
      vout[i] = key_value(key);
      iout[i] = key_index(key);
    }
  }
  if (cps > 1 && part != 0) {  // leave; CTA 0 clears the scratch last
    __syncthreads();
    if (tid == 0)
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                   :: "l"(sc + 2) : "memory");
    return;
  }
  if (cps > 1) {
    if (tid == 0) {
      const u64 t0 = now_ns();
      for (unsigned v = 0; v < (unsigned)cps - 1;) {
        asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                     : "=r"(v) : "l"(sc + 2) : "memory");
        if (v < (unsigned)cps - 1 && now_ns() - t0 > TK_TIMEOUT_NS) __trap();
      }
    }
    __syncthreads();
    for (int i = tid; i < TK_SCRATCH; i += TK_THREADS) sc[i] = 0u;
  }
}

// Host entry points: plain C interface for ctypes.  Each returns the
// cudaError_t of the attribute call, the occupancy query or the launch
// (0 = success); the caller raises on anything else
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot co-reside).
static const void* kernel_of(int bf16) {
  return bf16 ? (const void*)scored_topk_kernel<__nv_bfloat16>
              : (const void*)scored_topk_kernel<float>;
}

// Let the kernel take `smem` bytes of dynamic shared memory.
extern "C" int scored_topk_set_smem(int bf16, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel_of(bf16), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// CTAs of the kernel that can be co-resident on the current device at
// `smem` bytes of dynamic shared memory per CTA (the kernel's limit
// already raised to at least `smem`).
extern "C" int scored_topk_capacity(int bf16, int smem, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(bf16), TK_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return 0;
}

// emb (M, D), q (D,) -> vals (segs, c) float32, idx (segs, c) int32, on
// segs * cps CTAs (cooperative when cps > 1).  keys_g: device-memory keys
// (key_slots a CTA) or null for keys in shared memory; cand_g: `gather`
// candidate slots a segment; scratch: TK_SCRATCH zeroed words a segment
// (cps > 1), left zeroed.
extern "C" int scored_topk_launch(int bf16, const void* emb, const void* q,
                                  float* vals, int* idx,
                                  unsigned long long* keys_g,
                                  unsigned long long* cand_g,
                                  unsigned* scratch, int M, int D, int c,
                                  int seg, int segs, int cps, int tile_rows,
                                  int stages, int gather, int key_slots,
                                  int bits0, int smem, void* stream) {
  void* args[] = {&emb,   &q,      &vals,   &idx,       &keys_g,
                  &cand_g, &scratch, &M,    &D,         &c,
                  &seg,   &cps,    &tile_rows, &stages, &gather,
                  &key_slots, &bits0};
  const dim3 grid((unsigned)segs * (unsigned)cps), block(TK_THREADS);
  if (cps > 1)
    return (int)cudaLaunchCooperativeKernel(kernel_of(bf16), grid, block,
                                            args, (size_t)smem,
                                            (cudaStream_t)stream);
  return (int)cudaLaunchKernel(kernel_of(bf16), grid, block, args,
                               (size_t)smem, (cudaStream_t)stream);
}
