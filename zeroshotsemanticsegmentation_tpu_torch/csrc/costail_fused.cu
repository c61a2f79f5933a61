// Fused stage-1 train-step tail: masked cosine loss, NNE argmax confusion
// histogram and score sum in one read of the full-resolution score
// (forward, K5), and d score in one more read and one write (backward, K6).
//
// Replaces: zeroshotsemanticsegmentation_tpu/ops/costail_fused.py,
//   forward  `_fwd_kernel` (:108, launched at :179; K5),
//   backward `_bwd_kernel` (:145, launched at :230; K6),
// with their shared per-pixel recompute `_common` (:81).
//
// Layouts: score (B, H, W, C) NHWC fp32 (C contiguous per pixel; the TPU
// kernel's (B, C, H*W) transpose served the TPU's lanes and is not carried
// over), label (B, H, W) int32 (< 0 = ignore), target and infer embedding
// tables (K, C) fp32, rows already normalised by the wrapper. Every base
// is 16-byte aligned (the wrapper's check). Per pixel (`_common`):
//   t^  = temb[label] (0 for a label outside [0, K)), valid = label >= 0
//   r2  = |s|^2, norm = sqrt(r2 == 0 ? 1 : r2), s^ = s / norm
//   cos = s^ . t^;  pred = first argmax_k iemb[k] . s^
// Forward: per sample sum(valid * cos), count(valid); hist[label][pred]
//   over valid pixels with label < n; sum(s); loss_b = (nv - cos_b) /
//   max(nv, 1).
// Backward: ds = -(g_b / max(nv_b, 1)) * valid * (r2 == 0 ? t^ :
//   (t^ - cos * s^) / norm) + g_ssum, the exact derivative of the
//   double-where normalise.
//
// Bound on an H100 at B=24, 512x512. C=20 (K=21): bytes. The forward
// reads the 503 MB score and 25 MB of labels (0.158 ms at 3.35 TB/s)
// against ~2.6 G fp32 FMAs of argmax (~0.08 ms at 67 TFLOP/s), which must
// hide under the stream; the backward reads both and writes the 503 MB
// d score, 0.308 ms. C=300 (K=33): bytes and FMAs together. The forward's
// 7.5 GB take 2.26 ms and its 62 G argmax FMAs ~1.9 ms, so the FMA pipes
// have to stay fed while the tiles stream; the backward is 4.5 ms of bytes.
//
// Design: a pipelined stream. The flattened (B*H*W) pixel axis is cut into
// tiles of T pixels (T a multiple of 4, so a tile's T*C scores and T
// labels start 16-byte aligned and span whole 16-byte units, whatever a
// sample's base). A grid sized to the SMs (the blocks that fit at once,
// from the host's plan) gives each block one contiguous run of tiles.
// Thread 0 keeps `stages` (3 or 4) tiles in flight in a ring of shared-
// memory stages, each filled by two 1D bulk copies (cp.async.bulk ...
// mbarrier::complete_tx) that complete one mbarrier a stage; the ragged
// end of the tensor's last tile (< 16 bytes) comes by plain loads.
// Consumers wait on the stage's barrier, compute, and release it at the
// tile's __syncthreads, after which thread 0 refills it.
// Per pixel one IEEE division (cos = (s . t^) / norm) and, in the
// backward, one reciprocal: a division per channel cost more than the
// stream at every width. The argmax takes the raw scores: e . s and
// e . s^ differ by the positive factor 1 / norm, so the first maximum is
// the same up to rounding at near-ties (the histogram bar's flips).
// Two forms:
//   register form (C in {2, 5, 10, 20, 21}, C a template parameter): 128
//     threads, 256-pixel tiles, 2 pixels a thread; a pixel's scores and its
//     target row come as float4 / float2 / float loads (conflict-free at
//     the row stride C) into registers, the loops run to C, and each
//     vector of the infer table, read from shared memory as a broadcast,
//     feeds both pixels' FMAs, two classes in flight;
//   wide form (any other C, C at run time, V-float chunks with V the
//     widest of 4, 2, 1 dividing C): 8 lanes share a pixel pair, 64-pixel
//     tiles at most (a C=300 pixel is 1.2 KB). |s|^2, sum(s) and s . t^
//     take every 8th chunk a lane and an xor butterfly over the 8 lanes.
//     The argmax splits the classes instead of the channels: in a window
//     of 8 * NCL classes (NCL = 3, 5, 8 for K <= 24, 40, 64) each lane
//     takes NCL classes over all of C, in channel order, for both pixels,
//     so no partial sums cross lanes; the rows' chunks are broadcasts to
//     the 8 lanes and the table (K padded to whole windows, rows an odd
//     count of vectors apart) a conflict-free read; a first maximum over
//     the 8 lanes closes the window. The backward reads |s|^2 and s . t^
//     (temb through L1, which its tiles leave room for), then writes d
//     score in place.
// The histogram counts in shared memory, aggregated per warp first
// (__match_any_sync on the bin, one atomicAdd of the popcount by the lowest
// lane: spatially coherent labels hit one bin), then the block adds its
// non-zero bins to the global int32 histogram (integer atomics: exact in
// any order). Per-sample sums of cos and valid count are kept per thread
// and reduced over the block (a fixed tree) where the block's run crosses
// a sample boundary and at its end, into a (B, grid) partial buffer; the
// score sum per block into (grid). `costail_finalize` adds the partials in
// block order, so two calls are bit-equal.
// The backward computes d score in place in the stage, then (after
// fence.proxy.async.shared::cta and the tile's barrier) thread 0 stores it
// with one bulk copy (cp.async.bulk.global.shared::cta.bulk_group) and
// refills the stage of the tile before once `cp.async.bulk.wait_group.read
// 1` says that tile's store has read it; the ragged tail is stored plainly.
// (Direct stores from registers measured slower than the bulk store.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeader = 128;        // barriers, then the reduction scratch
constexpr int kMaxStages = 4;
constexpr int kRegThreads = 128;    // register form
constexpr int kRegPx = 2;           // its pixels per thread per tile
constexpr int kRegTile = kRegThreads * kRegPx;
constexpr int kRegMinBlocks = 4;
constexpr int kLanes = 8;           // wide form: lanes per pixel pair
constexpr int kWidePx = 2;          // pixels per lane group
constexpr int kWideMaxTile = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

__host__ __device__ __forceinline__ bool reg_width(int c) {
  return c == 2 || c == 5 || c == 10 || c == 20 || c == 21;
}

// the widest vector that divides C
__host__ __device__ constexpr int vec_width(int c) {
  return c % 4 == 0 ? 4 : (c % 2 == 0 ? 2 : 1);
}

// the wide forward's argmax: each of a pixel pair's 8 lanes takes this
// many classes of a window of 8 * lane_classes(K)
__host__ __device__ __forceinline__ int lane_classes(int k) {
  return k <= 24 ? 3 : (k <= 40 ? 5 : 8);
}

__host__ __device__ __forceinline__ int padded_classes(int k) {
  const int w = kLanes * lane_classes(k);
  return (k + w - 1) / w * w;
}

// the wide forward's infer-table row stride in V-float vectors: odd, so
// 8 lanes reading 8 rows at one chunk hit distinct banks
__host__ __device__ __forceinline__ int iemb_stride(int c) {
  return (c / vec_width(c)) | 1;
}

// dynamic shared memory: header (stage barriers at 0, float / int
// reduction scratch at 32 / 64), tables, histogram (forward), stages
struct Layout {
  int tables, hist, stage, total;
};

__host__ __device__ __forceinline__ Layout layout(bool forward, bool wide,
                                                  int tile, int stages, int c,
                                                  int k, int n) {
  Layout l;
  const int floats =
      forward ? (wide ? padded_classes(k) * iemb_stride(c) * vec_width(c)
                            + k * c
                      : 2 * k * c)
              : (wide ? 0 : k * c);
  l.tables = round16(floats * 4);
  l.hist = forward ? round16(n * n * 4) : 0;
  l.stage = tile * (c + 1) * 4;
  l.total = kHeader + l.tables + l.hist + stages * l.stage;
  return l;
}

// ---- barriers and bulk copies ----------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// waits until the phase of parity `parity` has completed; a phase that
// never completes (a lost bulk transaction) ends the launch with an error
// after 10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(saddr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the ring ----------------------------------------------------------------

struct Ring {
  unsigned char* base;    // stage 0
  uint64_t* bars;
  int stage_bytes, tile, c;
  __device__ float* score(int s) const {
    return reinterpret_cast<float*>(base + s * stage_bytes);
  }
  __device__ int* label(int s) const {
    return reinterpret_cast<int*>(base + s * stage_bytes
                                  + tile * c * 4);
  }
  __device__ uint32_t bar(int s) const { return saddr(bars + s); }
};

// the block's run of tiles: tile(0 .. count), one contiguous run
struct Run {
  long long t_begin;
  int count;
  __device__ long long tile(int i) const { return t_begin + i; }
};

__device__ __forceinline__ Run block_run(long long pixels, int tile) {
  const long long tiles = (pixels + tile - 1) / tile;
  const long long b = tiles * blockIdx.x / gridDim.x;
  const long long e = tiles * (blockIdx.x + 1) / gridDim.x;
  return {b, static_cast<int>(e - b)};
}

// thread 0: tile t into stage s. The bulk copies take the 16-byte
// multiple of each run; the ragged end of the tensor's last tile comes by
// plain loads, stored before the barrier's arrival (release) so the
// consumers' wait sees them.
__device__ __forceinline__ void fetch_tile(const Ring& r, int s,
                                           const float* score,
                                           const int* label, long long t,
                                           long long pixels) {
  const long long p0 = t * r.tile;
  const int np = static_cast<int>(
      min(static_cast<long long>(r.tile), pixels - p0));
  const long long e0 = p0 * r.c;
  const int floats = np * r.c;
  const int sbulk = (floats * 4) & ~15, lbulk = (np * 4) & ~15;
  float* ss = r.score(s);
  int* sl = r.label(s);
  for (int i = sbulk / 4; i < floats; ++i) ss[i] = score[e0 + i];
  for (int i = lbulk / 4; i < np; ++i) sl[i] = label[p0 + i];
  mbar_expect_tx(r.bar(s), sbulk + lbulk);
  if (sbulk) bulk_load(ss, score + e0, sbulk, r.bar(s));
  if (lbulk) bulk_load(sl, label + p0, lbulk, r.bar(s));
}

// barriers (thread 0) and the first tiles in flight; all threads call it
// after filling their shared tables
__device__ __forceinline__ void ring_start(const Ring& r, int stages,
                                           int ahead, const float* score,
                                           const int* label, Run run,
                                           long long pixels) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(r.bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < ahead && i < run.count; ++i)
      fetch_tile(r, i, score, label, run.tile(i), pixels);
  }
}

// ---- reductions ----------------------------------------------------------------

// block-wide sum of v (all threads call it); the result is valid in thread 0
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  V s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) s += red[w];
  return s;
}

// one count of `bin` (< 0: none) into the shared histogram, aggregated
// over the warp's lanes with the same bin; all 32 lanes call it
__device__ __forceinline__ void hist_add(int* shist, int bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  if (bin >= 0 && static_cast<int>(threadIdx.x % 32) == __ffs(peers) - 1)
    atomicAdd(&shist[bin], __popc(peers));
}

// per-thread accumulators of the forward and their flushes
struct Acc {
  float cos, ssum;
  int nv;
};

struct FwdArgs {
  const float* score;
  const int* label;
  const float* temb;
  const float* iemb;
  float* cos_part;   // (B, grid)
  int* nv_part;      // (B, grid)
  float* ssum_part;  // (grid)
  int* hist;         // (n, n)
  long long pixels;
  int hw, c, k, n, tile, stages;
};

struct BwdArgs {
  const float* score;
  const int* label;
  const float* temb;
  const float* g_losses;
  const float* nv;
  const float* g_ssum;
  float* dscore;
  long long pixels;
  int hw, c, k, tile, stages;
};

__device__ __forceinline__ void flush_sample(Acc& a, long long b,
                                             const FwdArgs& p,
                                             unsigned char* smem) {
  const float cs = block_sum(a.cos, reinterpret_cast<float*>(smem + 32));
  const int nv = block_sum(a.nv, reinterpret_cast<int*>(smem + 64));
  if (threadIdx.x == 0) {
    p.cos_part[b * gridDim.x + blockIdx.x] = cs;
    p.nv_part[b * gridDim.x + blockIdx.x] = nv;
  }
  a.cos = 0.f;
  a.nv = 0;
}

// ---- vector rows -----------------------------------------------------------------

template <int V> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float at(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ void set(T& v, int i, float x) {
    if (i == 0) v.x = x; else if (i == 1) v.y = x;
    else if (i == 2) v.z = x; else v.w = x;
  }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ float at(const T& v, int i) {
    return i == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ void set(T& v, int i, float x) {
    if (i == 0) v.x = x; else v.y = x;
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float at(const T& v, int) { return v; }
  static __device__ __forceinline__ void set(T& v, int, float x) { v = x; }
};

// ---- register form ---------------------------------------------------------------

template <int C, int V>
__device__ __forceinline__ void load_row(const float* row, float (&s)[C]) {
  using VT = typename Vec<V>::T;
  const VT* r = reinterpret_cast<const VT*>(row);
#pragma unroll
  for (int m = 0; m < C / V; ++m) {
    const VT x = r[m];
#pragma unroll
    for (int v = 0; v < V; ++v) s[m * V + v] = Vec<V>::at(x, v);
  }
}

template <int C, int V>
__device__ __forceinline__ void store_row(float* row, const float (&s)[C]) {
  using VT = typename Vec<V>::T;
  VT* r = reinterpret_cast<VT*>(row);
#pragma unroll
  for (int m = 0; m < C / V; ++m) {
    VT x;
#pragma unroll
    for (int v = 0; v < V; ++v) Vec<V>::set(x, v, s[m * V + v]);
    r[m] = x;
  }
}

// t^ of a pixel with label lbl: temb's row as V-vectors, zeros for a label
// outside [0, K)
template <int C, int V>
__device__ __forceinline__ void target_row(const float* temb, int lbl, int k,
                                           float (&t)[C]) {
  if (lbl >= 0 && lbl < k) {
    load_row<C, V>(temb + lbl * C, t);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) t[i] = 0.f;
  }
}

// the shared recompute of `_common` for one pixel: r2 = |s|^2, norm, and
// cos = (s . t^) / norm (s^ . t^ with one division)
template <int C>
__device__ __forceinline__ float px_stats(const float (&s)[C],
                                          const float (&t)[C], float& r2,
                                          float& norm) {
  r2 = 0.f;
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    r2 += s[i] * s[i];
    dot += s[i] * t[i];
  }
  norm = sqrtf(r2 == 0.f ? 1.f : r2);
  return dot / norm;
}

// iemb row e . s for both pixels, summed in channel order
template <int C, int V>
__device__ __forceinline__ void row_dots(const float* e,
                                         const float (&sv)[kRegPx][C],
                                         float (&sim)[kRegPx]) {
  using VT = typename Vec<V>::T;
  const VT* ev = reinterpret_cast<const VT*>(e);
#pragma unroll
  for (int j = 0; j < kRegPx; ++j) sim[j] = 0.f;
#pragma unroll
  for (int m = 0; m < C / V; ++m) {
    const VT x = ev[m];  // a broadcast: every lane reads this row
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int j = 0; j < kRegPx; ++j)
        sim[j] += Vec<V>::at(x, v) * sv[j][m * V + v];
  }
}

// dynamic shared memory: header, temb (K, C), iemb (K, C), hist (n, n),
// stages of (tile * C scores, tile labels)
template <int C>
__global__ void __launch_bounds__(kRegThreads, kRegMinBlocks)
    costail_fwd_regs(const FwdArgs p) {
  constexpr int V = vec_width(C);
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(true, false, p.tile, p.stages, C, p.k, p.n);
  float* st = reinterpret_cast<float*>(smem + kHeader);
  float* si = st + p.k * C;
  int* shist = reinterpret_cast<int*>(smem + kHeader + L.tables);
  const Ring ring{smem + kHeader + L.tables + L.hist,
                  reinterpret_cast<uint64_t*>(smem), L.stage, p.tile, C};
  const int tid = threadIdx.x;
  for (int i = tid; i < p.k * C; i += blockDim.x) {
    st[i] = p.temb[i];
    si[i] = p.iemb[i];
  }
  for (int i = tid; i < p.n * p.n; i += blockDim.x) shist[i] = 0;
  const Run run = block_run(p.pixels, p.tile);
  ring_start(ring, p.stages, p.stages, p.score, p.label, run, p.pixels);

  Acc acc{0.f, 0.f, 0};
  long long bcur = run.tile(0) * p.tile / p.hw;
  for (int i = 0; i < run.count; ++i) {
    const int s = i % p.stages;
    const long long p0 = run.tile(i) * p.tile;
    const int np = static_cast<int>(
        min(static_cast<long long>(p.tile), p.pixels - p0));
    mbar_wait(ring.bar(s), (i / p.stages) & 1);
    const float* ss = ring.score(s);
    const int* sl = ring.label(s);
    // one segment per sample the tile holds
    for (int q0 = 0; q0 < np;) {
      const long long b = (p0 + q0) / p.hw;
      if (b != bcur) {
        flush_sample(acc, bcur, p, smem);
        bcur = b;
      }
      const int q1 = static_cast<int>(
          min(static_cast<long long>(np), (b + 1) * p.hw - p0));
      float sv[kRegPx][C];  // raw scores: the argmax of e . s is that of
      int lbl[kRegPx];      // e . s^, the norm being a positive factor
      bool live[kRegPx];
#pragma unroll
      for (int j = 0; j < kRegPx; ++j) {
        const int q = q0 + tid + j * kRegThreads;
        live[j] = q < q1;
        if (live[j]) {
          load_row<C, V>(ss + q * C, sv[j]);
          lbl[j] = sl[q];
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) sv[j][c] = 0.f;
          lbl[j] = -1;
        }
        float t[C], r2, norm, psum = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) psum += sv[j][c];
        target_row<C, V>(st, lbl[j], p.k, t);
        const float cos = px_stats<C>(sv[j], t, r2, norm);
        if (live[j]) {
          acc.ssum += psum;
          if (lbl[j] >= 0) {
            acc.cos += cos;
            acc.nv += 1;
          }
        }
      }
      float best[kRegPx];
      int pred[kRegPx];
#pragma unroll
      for (int j = 0; j < kRegPx; ++j) {
        best[j] = 0.f;
        pred[j] = 0;
      }
      int kk = 0;
      for (; kk + 1 < p.k; kk += 2) {  // two classes in flight, in order
        float s0[kRegPx], s1[kRegPx];
        row_dots<C, V>(si + kk * C, sv, s0);
        row_dots<C, V>(si + (kk + 1) * C, sv, s1);
#pragma unroll
        for (int j = 0; j < kRegPx; ++j) {
          if (kk == 0 || s0[j] > best[j]) {
            best[j] = s0[j];
            pred[j] = kk;
          }
          if (s1[j] > best[j]) {
            best[j] = s1[j];
            pred[j] = kk + 1;
          }
        }
      }
      if (kk < p.k) {
        float s0[kRegPx];
        row_dots<C, V>(si + kk * C, sv, s0);
#pragma unroll
        for (int j = 0; j < kRegPx; ++j) {
          if (kk == 0 || s0[j] > best[j]) {
            best[j] = s0[j];
            pred[j] = kk;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRegPx; ++j)
        hist_add(shist, live[j] && lbl[j] >= 0 && lbl[j] < p.n
                            ? lbl[j] * p.n + pred[j] : -1);
      q0 = q1;
    }
    __syncthreads();  // stage s consumed
    if (tid == 0 && i + p.stages < run.count)
      fetch_tile(ring, s, p.score, p.label, run.tile(i + p.stages),
                 p.pixels);
  }
  flush_sample(acc, bcur, p, smem);
  const float ss_total = block_sum(acc.ssum,
                                   reinterpret_cast<float*>(smem + 32));
  if (tid == 0) p.ssum_part[blockIdx.x] = ss_total;
  __syncthreads();
  for (int i = tid; i < p.n * p.n; i += blockDim.x)
    if (shist[i]) atomicAdd(&p.hist[i], shist[i]);
}

// dynamic shared memory: header, temb (K, C), stages
template <int C>
__global__ void __launch_bounds__(kRegThreads, kRegMinBlocks)
    costail_bwd_regs(const BwdArgs p) {
  constexpr int V = vec_width(C);
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(false, false, p.tile, p.stages, C, p.k, 1);
  float* st = reinterpret_cast<float*>(smem + kHeader);
  const Ring ring{smem + kHeader + L.tables,
                  reinterpret_cast<uint64_t*>(smem), L.stage, p.tile, C};
  const int tid = threadIdx.x;
  for (int i = tid; i < p.k * C; i += blockDim.x) st[i] = p.temb[i];
  const Run run = block_run(p.pixels, p.tile);
  // the stores lag the loads by one tile: stages - 1 tiles ahead
  ring_start(ring, p.stages, p.stages - 1, p.score, p.label, run, p.pixels);
  const float gss = *p.g_ssum;

  for (int i = 0; i < run.count; ++i) {
    const int s = i % p.stages;
    const long long p0 = run.tile(i) * p.tile;
    const int np = static_cast<int>(
        min(static_cast<long long>(p.tile), p.pixels - p0));
    mbar_wait(ring.bar(s), (i / p.stages) & 1);
    float* ss = ring.score(s);
    const int* sl = ring.label(s);
    for (int q0 = 0; q0 < np;) {
      const long long b = (p0 + q0) / p.hw;
      const int q1 = static_cast<int>(
          min(static_cast<long long>(np), (b + 1) * p.hw - p0));
      const float coef = -(p.g_losses[b] / fmaxf(p.nv[b], 1.f));
#pragma unroll
      for (int j = 0; j < kRegPx; ++j) {
        const int q = q0 + tid + j * kRegThreads;
        if (q < q1) {
          float sv[C], t[C], r2, norm;
          load_row<C, V>(ss + q * C, sv);
          const int lbl = sl[q];
          target_row<C, V>(st, lbl, p.k, t);
          const float cos = px_stats<C>(sv, t, r2, norm);
          const float inv = 1.f / norm;
          const float cv = lbl >= 0 ? coef : 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float dcos = r2 == 0.f
                ? t[c] : (t[c] - cos * (sv[c] * inv)) * inv;
            sv[c] = cv * dcos + gss;
          }
          store_row<C, V>(ss + q * C, sv);
        }
      }
      q0 = q1;
    }
    fence_proxy_async();  // d score in the stage, for the bulk store
    __syncthreads();
    if (tid == 0) {
      const int floats = np * C, bulk = (floats * 4) & ~15;
      float* dst = p.dscore + p0 * C;
      if (bulk) bulk_store(dst, ss, bulk);
      for (int e = bulk / 4; e < floats; ++e) dst[e] = ss[e];
      // the tile before has been read out: its stage takes the next load
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int nxt = i + p.stages - 1;
      if (nxt < run.count)
        fetch_tile(ring, nxt % p.stages, p.score, p.label, run.tile(nxt),
                   p.pixels);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- wide form -------------------------------------------------------------------

// sum over the calling lane's 8-lane group (an xor butterfly: every lane
// of the group gets the same value)
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dynamic shared memory: header, iemb (K padded to whole windows with
// zero rows, rows of iemb_stride(C) V-vectors), temb (K, C), hist (n, n),
// stages; 8 lanes a pixel pair, blockDim.x = 4 * tile. A pass over the
// lane's chunks of both rows for |s|^2, sum(s) and s . t^ (added over the
// 8 lanes); then the argmax, one pass per window of 8 * NCL classes: each
// lane takes NCL classes (k0 + lane + 8j) over all of C, in channel order,
// for both pixels (the rows' chunks broadcast to the 8 lanes, each lane's
// table row a conflict-free read), then the first maximum across the 8
// lanes. It compares sims of the raw scores: the argmax of s . e equals
// that of s^ . e, the norm being a positive factor.
template <int V, int NCL>
__global__ void __launch_bounds__(kWideMaxTile / kWidePx * kLanes, 2)
    costail_fwd_wide(const FwdArgs p) {
  using VO = Vec<V>;
  using VT = typename VO::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = p.c, k = p.k, kp = padded_classes(k);
  const int chunks = c / V, es = iemb_stride(c);
  const Layout L = layout(true, true, p.tile, p.stages, c, k, p.n);
  VT* si = reinterpret_cast<VT*>(smem + kHeader);
  float* sif = reinterpret_cast<float*>(si);
  float* st = sif + kp * es * V;
  int* shist = reinterpret_cast<int*>(smem + kHeader + L.tables);
  const Ring ring{smem + kHeader + L.tables + L.hist,
                  reinterpret_cast<uint64_t*>(smem), L.stage, p.tile, c};
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, grp = tid / kLanes;
  const int groups = p.tile / kWidePx;
  for (int i = tid; i < kp * es * V; i += blockDim.x) {
    const int r = i / (es * V), col = i - r * (es * V);
    sif[i] = r < k && col < c ? p.iemb[r * c + col] : 0.f;
  }
  for (int i = tid; i < k * c; i += blockDim.x) st[i] = p.temb[i];
  for (int i = tid; i < p.n * p.n; i += blockDim.x) shist[i] = 0;
  const Run run = block_run(p.pixels, p.tile);
  ring_start(ring, p.stages, p.stages, p.score, p.label, run, p.pixels);
  const VT* stv = reinterpret_cast<const VT*>(st);

  Acc acc{0.f, 0.f, 0};
  long long bcur = run.tile(0) * p.tile / p.hw;
  for (int i = 0; i < run.count; ++i) {
    const int s = i % p.stages;
    const long long p0 = run.tile(i) * p.tile;
    const int np = static_cast<int>(
        min(static_cast<long long>(p.tile), p.pixels - p0));
    mbar_wait(ring.bar(s), (i / p.stages) & 1);
    const VT* ss = reinterpret_cast<const VT*>(ring.score(s));
    const int* sl = ring.label(s);
    for (int q0 = 0; q0 < np;) {
      const long long b = (p0 + q0) / p.hw;
      if (b != bcur) {
        flush_sample(acc, bcur, p, smem);
        bcur = b;
      }
      const int q1 = static_cast<int>(
          min(static_cast<long long>(np), (b + 1) * p.hw - p0));
      int row[kWidePx], lbl[kWidePx];  // a dead pixel reads row 0
      bool live[kWidePx];
#pragma unroll
      for (int j = 0; j < kWidePx; ++j) {
        const int q = q0 + grp + j * groups;
        live[j] = q < q1;
        row[j] = (live[j] ? q : 0) * chunks;
        lbl[j] = live[j] ? sl[q] : -1;
      }
#pragma unroll
      for (int j = 0; j < kWidePx; ++j) {
        const bool has_t = lbl[j] >= 0 && lbl[j] < k;
        const int trow = (has_t ? lbl[j] : 0) * chunks;
        float r2 = 0.f, psum = 0.f, dot = 0.f;
        for (int m = lane; m < chunks; m += kLanes) {
          const VT x = ss[row[j] + m], tv = stv[trow + m];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xv = VO::at(x, v);
            r2 += xv * xv;
            psum += xv;
            dot += xv * VO::at(tv, v);
          }
        }
        r2 = lanes_sum(r2);
        psum = lanes_sum(psum);
        dot = lanes_sum(dot);
        if (lane == 0 && live[j]) {
          acc.ssum += psum;
          if (lbl[j] >= 0) {
            acc.cos += has_t ? dot / sqrtf(r2 == 0.f ? 1.f : r2) : 0.f;
            acc.nv += 1;
          }
        }
      }
      float best[kWidePx] = {0.f, 0.f};
      int pred[kWidePx] = {0, 0};
      for (int k0 = 0; k0 < k; k0 += kLanes * NCL) {
        float sim[kWidePx][NCL];
#pragma unroll
        for (int j = 0; j < kWidePx; ++j)
#pragma unroll
          for (int cc = 0; cc < NCL; ++cc) sim[j][cc] = 0.f;
        const VT* e = si + (k0 + lane) * es;
#pragma unroll 4
        for (int m = 0; m < chunks; ++m) {
          const VT x0 = ss[row[0] + m], x1 = ss[row[1] + m];
#pragma unroll
          for (int cc = 0; cc < NCL; ++cc) {
            const VT ev = e[cc * kLanes * es + m];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              sim[0][cc] += VO::at(ev, v) * VO::at(x0, v);
              sim[1][cc] += VO::at(ev, v) * VO::at(x1, v);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kWidePx; ++j) {
          // the lane's first maximum over its classes, in class order
          float v = 0.f;
          int a = -1;
#pragma unroll
          for (int cc = 0; cc < NCL; ++cc) {
            const int kk = k0 + lane + kLanes * cc;
            if (kk < k && (a < 0 || sim[j][cc] > v)) {
              v = sim[j][cc];
              a = kk;
            }
          }
          // across the 8 lanes: the larger value, on a tie the lower class
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int oa = __shfl_xor_sync(0xffffffffu, a, off);
            if (oa >= 0 && (a < 0 || ov > v || (ov == v && oa < a))) {
              v = ov;
              a = oa;
            }
          }
          if (k0 == 0 || v > best[j]) {  // windows in class order
            best[j] = v;
            pred[j] = a;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kWidePx; ++j)
        hist_add(shist, lane == 0 && live[j] && lbl[j] >= 0 && lbl[j] < p.n
                            ? lbl[j] * p.n + pred[j] : -1);
      q0 = q1;
    }
    __syncthreads();  // stage s consumed
    if (tid == 0 && i + p.stages < run.count)
      fetch_tile(ring, s, p.score, p.label, run.tile(i + p.stages),
                 p.pixels);
  }
  flush_sample(acc, bcur, p, smem);
  const float ss_total = block_sum(acc.ssum,
                                   reinterpret_cast<float*>(smem + 32));
  if (tid == 0) p.ssum_part[blockIdx.x] = ss_total;
  __syncthreads();
  for (int i = tid; i < p.n * p.n; i += blockDim.x)
    if (shist[i]) atomicAdd(&p.hist[i], shist[i]);
}

// dynamic shared memory: header, stages (temb rows come from global
// memory, through L1); 8 lanes a pixel pair, blockDim.x = 4 * tile. Pass 1:
// |s|^2 and s . t^; pass 2: d score in place.
template <int V>
__global__ void __launch_bounds__(kWideMaxTile / kWidePx * kLanes, 2)
    costail_bwd_wide(const BwdArgs p) {
  using VO = Vec<V>;
  using VT = typename VO::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = p.c, k = p.k;
  const Layout L = layout(false, true, p.tile, p.stages, c, k, 1);
  const Ring ring{smem + kHeader + L.tables,
                  reinterpret_cast<uint64_t*>(smem), L.stage, p.tile, c};
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, grp = tid / kLanes;
  const int half = p.tile / kWidePx;
  const int chunks = c / V;
  const Run run = block_run(p.pixels, p.tile);
  ring_start(ring, p.stages, p.stages - 1, p.score, p.label, run, p.pixels);
  const float gss = *p.g_ssum;

  for (int i = 0; i < run.count; ++i) {
    const int s = i % p.stages;
    const long long p0 = run.tile(i) * p.tile;
    const int np = static_cast<int>(
        min(static_cast<long long>(p.tile), p.pixels - p0));
    mbar_wait(ring.bar(s), (i / p.stages) & 1);
    float* ss = ring.score(s);
    const int* sl = ring.label(s);
    for (int q0 = 0; q0 < np;) {
      const long long b = (p0 + q0) / p.hw;
      const int q1 = static_cast<int>(
          min(static_cast<long long>(np), (b + 1) * p.hw - p0));
      const float coef = -(p.g_losses[b] / fmaxf(p.nv[b], 1.f));
#pragma unroll
      for (int j = 0; j < kWidePx; ++j) {
        const int q = q0 + grp + j * half;
        const bool live = q < q1;   // uniform over the lane group
        VT* row = reinterpret_cast<VT*>(ss + (live ? q : 0) * c);
        const int lbl = live ? sl[q] : -1;
        const bool has_t = lbl >= 0 && lbl < k;
        const VT* t = reinterpret_cast<const VT*>(p.temb
                                                  + (has_t ? lbl : 0) * c);
        float r2 = 0.f, dot = 0.f;
        for (int m = lane; m < chunks; m += kLanes) {
          const VT x = row[m];
          const VT tv = __ldg(t + m);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            r2 += VO::at(x, v) * VO::at(x, v);
            dot += VO::at(x, v) * VO::at(tv, v);
          }
        }
        r2 = lanes_sum(r2);
        dot = lanes_sum(dot);
        const float norm = sqrtf(r2 == 0.f ? 1.f : r2);
        const float inv = 1.f / norm;
        const float cos = has_t ? dot / norm : 0.f;
        const float cv = lbl >= 0 ? coef : 0.f;
        if (live) {
          for (int m = lane; m < chunks; m += kLanes) {
            VT x = row[m];
            const VT tv = __ldg(t + m);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float tc = has_t ? VO::at(tv, v) : 0.f;
              const float dcos = r2 == 0.f
                  ? tc : (tc - cos * (VO::at(x, v) * inv)) * inv;
              VO::set(x, v, cv * dcos + gss);
            }
            row[m] = x;
          }
        }
      }
      q0 = q1;
    }
    fence_proxy_async();  // d score in the stage, for the bulk store
    __syncthreads();
    if (tid == 0) {
      const int floats = np * c, bulk = (floats * 4) & ~15;
      float* dst = p.dscore + p0 * c;
      if (bulk) bulk_store(dst, ss, bulk);
      for (int e = bulk / 4; e < floats; ++e) dst[e] = ss[e];
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int nxt = i + p.stages - 1;
      if (nxt < run.count)
        fetch_tile(ring, nxt % p.stages, p.score, p.label, run.tile(nxt),
                   p.pixels);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// losses (B,), nv (B,) as fp32, ssum (1): the partials added in block order
__global__ void costail_finalize(const float* __restrict__ cos_part,
                                 const int* __restrict__ nv_part,
                                 const float* __restrict__ ssum_part,
                                 int batch, int parts,
                                 float* __restrict__ losses,
                                 float* __restrict__ nv_out,
                                 float* __restrict__ ssum) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < batch) {
    float cs = 0.f;
    int nv = 0;
    for (int i = 0; i < parts; ++i) {
      cs += cos_part[static_cast<size_t>(b) * parts + i];
      nv += nv_part[static_cast<size_t>(b) * parts + i];
    }
    const float nvf = static_cast<float>(nv);
    losses[b] = (nvf - cs) / fmaxf(nvf, 1.f);
    nv_out[b] = nvf;
  }
  if (b == 0) {
    float s = 0.f;
    for (int i = 0; i < parts; ++i) s += ssum_part[i];
    *ssum = s;
  }
}

// ---- host side ---------------------------------------------------------------------

// opts the kernel in to `smem` bytes of dynamic shared memory where that is
// past the default 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (static_cast<size_t>(smem) <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, int grid, int threads, int smem,
                   cudaStream_t s, const Args& a) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// the plan's tile, stages, grid and shared memory, checked against the
// kernels' own layout and limits; returns the block's thread count or 0
int check_plan(bool forward, int wide, int batch, int hw, int c, int k,
               int n, int tile, int stages, int grid, int smem) {
  if (batch <= 0 || hw <= 0 || c <= 0 || k <= 0 || n <= 0 || grid <= 0
      || stages < 2 || stages > kMaxStages || tile <= 0 || tile % 4)
    return 0;
  if (wide ? (tile % 8 || tile > kWideMaxTile) : (!reg_width(c)
                                                  || tile != kRegTile))
    return 0;
  if (layout(forward, wide, tile, stages, c, k, n).total != smem) return 0;
  return wide ? tile / kWidePx * kLanes : kRegThreads;
}

template <int V>
cudaError_t launch_fwd_wide(int k, int grid, int threads, int smem,
                            cudaStream_t s, const FwdArgs& a) {
  switch (lane_classes(k)) {
    case 3: return launch(costail_fwd_wide<V, 3>, grid, threads, smem, s, a);
    case 5: return launch(costail_fwd_wide<V, 5>, grid, threads, smem, s, a);
    default: return launch(costail_fwd_wide<V, 8>, grid, threads, smem, s, a);
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: SM count, per-block opt-in shared memory, shared memory per SM and
// the shared memory the runtime reserves per block, of CUDA device `device`
extern "C" int costail_device(int device, void* out) {
  int* o = static_cast<int*>(out);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(&o[i], attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// workspace (int32, 2 * B * grid + grid): cos_part and nv_part (B, grid),
// ssum_part (grid); outputs losses (B,), nv (B,), ssum (1) fp32 and hist
// (n, n) int32. The workspace and the histogram are zeroed here.
extern "C" int costail_forward(const void* score, const void* label,
                               const void* temb, const void* iemb,
                               void* losses, void* nv, void* ssum, void* hist,
                               void* ws, int batch, int hw, int c, int k,
                               int n, int wide, int tile, int stages,
                               int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = check_plan(true, wide, batch, hw, c, k, n, tile,
                                 stages, grid, smem);
  if (!threads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t parts = static_cast<size_t>(batch) * grid;
  float* cos_part = static_cast<float*>(ws);
  int* nv_part = static_cast<int*>(ws) + parts;
  float* ssum_part = static_cast<float*>(ws) + 2 * parts;
  cudaError_t err = cudaMemsetAsync(ws, 0, (2 * parts + grid) * 4, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(hist, 0, static_cast<size_t>(n) * n * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{static_cast<const float*>(score),
                  static_cast<const int*>(label),
                  static_cast<const float*>(temb),
                  static_cast<const float*>(iemb), cos_part, nv_part,
                  ssum_part, static_cast<int*>(hist),
                  static_cast<long long>(batch) * hw, hw, c, k, n, tile,
                  stages};
  if (!wide) {
    switch (c) {
      case 2: err = launch(costail_fwd_regs<2>, grid, threads, smem, s, a);
        break;
      case 5: err = launch(costail_fwd_regs<5>, grid, threads, smem, s, a);
        break;
      case 10: err = launch(costail_fwd_regs<10>, grid, threads, smem, s, a);
        break;
      case 20: err = launch(costail_fwd_regs<20>, grid, threads, smem, s, a);
        break;
      default: err = launch(costail_fwd_regs<21>, grid, threads, smem, s, a);
    }
  } else if (vec_width(c) == 4) {
    err = launch_fwd_wide<4>(k, grid, threads, smem, s, a);
  } else if (vec_width(c) == 2) {
    err = launch_fwd_wide<2>(k, grid, threads, smem, s, a);
  } else {
    err = launch_fwd_wide<1>(k, grid, threads, smem, s, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  costail_finalize<<<(batch + 127) / 128, 128, 0, s>>>(
      cos_part, nv_part, ssum_part, batch, grid, static_cast<float*>(losses),
      static_cast<float*>(nv), static_cast<float*>(ssum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int costail_backward(const void* score, const void* label,
                                const void* temb, const void* g_losses,
                                const void* nv, const void* g_ssum,
                                void* dscore, int batch, int hw, int c,
                                int k, int wide, int tile, int stages,
                                int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = check_plan(false, wide, batch, hw, c, k, 1, tile,
                                 stages, grid, smem);
  if (!threads) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{static_cast<const float*>(score),
                  static_cast<const int*>(label),
                  static_cast<const float*>(temb),
                  static_cast<const float*>(g_losses),
                  static_cast<const float*>(nv),
                  static_cast<const float*>(g_ssum),
                  static_cast<float*>(dscore),
                  static_cast<long long>(batch) * hw, hw, c, k, tile, stages};
  cudaError_t err;
  if (!wide) {
    switch (c) {
      case 2: err = launch(costail_bwd_regs<2>, grid, threads, smem, s, a);
        break;
      case 5: err = launch(costail_bwd_regs<5>, grid, threads, smem, s, a);
        break;
      case 10: err = launch(costail_bwd_regs<10>, grid, threads, smem, s, a);
        break;
      case 20: err = launch(costail_bwd_regs<20>, grid, threads, smem, s, a);
        break;
      default: err = launch(costail_bwd_regs<21>, grid, threads, smem, s, a);
    }
  } else if (vec_width(c) == 4) {
    err = launch(costail_bwd_wide<4>, grid, threads, smem, s, a);
  } else if (vec_width(c) == 2) {
    err = launch(costail_bwd_wide<2>, grid, threads, smem, s, a);
  } else {
    err = launch(costail_bwd_wide<1>, grid, threads, smem, s, a);
  }
  return static_cast<int>(err);
}
