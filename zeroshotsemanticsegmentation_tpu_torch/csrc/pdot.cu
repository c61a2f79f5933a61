// Tiled matrix product with fp32 accumulation (K7).
//
// Replaces: zeroshotsemanticsegmentation_tpu/ops/pdot.py,
// `_kernel_accum_out` (fp32 output) and `_kernel_scratch` (other output
// types), the Pallas bodies that `pdot` launches.
//
// out (M, N) = a (M, K) @ b (K, N); with trans_a, a is (K, M) and
// out = a^T @ b, no transpose materialised. Every operand is row-major and
// contiguous. Inputs are both bf16 or both fp32, the output fp32 or bf16.
// Each output element sums its K products in fp32 in a fixed order and is
// rounded once to the output type. fp32 inputs multiply in full fp32 (FMA
// on CUDA cores, never TF32); bf16 products are exact in fp32.
//
// Bound on this card (the dot-free model's calls at B=24, 512x512, bf16 in,
// fp32 out; 6936 = 24 * 17^2 fc6 output pixels):
//   fc6 input gradient   6936 x 4096 x 25088: 1.426 TFLOP, 1.44 ms at the
//     989 TFLOP/s bf16 tensor-core peak (operations; 0.96 GB, 0.29 ms);
//   fc7 weight gradient  4096 x 6936 x 4096 (trans_a): 0.233 TFLOP, 0.24 ms
//     (operations);
//   score_fr / seenmask_score weight gradients, N = 20 / 2 (trans_a):
//     ~57 MB read, 0.017 ms (bytes).
//
// Four variants; the wrapper (ops/pdot.py, `pdot_plan`) picks one by the
// operands' shapes and alignment and `pdot_launch` refuses a variant whose
// preconditions fail:
//   tma (bf16; a's and b's rows and bases 16-byte aligned, M and N >= 64):
//     `pdot_tma`, persistent blocks of three warpgroups on a 128 x BN tile
//     (BN = kTmaBN): one thread of the first keeps a ring of kTmaStages
//     k-steps of 64 in flight by TMA (128-byte swizzle, out-of-bounds rows
//     and columns zero-filled, `mbarrier` full / empty pairs); the other two
//     each multiply a 64-row half on wgmma straight from shared memory by
//     descriptor (A K-major, or M-major under trans_a through wgmma's
//     transpose bit; B N-major), and store their accumulators to device
//     memory without staging. Tiles are walked in groups of kGroupM M-tiles
//     so that the A and B panels in flight stay in L2.
//   narrow (bf16, trans_a, N <= 24, M % 8 == 0: the 1x1 convolutions'
//     weight gradients into 20 or 2 classes): `pdot_narrow`, a block of one
//     warpgroup per 128 rows of M and fixed 512-deep K chunk; a streams
//     through a kNarrowStages-deep cp.async ring, b's chunk is staged once,
//     zero-padded to N = 8, 16 or 24, as wgmma's N-major B operand; A comes
//     from registers by ldmatrix.trans, so a's (K, M) layout needs no
//     transpose.
//   wmma (any other bf16 product: unaligned rows, tiny M or N): `pdot_bf16`,
//     a 128x128 output tile per 256-thread block on WMMA 16x16x16 fragments,
//     K 32 at a time through shared memory, edges bounds-checked.
//   fp32: `pdot_f32`, a 64x64 tile per block on the CUDA cores, 4x4
//     outputs per thread, K 16 at a time.
// Split K: narrow always splits K into its fixed 512-deep chunks; wmma and
// fp32 split K when the output has fewer tiles than the card has SMs (the
// chunk length the wrapper's rule states); each split writes an fp32
// partial tile and `pdot_reduce` adds the partials in chunk order.
// Deterministic: no atomics anywhere, and every variant sums each output
// element over K in one fixed order. Offsets are 64-bit (the fc6 output
// alone has 174 M elements).

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "conv3x3_wgmma.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// dtype codes and variant codes (ops/pdot.py)
constexpr int kF32 = 0, kBF16 = 1;
constexpr int kVarF32 = 0, kVarWmma = 1, kVarTma = 2, kVarNarrow = 3;
constexpr int kThreads = 256;
constexpr int kMaxGridYZ = 65535;

// bf16 tensor-core tiles of the wmma variant
constexpr int TM = 128, TN = 128, TK = 32;
constexpr int kPad = 8;             // bf16 row padding: 16 bytes
// fp32 CUDA-core tiles
constexpr int FM = 64, FN = 64, FK = 16;

__device__ __forceinline__ void store_out(void* out, bool out_f32, size_t i,
                                          float v) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
}

// two adjacent outputs (i even, 8-byte aligned in fp32)
__device__ __forceinline__ void store_out2(void* out, bool out_f32, size_t i,
                                           float v0, float v1) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + i) =
        __floats2bfloat162_rn(v0, v1);
}

// copies a rows x cols tile of the row-major (.., ld) matrix src, starting
// at (r0, c0), into dst (row stride dld), zero past (r_end, c_end); with
// kVec 16 bytes at a time (then ld, c0 and c_end are multiples of 8)
template <bool kVec, int kRows, int kCols>
__device__ __forceinline__ void load_tile(bf16* dst, int dld,
                                          const bf16* __restrict__ src,
                                          size_t ld, int r0, int c0,
                                          int r_end, int c_end) {
  if constexpr (kVec) {
    constexpr int kVecs = kRows * kCols / 8;
    for (int v = threadIdx.x; v < kVecs; v += kThreads) {
      const int r = v / (kCols / 8), c = (v % (kCols / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < r_end && c0 + c < c_end)
        val = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(r0 + r) * ld + c0 + c);
      *reinterpret_cast<uint4*>(dst + r * dld + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols, c = e % kCols;
      bf16 val = __float2bfloat16_rn(0.f);
      if (r0 + r < r_end && c0 + c < c_end)
        val = src[static_cast<size_t>(r0 + r) * ld + c0 + c];
      dst[r * dld + c] = val;
    }
  }
}

// grid (M tiles, N tiles, K splits); block z sums K in [z * k_chunk,
// min(K, (z + 1) * k_chunk)) and writes element (r, c) at
// out[z * M * N + r * N + c]
template <bool kTransA, bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads) pdot_bf16(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    void* __restrict__ out, bool out_f32, int m, int n, int k,
    int k_chunk) {
  // a's tile: [TM][TK] row-major, or with trans_a [TK][TM] (column-major
  // fragments); b's tile [TK][TN]
  constexpr int kALd = kTransA ? TM + kPad : TK + kPad;
  constexpr int kBLd = TN + kPad;
  __shared__ __align__(32) bf16 as[kTransA ? TK * kALd : TM * kALd];
  __shared__ __align__(32) bf16 bs[TK * kBLd];
  __shared__ __align__(32) float cs[kThreads / 32][16 * 16];
  using ALayout = typename std::conditional<kTransA, wmma::col_major,
                                            wmma::row_major>::type;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(k, kbeg + k_chunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    if constexpr (kTransA)
      load_tile<kVecA, TK, TM>(as, kALd, a, m, k0, m0, kend, m);
    else
      load_tile<kVecA, TM, TK>(as, kALd, a, k, m0, k0, m, kend);
    load_tile<kVecB, TK, TN>(bs, kBLd, b, n, k0, n0, kend, n);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16;
        const bf16* p = kTransA ? as + kk * kALd + r : as + r * kALd + kk;
        wmma::load_matrix_sync(fa[i], p, kALd);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kBLd + wn * 64 + j * 16,
                               kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment through the warp's 16x16 scratch, then
  // bounds-checked stores
  float* scratch = cs[warp];
  const size_t zoff = static_cast<size_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * 32 + i * 16, c0 = n0 + wn * 64 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, c = c0 + e % 16;
        if (r < m && c < n)
          store_out(out, out_f32, zoff + static_cast<size_t>(r) * n + c,
                    scratch[e]);
      }
      __syncwarp();
    }
  }
}

// the fp32 product on CUDA cores; grid and output as `pdot_bf16`
template <bool kTransA>
__global__ void __launch_bounds__(kThreads) pdot_f32(
    const float* __restrict__ a, const float* __restrict__ b,
    void* __restrict__ out, bool out_f32, int m, int n, int k,
    int k_chunk) {
  __shared__ float as[FK][FM + 4];  // k-major
  __shared__ float bs[FK][FN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(k, kbeg + k_chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += FK) {
    for (int e = threadIdx.x; e < FM * FK; e += kThreads) {
      int mm, kk;
      size_t src;
      if (kTransA) {  // (K, M): coalesced along m
        kk = e / FM;
        mm = e % FM;
        src = static_cast<size_t>(k0 + kk) * m + m0 + mm;
      } else {        // (M, K): 16-float runs along k
        mm = e / FK;
        kk = e % FK;
        src = static_cast<size_t>(m0 + mm) * k + k0 + kk;
      }
      as[kk][mm] = (m0 + mm < m && k0 + kk < kend) ? a[src] : 0.f;
    }
    for (int e = threadIdx.x; e < FK * FN; e += kThreads) {
      const int kk = e / FN, nn = e % FN;
      bs[kk][nn] = (k0 + kk < kend && n0 + nn < n)
          ? b[static_cast<size_t>(k0 + kk) * n + n0 + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const size_t zoff = static_cast<size_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < m && c < n)
        store_out(out, out_f32, zoff + static_cast<size_t>(r) * n + c,
                  acc[i][j]);
    }
  }
}

// out = sum over z of ws[z], in z order, rounded once
__global__ void pdot_reduce(const float* __restrict__ ws,
                            void* __restrict__ out, bool out_f32, size_t mn,
                            int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < mn; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    store_out(out, out_f32, i, s);
  }
}


// ---- the tma variant: TMA ring + wgmma, warp-specialised ------------------

constexpr int kTmaBM = 128, kTmaBK = 64;
constexpr int kTmaBN = 256;
constexpr int kTmaStages = 4;
constexpr int kTmaThreads = 384;       // producer + two consumer warpgroups
constexpr int kGroupM = 16;            // M tiles a raster group spans
constexpr int kBoxBytes = 64 * 64 * 2; // one 64 x 64 bf16 TMA box

template <int BN>
struct TmaCfg {
  static constexpr int kA = kTmaBM * kTmaBK * 2;   // 16 KB
  static constexpr int kB = kTmaBK * BN * 2;
  static constexpr int kStage = kA + kB;
  // the stages at a 1024-byte aligned base (the swizzle atom), then the
  // full and empty barriers
  static constexpr int kSmem = 1024 + kTmaStages * kStage + 2 * kTmaStages * 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
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
// never completes (a lost TMA transaction) ends the launch with an error
// after 10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}
// the box at (c0, c1) (innermost coordinate first) of `map` into `dst`,
// completing `bytes` on barrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// a 128-byte-swizzle shared-memory matrix descriptor; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return c3w::desc(addr, lbo, sbo) | (uint64_t{1} << 62);
}

// d (m64 x n128, fp32) += A (m64 x k16) x B (k16 x n128), both from shared
// memory through descriptors; kTransA / kTransB = 1 read MN-major
template <int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// tile t of the persistent walk: groups of kGroupM M-tiles, M fastest
// inside a group, then N
__device__ __forceinline__ void raster(int t, int tiles_m, int tiles_n,
                                       int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first = (t / per_group) * kGroupM;
  const int gm = min(tiles_m - first, kGroupM);
  const int r = t % per_group;
  tm = first + r % gm;
  tn = r / gm;
}

// A stage holds A as 128 rows x 64 k, K-major, one 16 KB box (or, with
// kTransA, two 64 m x 64 k M-major boxes of 8 KB, one per consumer), then B
// as BN / 64 N-major boxes of 64 n x 64 k; every box 128-byte swizzled in
// 1024-byte atoms of 8 rows. Descriptors: K-major A advances 32 B per k16
// step inside the atom row (sbo = 1024 between 8-row groups); M- and
// N-major operands advance 2048 B (two 8-k atoms) per k16 step, with
// lbo = 8 KB between 64-wide boxes and sbo = 1024 between 8-k atoms.
template <int BN, bool kTransA>
__global__ void __launch_bounds__(kTmaThreads, 1) pdot_tma(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, void* __restrict__ out,
    bool out_f32, int m, int n, int k) {
  using Cfg = TmaCfg<BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t raw = c3w::smem_u32(smem);
  const uint32_t stages = (raw + 1023) & ~1023u;
  const uint32_t full = stages + kTmaStages * Cfg::kStage;
  const uint32_t empty = full + 8 * kTmaStages;
  const int tiles_m = (m + kTmaBM - 1) / kTmaBM;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int kblocks = (k + kTmaBK - 1) / kTmaBK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        raster(t, tiles_m, tiles_n, tm, tn);
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, Cfg::kStage);
          const uint32_t sa = stages + stage * Cfg::kStage;
          const uint32_t sb = sa + Cfg::kA;
          if (kTransA) {
            tma_load(sa, &ta, tm * kTmaBM, kb * kTmaBK, bar);
            tma_load(sa + kBoxBytes, &ta, tm * kTmaBM + 64, kb * kTmaBK, bar);
          } else {
            tma_load(sa, &ta, kb * kTmaBK, tm * kTmaBM, bar);
          }
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sb + j * kBoxBytes, &tb, tn * BN + 64 * j, kb * kTmaBK,
                     bar);
          if (++stage == kTmaStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup cw multiplies rows 64 cw .. 64 cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4,
              lane = threadIdx.x % 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      raster(t, tiles_m, tiles_n, tm, tn);
      float acc[BN / 128][64];
#pragma unroll
      for (int h = 0; h < BN / 128; ++h) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
        c3w::fence_acc(acc[h]);
      }
      int prev = -1;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = stages + stage * Cfg::kStage + cw * 8192;
        const uint32_t sb = stages + stage * Cfg::kStage + Cfg::kA;
        c3w::wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t da = kTransA ? desc_sw128(sa + ks * 2048, 8192, 1024)
                                      : desc_sw128(sa + ks * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < BN / 128; ++h)
            mma_ss_n128<kTransA ? 1 : 0, 1>(
                acc[h], da,
                desc_sw128(sb + h * 2 * kBoxBytes + ks * 2048, kBoxBytes,
                           1024));
        }
        c3w::wg_commit();
        c3w::wg_wait<1>();  // k-step kb - 1 is done: its stage is free
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kTmaStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      c3w::wg_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int h = 0; h < BN / 128; ++h) c3w::fence_acc(acc[h]);
      // accumulator rows lane / 4 (+ 8) of warp `warp`'s 16, columns
      // 8 c + 2 (lane % 4) (+ 1) of each n128 half; n % 8 == 0, so a pair
      // is in or out together
      const int row0 = tm * kTmaBM + 64 * cw + 16 * warp + lane / 4;
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int col = tn * BN + 128 * h + 8 * c + 2 * (lane % 4);
          if (col >= n) continue;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = row0 + 8 * rr;
            if (row < m)
              store_out2(out, out_f32, static_cast<size_t>(row) * n + col,
                         acc[h][4 * c + 2 * rr], acc[h][4 * c + 2 * rr + 1]);
          }
        }
    }
  }
}

// ---- the narrow variant: trans_a, N <= 24 ---------------------------------

constexpr int kNarrowBM = 128, kNarrowBK = 64, kNarrowChunk = 512;
constexpr int kNarrowStages = 3;
constexpr int kNarrowThreads = 128;
// a's tile for one k step, M-planar: plane g (8 columns of m) holds the 64
// k rows of 16 bytes, planes padded by 16 B so that one row's 16 planes
// land in different bank groups
constexpr int kNarrowPlane = kNarrowBK * 16 + 16;        // 1040
constexpr int kNarrowATile = 16 * kNarrowPlane;          // 16,640
constexpr int kNarrowBPlane = kNarrowChunk * 16;         // 8 n of the chunk

template <int NT>
constexpr int narrow_smem() {
  return kNarrowStages * kNarrowATile + (NT / 8) * kNarrowBPlane;
}

// d (m64 x n8, fp32) += A (m64 x k16 bf16, registers) x B (k16 x n8
// bf16, MN-major in shared memory through `db`)
__device__ __forceinline__ void mma_rs_n8(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n16, fp32) += A (m64 x k16 bf16, registers) x B (k16 x n16
// bf16, MN-major in shared memory through `db`)
__device__ __forceinline__ void mma_rs_n16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n24, fp32) += A (m64 x k16 bf16, registers) x B (k16 x n24
// bf16, MN-major in shared memory through `db`)
__device__ __forceinline__ void mma_rs_n24(float (&d)[12],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NT>
__device__ __forceinline__ void mma_rs(float (&d)[NT / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NT == 8)
    mma_rs_n8(d, a, db);
  else if constexpr (NT == 16)
    mma_rs_n16(d, a, db);
  else
    mma_rs_n24(d, a, db);
}

// grid (M tiles of 128, K chunks); block (x, z) writes out[z][m][n] for
// rows 128 x .. and k in [512 z, min(k, 512 z + 512))
template <int NT>
__global__ void __launch_bounds__(kNarrowThreads) pdot_narrow(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    void* __restrict__ out, bool out_f32, int m, int n, int k) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kNarrowBM;
  const int kbeg = blockIdx.y * kNarrowChunk;
  const int kend = min(k, kbeg + kNarrowChunk);
  const uint32_t abase = c3w::smem_u32(smem);
  const uint32_t bbase = abase + kNarrowStages * kNarrowATile;
  auto load = [&](int s, uint32_t dst) {
    const int k0 = kbeg + s * kNarrowBK;
    for (int i = tid; i < kNarrowBK * 16; i += kNarrowThreads) {
      const int kk = i / 16, g = i % 16;
      const int row = k0 + kk, col = m0 + 8 * g;
      const bool ok = row < kend && col < m;
      c3w::cp_async16(dst + g * kNarrowPlane + kk * 16,
                      ok ? a + static_cast<size_t>(row) * m + col : a, ok);
    }
  };
  const int steps = (kend - kbeg + kNarrowBK - 1) / kNarrowBK;
#pragma unroll
  for (int s = 0; s < kNarrowStages - 1; ++s) {
    if (s < steps) load(s, abase + s * kNarrowATile);
    c3w::cp_async_commit();
  }
  // b's chunk, N-major planes of 8 columns, zeros past n and kend
  bf16* bs = reinterpret_cast<bf16*>(smem + kNarrowStages * kNarrowATile);
#pragma unroll 8
  for (int i = tid; i < kNarrowChunk * NT; i += kNarrowThreads) {
    const int kk = i / NT, j = i % NT;
    bs[(j / 8) * (kNarrowBPlane / 2) + kk * 8 + j % 8] =
        (kbeg + kk < kend && j < n)
            ? b[static_cast<size_t>(kbeg + kk) * n + j]
            : __float2bfloat16_rn(0.f);
  }
  float acc[2][NT / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[t][i] = 0.f;
    c3w::fence_acc(acc[t]);
  }
  // this lane's ldmatrix.trans row: k (lane % 8) + 8 (lane / 16) of plane
  // 2 warp + (lane / 8) % 2, i.e. A = a^T rows 16 warp .. + 15 of an m64
  const uint32_t a_off = (2 * warp + ((lane >> 3) & 1)) * kNarrowPlane
                         + ((lane & 7) + 8 * (lane >> 4)) * 16;
  for (int s = 0; s < steps; ++s) {
    c3w::cp_async_wait<kNarrowStages - 2>();
    c3w::fence_async_smem();  // b's staged chunk, for wgmma's reads
    __syncthreads();          // step s landed; step s - 1's buffer is free
    const int nx = s + kNarrowStages - 1;
    if (nx < steps) load(nx, abase + (nx % kNarrowStages) * kNarrowATile);
    c3w::cp_async_commit();
    const uint32_t st = abase + (s % kNarrowStages) * kNarrowATile;
    uint32_t af[4][2][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        c3w::ldsm_x4_trans(st + t * 8 * kNarrowPlane + a_off + ks * 256,
                           af[ks][t]);
    c3w::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = c3w::desc(
          bbase + (s * kNarrowBK + ks * 16) * 16, 128, kNarrowBPlane);
#pragma unroll
      for (int t = 0; t < 2; ++t) mma_rs<NT>(acc[t], af[ks][t], db);
    }
    c3w::wg_commit();
    c3w::wg_wait<0>();  // af is reloaded next step
  }
  c3w::cp_async_wait<0>();
  c3w::fence_acc(acc[0]);
  c3w::fence_acc(acc[1]);
  const size_t zoff = static_cast<size_t>(blockIdx.y) * m * n;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 64 * t + 16 * warp + lane / 4 + 8 * rr;
          const int col = 8 * c + 2 * (lane % 4) + e;
          if (row < m && col < n)
            store_out(out, out_f32, zoff + static_cast<size_t>(row) * n + col,
                      acc[t][4 * c + 2 * rr + e]);
        }
}

// ---- launches ------------------------------------------------------------

template <bool kTransA, bool kVecA, bool kVecB>
cudaError_t launch_bf16(dim3 grid, cudaStream_t s, const void* a,
                        const void* b, void* out, bool out_f32, int m, int n,
                        int k, int k_chunk) {
  pdot_bf16<kTransA, kVecA, kVecB><<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), out,
      out_f32, m, n, k, k_chunk);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(bool trans, bool va, bool vb, dim3 grid,
                          cudaStream_t s, const void* a, const void* b,
                          void* out, bool out_f32, int m, int n, int k,
                          int k_chunk) {
  using Fn = cudaError_t (*)(dim3, cudaStream_t, const void*, const void*,
                             void*, bool, int, int, int, int);
  static const Fn table[8] = {
      launch_bf16<false, false, false>, launch_bf16<false, false, true>,
      launch_bf16<false, true, false>,  launch_bf16<false, true, true>,
      launch_bf16<true, false, false>,  launch_bf16<true, false, true>,
      launch_bf16<true, true, false>,   launch_bf16<true, true, true>};
  return table[(trans ? 4 : 0) | (va ? 2 : 0) | (vb ? 1 : 0)](
      grid, s, a, b, out, out_f32, m, n, k, k_chunk);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool vec_ok(const void* p, int ld) { return aligned16(p) && ld % 8 == 0; }

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so the library needs no -lcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a row-major (outer, inner) bf16 matrix read in
// (box_inner, box_outer) boxes with the 128-byte swizzle; out-of-bounds
// elements read as zero
bool make_map(CUtensorMap* map, const void* base, int inner, int outer,
              int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kTransA>
cudaError_t launch_tma(const void* a, const void* b, void* out, bool out_f32,
                       int m, int n, int k, cudaStream_t s) {
  CUtensorMap ta, tb;
  const bool ok =
      (kTransA ? make_map(&ta, a, m, k, 64, 64)
               : make_map(&ta, a, k, m, kTmaBK, kTmaBM))
      && make_map(&tb, b, n, k, 64, 64);
  if (!ok) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pdot_tma<BN, kTransA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TmaCfg<BN>::kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((m + kTmaBM - 1) / kTmaBM)
                          * ((n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  pdot_tma<BN, kTransA><<<grid, kTmaThreads, TmaCfg<BN>::kSmem, s>>>(
      ta, tb, out, out_f32, m, n, k);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_narrow(const void* a, const void* b, void* out,
                          bool out_f32, int m, int n, int k, int splits,
                          cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      pdot_narrow<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      narrow_smem<NT>());
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kNarrowBM - 1) / kNarrowBM, splits);
  pdot_narrow<NT><<<grid, kNarrowThreads, narrow_smem<NT>(), s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), out, out_f32,
      m, n, k);
  return cudaGetLastError();
}

// the preconditions of `variant` for these operands (see the note at the
// top); the wrapper's rule only picks a variant that meets them
bool variant_ok(int variant, const void* a, const void* b, int m, int n,
                int k, bool trans, int in_dtype, int splits, int k_chunk) {
  switch (variant) {
    case kVarF32:
      return in_dtype == kF32 && k_chunk % FK == 0
             && (n + FN - 1) / FN <= kMaxGridYZ;
    case kVarWmma:
      return in_dtype == kBF16 && k_chunk % TK == 0
             && (n + TN - 1) / TN <= kMaxGridYZ;
    case kVarTma:
      return in_dtype == kBF16 && splits == 1 && aligned16(a)
             && aligned16(b) && (trans ? m : k) % 8 == 0 && n % 8 == 0;
    case kVarNarrow:
      return in_dtype == kBF16 && trans && n <= 24 && m % 8 == 0
             && aligned16(a) && k_chunk == kNarrowChunk;
    default:
      return false;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a (M, K) or, with trans_a, (K, M); b (K, N); out (M, N); all row-major
// contiguous. in_dtype / out_dtype: 0 fp32, 1 bf16. variant: 0 fp32,
// 1 wmma, 2 tma, 3 narrow, chosen by the wrapper's `pdot_plan`; splits K
// chunks of k_chunk (the last one shorter), ws an fp32 (splits, M, N)
// workspace when splits > 1, else unused.
extern "C" int pdot_launch(const void* a, const void* b, void* out, void* ws,
                           int m, int n, int k, int trans_a, int in_dtype,
                           int out_dtype, int variant, int splits,
                           int k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool trans = trans_a != 0;
  const bool dt_ok = (in_dtype == kF32 || in_dtype == kBF16)
                     && (out_dtype == kF32 || out_dtype == kBF16);
  if (m <= 0 || n <= 0 || k <= 0 || !dt_ok || splits < 1
      || splits > kMaxGridYZ || k_chunk < 1
      || static_cast<long long>(splits - 1) * k_chunk >= k
      || static_cast<long long>(splits) * k_chunk < k
      || (splits > 1 && ws == nullptr)
      || !variant_ok(variant, a, b, m, n, k, trans, in_dtype, splits,
                     k_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  void* dst = splits > 1 ? ws : out;
  const bool dst_f32 = splits > 1 || out_dtype == kF32;
  cudaError_t err;
  if (variant == kVarTma) {
    err = trans ? launch_tma<kTmaBN, true>(a, b, dst, dst_f32, m, n, k, s)
                : launch_tma<kTmaBN, false>(a, b, dst, dst_f32, m, n, k, s);
  } else if (variant == kVarNarrow) {
    err = n <= 8    ? launch_narrow<8>(a, b, dst, dst_f32, m, n, k, splits, s)
          : n <= 16 ? launch_narrow<16>(a, b, dst, dst_f32, m, n, k, splits, s)
                    : launch_narrow<24>(a, b, dst, dst_f32, m, n, k, splits,
                                        s);
  } else if (variant == kVarWmma) {
    const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, splits);
    err = dispatch_bf16(trans, vec_ok(a, trans ? m : k), vec_ok(b, n), grid,
                        s, a, b, dst, dst_f32, m, n, k, k_chunk);
  } else {
    const dim3 grid((m + FM - 1) / FM, (n + FN - 1) / FN, splits);
    if (trans)
      pdot_f32<true><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), dst,
          dst_f32, m, n, k, k_chunk);
    else
      pdot_f32<false><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), dst,
          dst_f32, m, n, k, k_chunk);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t blocks = (mn + kThreads - 1) / kThreads;
  pdot_reduce<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                kThreads, 0, s>>>(static_cast<const float*>(ws), out,
                                  out_dtype == kF32, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
