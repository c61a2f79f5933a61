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
// In fp32 (the dot-free mode's fp32 steps, the H2D probe's 512^3 product)
// the same products are bound by the 67 TFLOP/s FP32 peak of the CUDA
// cores: fc6 21.28 ms, fc7 3.47 ms, 512^3 0.0040 ms (operations); the
// N = 20 / 2 weight gradients by a's 113.6 MB, 0.034 ms (bytes).
//
// Seven variants; the wrapper (ops/pdot.py, `pdot_plan`) picks one by the
// operands' dtype, shapes and alignment and `pdot_launch` refuses a variant
// whose preconditions fail:
//   tma (bf16; a's and b's rows and bases 16-byte aligned, M and N >= 64):
//     `pdot_tma`, persistent blocks of three warpgroups on a 128 x BN tile
//     (BN = kTmaBN): one thread of the first keeps a ring of k-steps of 64
//     in flight by TMA (128-byte swizzle, out-of-bounds rows and columns
//     zero-filled, `mbarrier` full / empty pairs; csrc/tma_wgmma.cuh, which
//     fc6's implicit-GEMM forward shares); the other two
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
//   fp32, fp32_narrow, fp32_scalar, fp32_narrow_scalar (fp32 inputs):
//     `pdot_f32<trans_a, narrow, vec>`, full fp32 FFMA on the CUDA cores.
//     A 256-thread block computes a 128 x 128 tile (N > 32; each thread
//     8 x 8 outputs as 2 x 2 groups of 4 x 4) or a 256 x 32 tile (N <= 32,
//     the weight gradients into 20 or 2 classes; 8 x 4 a thread), reading
//     its A and B fragments from shared memory as float4: 16 FFMA per
//     shared load on the wide tile (4 x 4 outputs a thread from scalar
//     loads would issue 2, and the load unit would set the pace). a and b
//     stream through a ring of K steps by cp.async (wide: 2 stages of 32;
//     narrow: 4 of 16), out-of-range rows and columns zero-filled: 16-byte
//     copies where a's and b's rows and bases are 16-byte aligned (fp32,
//     fp32_narrow), 4-byte copies otherwise (the _scalar instances).
//     A is K-major: under trans_a a's (K, M) rows land as they are;
//     without it a's (M, K) rows land M-major and each stage is transposed
//     once in shared memory (a float4 along k read, four stores along m),
//     which keeps one inner loop and its registers under the
//     two-blocks-an-SM bound.
//     When the output has fewer tiles than SMs, K splits into up to
//     kF32MaxCluster chunks whose blocks form one thread-block cluster
//     along z: each sums its chunk, parks its partial tile in its own
//     shared memory (the ring's), and after the cluster's barrier reduces a
//     slice of the tile from every rank's partial through distributed
//     shared memory in rank order; one launch, no workspace, each output
//     stored once. (The hardware packs a launch's clusters two blocks to an
//     SM where both fit: at 512^3, 16 clusters of 8 run on about 64 SMs.)
// Split K: narrow always splits K into its fixed 512-deep chunks; wmma
// splits K when the output has fewer tiles than the card has SMs (the
// chunk length the wrapper's rule states); each split writes an fp32
// partial tile and `pdot_reduce` adds the partials in chunk order. The fp32
// variants reduce theirs in the cluster.
// Deterministic: no atomics anywhere, and every variant sums each output
// element over K in one fixed order (within a chunk k ascending, then the
// chunks in order) and rounds it once. Offsets are 64-bit (the fc6 output
// alone has 174 M elements).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "conv3x3_wgmma.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace nvcuda;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// dtype codes and variant codes (ops/pdot.py)
constexpr int kF32 = 0, kBF16 = 1;
constexpr int kVarF32 = 0, kVarWmma = 1, kVarTma = 2, kVarNarrow = 3,
              kVarF32Narrow = 4, kVarF32Scalar = 5, kVarF32NarrowScalar = 6;
constexpr int kThreads = 256;
constexpr int kMaxGridYZ = 65535;

// bf16 tensor-core tiles of the wmma variant
constexpr int TM = 128, TN = 128, TK = 32;
constexpr int kPad = 8;             // bf16 row padding: 16 bytes
// the fp32 variants: two blocks an SM (launch bounds: <= 128 registers a
// thread); split K in clusters of at most the portable 8 blocks
constexpr int kF32MinBlocks = 2, kF32MaxCluster = 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void store_out(void* out, bool out_f32, size_t i,
                                          float v) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
}

using tw::store_out2;

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

// ---- the fp32 variants: CUDA-core tiles on a cp.async ring, split K in a
// thread-block cluster ---------------------------------------------------

// out[row][col .. col + 3] = v, the columns past n dropped; one 16-byte
// store where vec_out (n % 4 == 0 and out 16-byte aligned)
__device__ __forceinline__ void store_row4(void* out, bool out_f32,
                                           bool vec_out, int n, int row,
                                           int col, float4 v) {
  const size_t i = static_cast<size_t>(row) * n + col;
  if (vec_out && col + 3 < n) {
    if (out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = v;
    } else {
      store_out2(out, false, i, v.x, v.y);
      store_out2(out, false, i + 2, v.z, v.w);
    }
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < n) store_out(out, out_f32, i + j, e[j]);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// a 16-byte (kVec) or 4-byte copy, zeros where !valid
template <bool kVec>
__device__ __forceinline__ void cp_f32(uint32_t dst, const float* src,
                                       bool valid) {
  if constexpr (kVec)
    c3w::cp_async16(dst, src, valid);
  else
    cp_async4(dst, src, valid);
}

// The two tiles of a 256-thread block. Each thread owns RG row groups of 4
// rows, BM / RG apart, and CG column groups of 4 columns, BN / CG apart, so
// its A and B fragments are float4 reads of shared memory (A K-major).
//   wide (N > 32):    128 x 128, 16 x 16 threads of 8 x 8 outputs (2 x 2
//                     groups of 4 x 4); K steps of 32, 2 stages;
//   narrow (N <= 32): 256 x 32, 32 x 8 threads of 8 x 4 outputs; K steps of
//                     16, 4 stages (it streams a, bound by bytes).
template <bool kNarrow>
struct F32Tile {
  static constexpr int BM = kNarrow ? 256 : 128;
  static constexpr int BN = kNarrow ? 32 : 128;
  static constexpr int BK = kNarrow ? 16 : 32, STAGES = kNarrow ? 4 : 2;
  // without trans_a a's rows land padded to ALD floats: 16-byte aligned,
  // and the rows that neighbouring threads transpose in other banks
  static constexpr int ALD = BK + 4;
  static constexpr int CG = kNarrow ? 1 : 2;
  static constexpr int NC = 4 * CG;          // columns a thread
  static constexpr int TX = BN / NC, TY = kThreads / TX;
  static constexpr int RG = BM / (4 * TY);
  static constexpr int NR = 4 * RG;          // rows a thread
  static_assert(RG * 4 * TY == BM && (RG == 1 || RG == 2), "row groups");
  // a's stage: K-major [BK][BM] under trans_a, else M-major [BM][ALD];
  // then b's [BK][BN]
  template <bool kTransA>
  __host__ __device__ static constexpr int a_floats() {
    return kTransA ? BK * BM : BM * ALD;
  }
  template <bool kTransA>
  __host__ __device__ static constexpr int stage_floats() {
    return a_floats<kTransA>() + BK * BN;
  }
  // the ring, without trans_a then a K-major [BK][BM] copy of a's stage;
  // or the partial tile that later reuses them
  template <bool kTransA>
  __host__ __device__ static constexpr int smem_bytes() {
    constexpr int kRing =
        STAGES * stage_floats<kTransA>() + (kTransA ? 0 : BK * BM);
    return 4 * (kRing > BM * BN ? kRing : BM * BN);
  }
  // the tile row of a thread's row i
  static __device__ __forceinline__ int row(int ty, int i) {
    return (i / 4) * (BM / RG) + ty * 4 + i % 4;
  }
};

// stage `st` <- the tile's a and b for K rows [k0, k0 + BK), zeros past
// m, kend and n; 16-byte copies with kVec (a's and b's rows and bases
// 16-byte aligned: every copy is whole or wholly out of range)
template <bool kTransA, bool kNarrow, bool kVec>
__device__ __forceinline__ void f32_load(uint32_t st,
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int m,
                                         int n, int k, int m0, int n0, int k0,
                                         int kend) {
  using T = F32Tile<kNarrow>;
  constexpr int V = kVec ? 4 : 1;
  const int tid = threadIdx.x;
  if constexpr (kTransA) {  // a (K, M): its rows land as they are
    constexpr int kRow = T::BM / V;
    for (int c = tid; c < T::BK * kRow; c += kThreads) {
      const int r = c / kRow, col = (c % kRow) * V;
      const bool ok = k0 + r < kend && m0 + col < m;
      cp_f32<kVec>(st + 4 * (r * T::BM + col),
                   ok ? a + static_cast<size_t>(k0 + r) * m + m0 + col : a,
                   ok);
    }
  } else {  // a (M, K): BK columns of each row
    constexpr int kRow = T::BK / V;
    for (int c = tid; c < T::BM * kRow; c += kThreads) {
      const int r = c / kRow, kk = (c % kRow) * V;
      const bool ok = m0 + r < m && k0 + kk < kend;
      cp_f32<kVec>(st + 4 * (r * T::ALD + kk),
                   ok ? a + static_cast<size_t>(m0 + r) * k + k0 + kk : a,
                   ok);
    }
  }
  const uint32_t bs = st + 4 * T::template a_floats<kTransA>();
  constexpr int kRowB = T::BN / V;
  for (int c = tid; c < T::BK * kRowB; c += kThreads) {
    const int r = c / kRowB, col = (c % kRowB) * V;
    const bool ok = k0 + r < kend && n0 + col < n;
    cp_f32<kVec>(bs + 4 * (r * T::BN + col),
                 ok ? b + static_cast<size_t>(k0 + r) * n + n0 + col : b, ok);
  }
}

template <int NR, int NC>
__device__ __forceinline__ void fma_outer(float (&acc)[NR][NC],
                                          const float (&av)[NR],
                                          const float (&bv)[NC]) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// the 4 floats at p (16-byte aligned) into v[0..3]
__device__ __forceinline__ void lds4(float* v, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// at [BK][BM] <- a's M-major stage as [BM][ALD]: a float4 along k read
// from each row, four stores along m (both conflict-free)
template <bool kNarrow>
__device__ __forceinline__ void f32_transpose(const float* as, float* at) {
  using T = F32Tile<kNarrow>;
#pragma unroll
  for (int c = threadIdx.x; c < T::BM * T::BK / 4; c += kThreads) {
    const int r = c % T::BM, k4 = (c / T::BM) * 4;
    const float4 v = *reinterpret_cast<const float4*>(as + r * T::ALD + k4);
    at[k4 * T::BM + r] = v.x;
    at[(k4 + 1) * T::BM + r] = v.y;
    at[(k4 + 2) * T::BM + r] = v.z;
    at[(k4 + 3) * T::BM + r] = v.w;
  }
}

// acc += one stage's BK K rows from K-major A and B, k ascending
template <bool kNarrow>
__device__ __forceinline__ void f32_step(
    const float* as, const float* bs, int tx, int ty,
    float (&acc)[F32Tile<kNarrow>::NR][F32Tile<kNarrow>::NC]) {
  using T = F32Tile<kNarrow>;
  float av[T::NR], bv[T::NC];
#pragma unroll
  for (int kk = 0; kk < T::BK; ++kk) {
#pragma unroll
    for (int g = 0; g < T::RG; ++g)
      lds4(av + 4 * g, as + kk * T::BM + g * (T::BM / T::RG) + ty * 4);
#pragma unroll
    for (int h = 0; h < T::CG; ++h)
      lds4(bv + 4 * h, bs + kk * T::BN + h * (T::BN / T::CG) + tx * 4);
    fma_outer(acc, av, bv);
  }
}

// grid (M tiles, N tiles, splits), launched as clusters of (1, 1, splits):
// the cluster's blocks share one output tile, block z sums K in
// [z * k_chunk, min(K, (z + 1) * k_chunk)) through the ring; with splits >
// 1 each parks its partial tile in its own shared memory and, after the
// cluster's barrier, block z adds its slice of every rank's partial in rank
// order (distributed shared memory) and stores it, rounded once to out.
template <bool kTransA, bool kNarrow, bool kVec>
__global__ void __launch_bounds__(kThreads, kF32MinBlocks) pdot_f32(
    const float* __restrict__ a, const float* __restrict__ b,
    void* __restrict__ out, bool out_f32, bool vec_out, int m, int n, int k,
    int k_chunk) {
  using T = F32Tile<kNarrow>;
  constexpr int kStage = T::template stage_floats<kTransA>();
  constexpr int kAFloats = T::template a_floats<kTransA>();
  extern __shared__ __align__(16) float fsm[];
  cg::cluster_group cluster = cg::this_cluster();
  // the cluster spans the grid's z: block rank == blockIdx.z
  const int splits = static_cast<int>(gridDim.z);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int kbeg = rank * k_chunk, kend = min(k, kbeg + k_chunk);
  const int steps = (kend - kbeg + T::BK - 1) / T::BK;
  const uint32_t base = c3w::smem_u32(fsm);

  float acc[T::NR][T::NC];
#pragma unroll
  for (int i = 0; i < T::NR; ++i)
#pragma unroll
    for (int j = 0; j < T::NC; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < steps)
      f32_load<kTransA, kNarrow, kVec>(base + 4 * s * kStage, a, b, m, n, k,
                                       m0, n0, kbeg + s * T::BK, kend);
    c3w::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    c3w::cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    const int nx = s + T::STAGES - 1;
    if (nx < steps)
      f32_load<kTransA, kNarrow, kVec>(
          base + 4 * (nx % T::STAGES) * kStage, a, b, m, n, k, m0, n0,
          kbeg + nx * T::BK, kend);
    c3w::cp_async_commit();
    const float* st = fsm + (s % T::STAGES) * kStage;
    if constexpr (kTransA) {
      f32_step<kNarrow>(st, st + kAFloats, tx, ty, acc);
    } else {  // a's stage K-major first (every thread is past step s - 1)
      float* at = fsm + T::STAGES * kStage;
      f32_transpose<kNarrow>(st, at);
      __syncthreads();
      f32_step<kNarrow>(at, st + kAFloats, tx, ty, acc);
    }
  }

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < T::NR; ++i) {
      const int row = m0 + T::row(ty, i);
      if (row >= m) continue;
#pragma unroll
      for (int h = 0; h < T::CG; ++h) {
        const int col = n0 + h * (T::BN / T::CG) + tx * 4;
        if (col < n)
          store_row4(out, out_f32, vec_out, n, row, col,
                     make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                 acc[i][4 * h + 2], acc[i][4 * h + 3]));
      }
    }
    return;
  }
  c3w::cp_async_wait<0>();
  __syncthreads();  // the ring is idle: the partial tile takes its place
  float* part = fsm;  // [BM][BN]
#pragma unroll
  for (int i = 0; i < T::NR; ++i)
#pragma unroll
    for (int h = 0; h < T::CG; ++h)
      *reinterpret_cast<float4*>(part + T::row(ty, i) * T::BN
                                 + h * (T::BN / T::CG) + tx * 4) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  cluster.sync();  // every rank's partial is in place
  constexpr int kV = T::BM * T::BN / 4;
  const int hi = kV * (rank + 1) / splits;
  for (int v = kV * rank / splits + threadIdx.x; v < hi; v += kThreads) {
    const int row = m0 + v / (T::BN / 4), col = n0 + (v % (T::BN / 4)) * 4;
    if (row >= m || col >= n) continue;
    // every rank's float4 in flight at once, then added in rank order
    float4 p[kF32MaxCluster];
#pragma unroll
    for (int q = 0; q < kF32MaxCluster; ++q)
      if (q < splits)
        p[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + 4 * v);
    float4 sum = p[0];
#pragma unroll
    for (int q = 1; q < kF32MaxCluster; ++q)
      if (q < splits) {
        sum.x += p[q].x;
        sum.y += p[q].y;
        sum.z += p[q].z;
        sum.w += p[q].w;
      }
    store_row4(out, out_f32, vec_out, n, row, col, sum);
  }
  cluster.sync();  // no block leaves while another reads its partial
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
// (the ring, the consumers' mainloop and the epilogue: csrc/tma_wgmma.cuh)

constexpr int kTmaBN = 256;
constexpr int kGroupM = 16;            // M tiles a raster group spans
constexpr int kBoxBytes = 64 * 64 * 2; // one 64 x 64 bf16 TMA box

template <int BN>
struct TmaCfg {
  static constexpr int kA = tw::kBM * tw::kBK * 2;   // 16 KB
  static constexpr int kB = tw::kBK * BN * 2;
  static constexpr int kStage = kA + kB;
  using Ring = tw::Ring<kStage>;
};

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

// one k-step of consumer `cw` from the stage at `slot`
template <int BN, bool kTransA>
struct TmaMma {
  int cw;
  __device__ __forceinline__ void operator()(uint32_t slot,
                                             float (&acc)[BN / 128][64]) const {
    const uint32_t sa = slot + cw * 8192;
    const uint32_t sb = slot + TmaCfg<BN>::kA;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = kTransA ? tw::desc_sw128(sa + ks * 2048, 8192, 1024)
                                  : tw::desc_sw128(sa + ks * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
        tw::mma_ss_n128<kTransA ? 1 : 0, 1>(
            acc[h], da,
            tw::desc_sw128(sb + h * 2 * kBoxBytes + ks * 2048, kBoxBytes,
                           1024));
    }
  }
};

// A stage holds A as 128 rows x 64 k, K-major, one 16 KB box (or, with
// kTransA, two 64 m x 64 k M-major boxes of 8 KB, one per consumer), then B
// as BN / 64 N-major boxes of 64 n x 64 k; every box 128-byte swizzled in
// 1024-byte atoms of 8 rows. Descriptors: K-major A advances 32 B per k16
// step inside the atom row (sbo = 1024 between 8-row groups); M- and
// N-major operands advance 2048 B (two 8-k atoms) per k16 step, with
// lbo = 8 KB between 64-wide boxes and sbo = 1024 between 8-k atoms.
template <int BN, bool kTransA>
__global__ void __launch_bounds__(tw::kThreads, 1) pdot_tma(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, void* __restrict__ out,
    bool out_f32, int m, int n, int k) {
  using Cfg = TmaCfg<BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  typename Cfg::Ring ring(smem);
  const int tiles_m = (m + tw::kBM - 1) / tw::kBM;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int kblocks = (k + tw::kBK - 1) / tw::kBK;
  const int wg = threadIdx.x / 128;
  ring.init(1);

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        raster(t, tiles_m, tiles_n, tm, tn);
        for (int kb = 0; kb < kblocks; ++kb) {
          ring.wait_empty();
          const uint32_t bar = ring.full_bar();
          tw::mbar_expect_tx(bar, Cfg::kStage);
          const uint32_t sa = ring.slot();
          const uint32_t sb = sa + Cfg::kA;
          if (kTransA) {
            tw::tma_load(sa, &ta, tm * tw::kBM, kb * tw::kBK, bar);
            tw::tma_load(sa + kBoxBytes, &ta, tm * tw::kBM + 64,
                         kb * tw::kBK, bar);
          } else {
            tw::tma_load(sa, &ta, kb * tw::kBK, tm * tw::kBM, bar);
          }
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tw::tma_load(sb + j * kBoxBytes, &tb, tn * BN + 64 * j,
                         kb * tw::kBK, bar);
          ring.next();
        }
      }
    }
  } else {  // consumers: warpgroup cw multiplies rows 64 cw .. 64 cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4,
              lane = threadIdx.x % 32;
    const TmaMma<BN, kTransA> mma{cw};
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      raster(t, tiles_m, tiles_n, tm, tn);
      float acc[BN / 128][64];
      tw::consume_tile<false>(ring, kblocks, lane, acc, mma);
      tw::store_tile(acc, out, out_f32, m, n,
                     tm * tw::kBM + 64 * cw + 16 * warp + lane / 4, tn * BN,
                     lane);
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

using tw::aligned16;

// one fp32 instance as clusters of (1, 1, splits) blocks; its dynamic shared
// memory is opted into once per device
template <bool kTransA, bool kNarrow, bool kVec>
cudaError_t launch_f32(const void* a, const void* b, void* out, bool out_f32,
                       int m, int n, int k, int splits, int k_chunk,
                       cudaStream_t s) {
  using T = F32Tile<kNarrow>;
  constexpr int kSmem = T::template smem_bytes<kTransA>();
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted[dev]) {
    err = cudaFuncSetAttribute(pdot_f32<kTransA, kNarrow, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN,
                     splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec_out = kVec && aligned16(out);
  err = cudaLaunchKernelEx(&cfg, pdot_f32<kTransA, kNarrow, kVec>,
                           static_cast<const float*>(a),
                           static_cast<const float*>(b), out, out_f32,
                           vec_out, m, n, k, k_chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t dispatch_f32(bool trans, bool narrow, bool vec, const void* a,
                         const void* b, void* out, bool out_f32, int m,
                         int n, int k, int splits, int k_chunk,
                         cudaStream_t s) {
  using Fn = cudaError_t (*)(const void*, const void*, void*, bool, int, int,
                             int, int, int, cudaStream_t);
  static const Fn table[8] = {
      launch_f32<false, false, false>, launch_f32<false, false, true>,
      launch_f32<false, true, false>,  launch_f32<false, true, true>,
      launch_f32<true, false, false>,  launch_f32<true, false, true>,
      launch_f32<true, true, false>,   launch_f32<true, true, true>};
  return table[(trans ? 4 : 0) | (narrow ? 2 : 0) | (vec ? 1 : 0)](
      a, b, out, out_f32, m, n, k, splits, k_chunk, s);
}

// the clusters of `splits` blocks of one fp32 instance, launched as
// `launch_f32` launches it, that the card runs at once
template <bool kTransA, bool kNarrow, bool kVec>
cudaError_t f32_max_clusters(int splits, int* clusters) {
  constexpr int kSmem = F32Tile<kNarrow>::template smem_bytes<kTransA>();
  cudaError_t err = cudaFuncSetAttribute(
      pdot_f32<kTransA, kNarrow, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
      clusters, pdot_f32<kTransA, kNarrow, kVec>, &cfg);
}

bool is_f32(int variant) {
  return variant == kVarF32 || variant == kVarF32Narrow
         || variant == kVarF32Scalar || variant == kVarF32NarrowScalar;
}
bool f32_narrow(int variant) {
  return variant == kVarF32Narrow || variant == kVarF32NarrowScalar;
}
bool f32_vec(int variant) {
  return variant == kVarF32 || variant == kVarF32Narrow;
}

bool vec_ok(const void* p, int ld) { return aligned16(p) && ld % 8 == 0; }

using tw::make_map;
using tw::sm_count;

template <int BN, bool kTransA>
cudaError_t launch_tma(const void* a, const void* b, void* out, bool out_f32,
                       int m, int n, int k, cudaStream_t s) {
  CUtensorMap ta, tb;
  const bool ok =
      (kTransA ? make_map(&ta, a, m, k, 64, 64)
               : make_map(&ta, a, k, m, tw::kBK, tw::kBM))
      && make_map(&tb, b, n, k, 64, 64);
  if (!ok) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pdot_tma<BN, kTransA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TmaCfg<BN>::Ring::kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((m + tw::kBM - 1) / tw::kBM)
                          * ((n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  pdot_tma<BN, kTransA><<<grid, tw::kThreads, TmaCfg<BN>::Ring::kSmem, s>>>(
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
    case kVarF32Narrow:
    case kVarF32Scalar:
    case kVarF32NarrowScalar: {
      const bool narrow = f32_narrow(variant);
      const int bn = narrow ? F32Tile<true>::BN : F32Tile<false>::BN;
      const int bk = narrow ? F32Tile<true>::BK : F32Tile<false>::BK;
      return in_dtype == kF32 && k_chunk % bk == 0
             && splits <= kF32MaxCluster && (n + bn - 1) / bn <= kMaxGridYZ
             && (!f32_vec(variant)
                 || (aligned16(a) && aligned16(b) && (trans ? m : k) % 4 == 0
                     && n % 4 == 0));
    }
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

// *clusters = how many clusters of `splits` blocks of the wide fp32 instance
// with 16-byte copies (trans_a or not) the card runs at once: the bound on
// the split-K launches it can place in one wave
extern "C" int pdot_f32_max_clusters(int trans_a, int splits,
                                     int* clusters) {
  if (splits < 1 || splits > kF32MaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      trans_a ? f32_max_clusters<true, false, true>(splits, clusters)
              : f32_max_clusters<false, false, true>(splits, clusters));
}

// a (M, K) or, with trans_a, (K, M); b (K, N); out (M, N); all row-major
// contiguous. in_dtype / out_dtype: 0 fp32, 1 bf16. variant: 0 fp32,
// 1 wmma, 2 tma, 3 narrow, 4 fp32_narrow, 5 fp32_scalar, 6
// fp32_narrow_scalar, chosen by the wrapper's `pdot_plan`; splits K chunks
// of k_chunk (the last one shorter); ws an fp32 (splits, M, N) workspace
// when splits > 1 for wmma and narrow, else unused (the fp32 variants
// reduce their splits inside a cluster).
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
      || (splits > 1 && !is_f32(variant) && ws == nullptr)
      || !variant_ok(variant, a, b, m, n, k, trans, in_dtype, splits,
                     k_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_f32(variant))  // split K reduced inside the cluster
    return static_cast<int>(dispatch_f32(
        trans, f32_narrow(variant), f32_vec(variant), a, b, out,
        out_dtype == kF32, m, n, k, splits, k_chunk, s));
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
  } else {
    const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, splits);
    err = dispatch_bf16(trans, vec_ok(a, trans ? m : k), vec_ok(b, n), grid,
                        s, a, b, dst, dst_f32, m, n, k, k_chunk);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t blocks = (mn + kThreads - 1) / kThreads;
  pdot_reduce<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                kThreads, 0, s>>>(static_cast<const float*>(ws), out,
                                  out_dtype == kF32, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
