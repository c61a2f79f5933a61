// VGG conv1_1 on its own: 3x3 VALID convolution (3 -> 64 channels) + bias +
// ReLU over an NHWC image.
//
// Replaces: zeroshotsemanticsegmentation_tpu/ops/block1_fused.py,
// `_c11_kernel` (the Pallas TPU kernel launched by `conv1_1_pairs`).
//
// Input x (B, Hp, Wp, 3) in T (float or bfloat16), output (B, Hp-2, Wp-2, 64)
// NHWC in T. For even Wp this is the JAX op's packed-pair layout (B, Hp-2,
// (Wp-2)/2, 128) under a view: lane e*64+c of pair q is column 2q+e, channel
// c. The space-to-depth relayout and the 128-lane packing of the TPU kernel
// are not carried over. Rounding points follow `_c11_kernel`: x and k1 are
// values in T, the 27 products are summed in fp32, b1 is added in fp32, then
// ReLU and one rounding to T. The order of the sum is the kernel's own (the
// TPU kernel sums on its matrix unit too): bf16 results may sit one bf16 ulp
// from the plain version's where its fp32 sum lands on the other side of a
// rounding boundary.
//
// Bound on this card: bytes. At B=16, 530x530 in bf16 the output is 571 MB
// and the input 27 MB, 0.18 ms at 3.35 TB/s; the 15.4 GFLOP take 0.016 ms at
// the bf16 tensor-core rate (0.23 ms as fp32 FMAs on the CUDA cores).
//
// bf16, `conv1_1_wgmma`: a GEMM, M = the B*Ho*Wo output pixels in (b, y, x)
// order, N = 64, K = 27 taps padded to 32, on `wgmma` m64n64k16 (two k16
// steps). Persistent blocks of two warpgroups walk tiles of 128 consecutive
// pixels (a tile may cross output rows and images); warpgroup wg takes
// pixels 64 wg .. 64 wg + 63. B is conv1_1's packed weight image from
// `pack_conv_weights` (4 KB, as bf16 K2 reads it), loaded once a block.
// Each thread gathers its A fragment straight from the input in global
// memory (tap k = (kh * 3 + kw) * 3 + ci of pixel (b, y, x) is element
// ((b Hp + y + kh) Wp + x) 3 + k % 9 when k < 27): the next tile's 16 values
// are loaded into registers while this tile is multiplied and stored. The
// epilogue adds b1 in fp32, applies ReLU, rounds once to bf16 and writes
// the tile into one of two 16 KB staging buffers in the 128-byte-swizzled
// [pixel][64] layout (conflict-free stores); one thread then stores it with
// a 2D TMA tensor store over the (B*Ho*Wo, 64) output, which un-swizzles it
// and clips the last tile. The store of tile t runs while tile t+1 is
// computed: a buffer is refilled once `cp.async.bulk.wait_group.read` says
// its store has read it. The tensor map is built per call through the
// runtime's entry-point query (no -lcuda).
//
// fp32 keeps the CUDA-core kernel, `conv1_1_kernel`: one 256-thread block
// per tile of 2 output rows x 64 columns. The block stages its 4x66x3 input
// patch, k1 and b1 in shared memory. Warp w computes channels 8w..8w+7 of
// all 128 pixels of the tile, 4 pixels per lane, in fp32 registers, adding
// the taps in the order (kh, ci, kw); the results leave through shared
// memory as 16-byte stores.

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- fp32 on the CUDA cores ------------------------------------------------

constexpr int kC = 64;                     // output channels
constexpr int kTR = 2;                     // output rows per tile
constexpr int kTW = 64;                    // output columns per tile
constexpr int kThreads = 256;              // 8 warps, one per 8 channels
constexpr int kPix = kTR * kTW / 32;       // pixels per lane (4)
constexpr int kInH = kTR + 2, kInW = kTW + 2;
constexpr int kStride = kC + 4;            // floats per staged pixel row

__global__ void __launch_bounds__(kThreads) conv1_1_kernel(
    const float* __restrict__ x,    // (B, Hp, Wp, 3)
    const float* __restrict__ k1,   // (3, 3, 3, 64) HWIO
    const float* __restrict__ b1,   // (64)
    float* __restrict__ out,        // (B, Ho, Wo, 64)
    int hp, int wp) {
  __shared__ float xin[3][kInH][kInW];
  __shared__ __align__(16) float k1s[27 * kC];
  __shared__ float b1s[kC];
  __shared__ __align__(16) float tile[kTR * kTW * kStride];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ho = hp - 2, wo = wp - 2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTR;
  const int x0 = blockIdx.x * kTW;

  const float* xb = x + static_cast<size_t>(b) * hp * wp * 3;
  for (int i = tid; i < kInH * kInW * 3; i += kThreads) {
    const int c = i % 3;
    const int p = i / 3;
    const int yy = p / kInW, xx = p % kInW;
    const int gy = y0 + yy, gx = x0 + xx;
    xin[c][yy][xx] = (gy < hp && gx < wp)
        ? xb[(static_cast<size_t>(gy) * wp + gx) * 3 + c] : 0.f;
  }
  for (int i = tid; i < 27 * kC; i += kThreads) k1s[i] = k1[i];
  if (tid < kC) b1s[tid] = b1[tid];
  __syncthreads();

  // pixel slot p of this lane: tile row p / 2, column lane + 32 * (p % 2)
  const int co0 = warp * 8;
  float acc[kPix][8];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      float wt[3][8];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float4* wv = reinterpret_cast<const float4*>(
            &k1s[((kh * 3 + kw) * 3 + ci) * kC + co0]);
        const float4 lo = wv[0], hi = wv[1];
        wt[kw][0] = lo.x; wt[kw][1] = lo.y; wt[kw][2] = lo.z; wt[kw][3] = lo.w;
        wt[kw][4] = hi.x; wt[kw][5] = hi.y; wt[kw][6] = hi.z; wt[kw][7] = hi.w;
      }
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const float* xr = &xin[ci][p / 2 + kh][lane + 32 * (p % 2)];
        const float xv[3] = {xr[0], xr[1], xr[2]};
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[p][j] = fmaf(xv[kw], wt[kw][j], acc[p][j]);
      }
    }
  }

  // + b1, ReLU, into the staged tile
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = (p / 2) * kTW + lane + 32 * (p % 2);
    float* o = &tile[q * kStride + co0];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = fmaxf(acc[p][j] + b1s[co0 + j], 0.f);
  }
  __syncthreads();

  // 16-byte stores of the tile's rows, masked at the image's edge
  constexpr int kChunks = kC * 4 / 16;
  const int ncol = min(kTW, wo - x0);
  for (int i = tid; i < kTR * kTW * kChunks; i += kThreads) {
    const int q = i / kChunks, part = i % kChunks;
    const int r = q / kTW, col = q % kTW;
    if (y0 + r >= ho || col >= ncol) continue;
    const float4 v = reinterpret_cast<const float4*>(&tile[q * kStride])[part];
    float* dst = out + ((static_cast<size_t>(b) * ho + y0 + r) * wo + x0 + col)
                 * kC;
    reinterpret_cast<float4*>(dst)[part] = v;
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int kTileM = 128;                      // output pixels a tile
constexpr int kStageBytes = kTileM * kC * 2;     // 16 KB, [pixel][64] bf16
constexpr int kK1Bytes = 2 * c3w::kStepBytes;    // packed B, K = 32
// two staging buffers at a 1024-byte aligned base (the swizzle atom), then
// the weights
constexpr int kWgSmem = 1024 + 2 * kStageBytes + kK1Bytes;   // 37,888

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores committed before the last N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(c3w::kConvThreads, 2) conv1_1_wgmma(
    const __grid_constant__ CUtensorMap out_map,  // (B*Ho*Wo, 64) bf16
    const bf16* __restrict__ x,        // (B, Hp, Wp, 3)
    const bf16* __restrict__ k1pack,   // conv1_1's packed B (2 k16 steps)
    const float* __restrict__ b1,      // (64)
    int batch, int hp, int wp) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const uint32_t raw = c3w::smem_u32(smem_raw);
  const uint32_t stage0 = (raw + 1023) & ~1023u;
  const uint32_t wts = stage0 + 2 * kStageBytes;
  const int ho = hp - 2, wo = wp - 2, hw = ho * wo;
  const int m_total = batch * hw;
  const int tiles = (m_total + kTileM - 1) / kTileM;

  for (int i = tid; i < kK1Bytes / 16; i += c3w::kConvThreads)
    c3w::cp_async16(wts + i * 16, k1pack + i * 8, true);
  c3w::cp_async_commit();

  // this thread's taps: register (hi, e) of k16 step ks holds k = 16 ks +
  // 8 hi + 2 (lane % 4) + e, at offset koff from the pixel's first input
  // element; -1 for the zero padding past k = 26
  int koff[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * ks + 8 * hi + 2 * (lane % 4) + e;
        koff[ks][hi][e] = k < 27 ? (k / 9) * wp * 3 + k % 9 : -1;
      }
  // b1 of this thread's accumulator channels 8 c + 2 (lane % 4) + j
  float b1r[8][2];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) b1r[c][j] = b1[8 * c + 2 * (lane % 4) + j];

  // the taps of accumulator rows r = 16 warp + lane / 4 + 8 h of this
  // warpgroup's m64 half of `tile`, zeros past the last pixel
  bf16 v[2][2][2][2];  // [h][ks][hi][e]
  auto fetch = [&](int tile) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = kTileM * tile + 64 * wg + 16 * warp + lane / 4 + 8 * h;
      const bool ok = m < m_total;
      const int b = m / hw, r = m - b * hw, y = r / wo, xx = r - y * wo;
      const bf16* px =
          x + ((static_cast<size_t>(b) * hp + y) * wp + xx) * 3;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[h][ks][hi][e] = (ok && koff[ks][hi][e] >= 0)
                ? px[koff[ks][hi][e]] : __float2bfloat16_rn(0.f);
    }
  };

  if (static_cast<int>(blockIdx.x) < tiles) fetch(blockIdx.x);
  c3w::cp_async_wait<0>();
  c3w::fence_async_smem();
  __syncthreads();  // the weights have landed
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 pr =
              __halves2bfloat162(v[h][ks][hi][0], v[h][ks][hi][1]);
          a[ks][h + 2 * hi] = *reinterpret_cast<const uint32_t*>(&pr);
        }
    const int next = tile + gridDim.x;
    if (next < tiles) fetch(next);  // in flight through the MMA and store

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    c3w::fence_acc(acc);
    c3w::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      c3w::mma<0>(acc, a[ks], c3w::desc(wts + ks * c3w::kStepBytes, 128, 256));
    c3w::wg_commit();
    c3w::wg_wait<0>();
    c3w::fence_acc(acc);

    // staging buffer it % 2 was last stored by tile it - 2
    const uint32_t stage = stage0 + (it & 1) * kStageBytes;
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 64 * wg + 16 * warp + lane / 4 + 8 * h;
      const uint32_t row = stage + p * 128 + 4 * (lane % 4);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            fmaxf(acc[4 * c + 2 * h] + b1r[c][0], 0.f),
            fmaxf(acc[4 * c + 2 * h + 1] + b1r[c][1], 0.f));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         row + ((c ^ (p & 7)) << 4)),
                     "r"(*reinterpret_cast<const uint32_t*>(&pr))
                     : "memory");
      }
    }
    c3w::fence_async_smem();  // the stores are visible to the TMA store
    __syncthreads();
    if (tid == 0) {
      tma_store(&out_map, stage, 0, kTileM * tile);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the reads
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

int forward_wgmma(const void* x, const void* k1p, const void* b1, void* out,
                  int batch, int hp, int wp, cudaStream_t stream) {
  const int64_t m = int64_t{batch} * (hp - 2) * (wp - 2);
  if (m >= (int64_t{1} << 31) - kTileM)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the output as a (m, 64) bf16 matrix stored in (128, 64) boxes with the
  // 128-byte swizzle; rows past m are not written
  CUtensorMap map;
  const cuuint64_t dims[2] = {kC, static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {kC * 2};
  const cuuint32_t box[2] = {kC, kTileM};
  const cuuint32_t estr[2] = {1, 1};
  if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims, strides, box,
         estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv1_1_wgmma, c3w::kConvThreads, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (m + kTileM - 1) / kTileM;
  const int64_t full = int64_t{sms} * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < full ? tiles : full);
  conv1_1_wgmma<<<grid, c3w::kConvThreads, kWgSmem, stream>>>(
      map, static_cast<const bf16*>(x), static_cast<const bf16*>(k1p),
      static_cast<const float*>(b1), batch, hp, wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype 0 = float32: k1 (3, 3, 3, 64) HWIO fp32; dtype 1 = bfloat16: k1 the
// packed wgmma image of `pack_conv_weights` (ops/block1_fused.py). b1 fp32
// either way. `tile_m` and `smem` are the host's tile plan (`c11_tile_plan`)
// for bf16: pixels a tile and shared memory a block, refused unless they are
// this kernel's (0 for fp32). Refuses shapes the grid or the 32-bit pixel
// index cannot hold.
extern "C" int conv1_1_forward(const void* x, const void* k1, const void* b1,
                               void* out, int batch, int hp, int wp, int dtype,
                               int tile_m, int smem, void* stream) {
  if (batch < 1 || batch > 65535 || hp < 3 || wp < 3
      || (hp - 2 + kTR - 1) / kTR > 65535
      || (dtype == 1 && (tile_m != kTileM || smem != kWgSmem)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int ho = hp - 2, wo = wp - 2;
    const dim3 grid((wo + kTW - 1) / kTW, (ho + kTR - 1) / kTR, batch);
    conv1_1_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(k1),
        static_cast<const float*>(b1), static_cast<float*>(out), hp, wp);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) return forward_wgmma(x, k1, b1, out, batch, hp, wp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
