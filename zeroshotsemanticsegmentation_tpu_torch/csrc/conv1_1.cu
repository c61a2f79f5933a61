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
// values in T (the wrapper passes k1 rounded to T, as fp32), the 27 products
// are summed in fp32, b1 is added in fp32, then ReLU and one rounding to T.
// The taps are added in the order (kh, ci, kw), as the plain version
// `conv1_1_pairs_plain` adds them: for bf16 inputs, whose products are exact
// in fp32, a fused multiply-add rounds as a product and a sum do, and the
// two agree bit for bit.
//
// Bound on this card: bytes. At B=16, 530x530 in bf16 the output is 571 MB
// and the input 27 MB, 0.18 ms at 3.35 TB/s; the 15.4 GFLOP take 0.016 ms at
// the bf16 tensor-core rate (0.23 ms as fp32 FMAs on the CUDA cores, which is
// what this first kernel uses).
//
// Design: one 256-thread block per tile of 2 output rows x 64 columns. The
// block stages its 4x66x3 input patch, k1 and b1 in shared memory. Warp w
// computes channels 8w..8w+7 of all 128 pixels of the tile, 4 pixels per
// lane, in fp32 registers; the channel group is warp-uniform, so every weight
// read is a shared-memory broadcast. The results go through shared memory
// (rows padded by 16 bytes so that the writes do not conflict) and leave as
// 16-byte stores, consecutive threads on consecutive addresses: each tile row
// is one contiguous run of 64 pixels x 64 channels.

#include "block1_tile.cuh"

namespace {

using b1tile::from_float;
using b1tile::to_float;

constexpr int kC = 64;                     // output channels
constexpr int kTR = 2;                     // output rows per tile
constexpr int kTW = 64;                    // output columns per tile
constexpr int kThreads = 256;              // 8 warps, one per 8 channels
constexpr int kPix = kTR * kTW / 32;       // pixels per lane (4)
constexpr int kInH = kTR + 2, kInW = kTW + 2;

template <typename T>
struct Tile {
  static constexpr int kStride = kC + 16 / sizeof(T);  // elements per row
  static constexpr int kChunks = kC * sizeof(T) / 16;  // 16 B per pixel row
};

template <typename T>
__global__ void __launch_bounds__(kThreads) conv1_1_kernel(
    const T* __restrict__ x,        // (B, Hp, Wp, 3)
    const float* __restrict__ k1,   // (3, 3, 3, 64) HWIO, rounded to T
    const float* __restrict__ b1,   // (64)
    T* __restrict__ out,            // (B, Ho, Wo, 64)
    int hp, int wp) {
  __shared__ float xin[3][kInH][kInW];
  __shared__ __align__(16) float k1s[27 * kC];
  __shared__ float b1s[kC];
  __shared__ __align__(16) unsigned char tile_raw[
      kTR * kTW * Tile<T>::kStride * sizeof(T)];
  T* tile = reinterpret_cast<T*>(tile_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ho = hp - 2, wo = wp - 2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTR;
  const int x0 = blockIdx.x * kTW;

  const T* xb = x + static_cast<size_t>(b) * hp * wp * 3;
  for (int i = tid; i < kInH * kInW * 3; i += kThreads) {
    const int c = i % 3;
    const int p = i / 3;
    const int yy = p / kInW, xx = p % kInW;
    const int gy = y0 + yy, gx = x0 + xx;
    xin[c][yy][xx] = (gy < hp && gx < wp)
        ? to_float<T>(xb[(static_cast<size_t>(gy) * wp + gx) * 3 + c]) : 0.f;
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

  // + b1 in fp32, ReLU, one rounding to T, into the staged tile
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = (p / 2) * kTW + lane + 32 * (p % 2);
    T* o = &tile[q * Tile<T>::kStride + co0];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = from_float<T>(fmaxf(acc[p][j] + b1s[co0 + j], 0.f));
  }
  __syncthreads();

  // 16-byte stores of the tile's rows, masked at the image's edge
  constexpr int kChunks = Tile<T>::kChunks;
  const int ncol = min(kTW, wo - x0);
  for (int i = tid; i < kTR * kTW * kChunks; i += kThreads) {
    const int q = i / kChunks, part = i % kChunks;
    const int r = q / kTW, col = q % kTW;
    if (y0 + r >= ho || col >= ncol) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(&tile[q * Tile<T>::kStride]) + 16 * part);
    T* dst = out + ((static_cast<size_t>(b) * ho + y0 + r) * wo + x0 + col) * kC;
    reinterpret_cast<uint4*>(dst)[part] = v;
  }
}

template <typename T>
int launch(const void* x, const void* k1, const void* b1, void* out,
           int batch, int hp, int wp, cudaStream_t stream) {
  const int ho = hp - 2, wo = wp - 2;
  const dim3 grid((wo + kTW - 1) / kTW, (ho + kTR - 1) / kTR, batch);
  conv1_1_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<T*>(out), hp, wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16. Refuses shapes the grid cannot hold.
extern "C" int conv1_1_forward(const void* x, const void* k1, const void* b1,
                               void* out, int batch, int hp, int wp, int dtype,
                               void* stream) {
  if (batch < 1 || batch > 65535 || hp < 3 || wp < 3
      || (hp - 2 + kTR - 1) / kTR > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k1, b1, out, batch, hp, wp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, k1, b1, out, batch, hp, wp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
