// Device code shared by the block-1 kernels (csrc/block1_fused.cu,
// csrc/block1_train.cu): a 3x3, 64 -> 64 channel convolution over a tile of
// 8x8 2x2 windows (a 16x16 output region), accumulated in fp32 registers.
//
// A block of 256 threads owns one tile. Thread `tid` owns the 2x2 window
// (ly, lx) = ((tid % 64) / 8, tid % 8) and the 16 output channels of group
// cg = tid / 64 (warp-uniform, so weight reads are shared-memory
// broadcasts): acc[a * 2 + c][j] is output pixel (2 ly + a, 2 lx + c),
// channel cg * 16 + j. The 18x18 input tile is staged 8 channels at a time
// in shared memory with the matching 3x3x8x64 weight slice; a 4x4 input
// patch per channel feeds all 9 taps of the window's 4 pixels.
//
// Weights are HWIO fp32, `w[((kh * 3 + kw) * 64 + ci) * 64 + co]`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace b1tile {

constexpr int kC = 64;                     // block-1 width
constexpr int kTPH = 8, kTPW = 8;          // 2x2 windows per tile
constexpr int kCH = 2 * kTPH + 2;          // input tile rows (18)
constexpr int kCW = 2 * kTPW + 2;          // input tile cols (18)
constexpr int kChunk = 8;                  // input channels per pass
constexpr int kCoGroup = 16;               // output channels per thread
constexpr int kThreads = kTPH * kTPW * (kC / kCoGroup);  // 256

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

struct Window {
  int tid, cg, ly, lx;
  __device__ explicit Window(int t)
      : tid(t), cg(t / (kTPH * kTPW)), ly((t % (kTPH * kTPW)) / kTPW),
        lx(t % kTPW) {}
};

__device__ __forceinline__ void zero(float (&acc)[4][kCoGroup]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < kCoGroup; ++j) acc[q][j] = 0.f;
}

// ws[cl][t][co] = w[(t * 64 + chunk * 8 + cl) * 64 + co]
__device__ __forceinline__ void stage_weights(float (*ws)[9][kC],
                                              const float* __restrict__ w,
                                              int chunk, int tid) {
  for (int i = tid; i < kChunk * 9 * kC; i += kThreads) {
    const int co = i % kC;
    const int t = (i / kC) % 9;
    const int cl = i / (9 * kC);
    ws[cl][t][co] = w[(static_cast<size_t>(t) * kC + chunk * kChunk + cl)
                      * kC + co];
  }
}

// in[cl][yy][xx] = img[y0 + yy, x0 + xx, chunk * 8 + cl] of an (h, w, 64)
// NHWC image, 0 outside it
template <typename T>
__device__ __forceinline__ void stage_input(float (*in)[kCH][kCW + 1],
                                            const T* __restrict__ img, int h,
                                            int w, int y0, int x0, int chunk,
                                            int tid) {
  for (int i = tid; i < kChunk * kCH * kCW; i += kThreads) {
    const int cl = i % kChunk;
    const int p = i / kChunk;
    const int yy = p / kCW, xx = p % kCW;
    const int gy = y0 + yy, gx = x0 + xx;
    in[cl][yy][xx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
        ? to_float<T>(img[(static_cast<size_t>(gy) * w + gx) * kC
                          + chunk * kChunk + cl])
        : 0.f;
  }
}

// one staged chunk of input channels into the window's accumulators
__device__ __forceinline__ void accumulate_chunk(
    const float (*in)[kCH][kCW + 1], const float (*ws)[9][kC],
    const Window& win, float (&acc)[4][kCoGroup]) {
  for (int cl = 0; cl < kChunk; ++cl) {
    float patch[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        patch[i][j] = in[cl][2 * win.ly + i][2 * win.lx + j];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int kh = t / 3, kw = t % 3;
      const float4* wv =
          reinterpret_cast<const float4*>(&ws[cl][t][win.cg * kCoGroup]);
      float wt[kCoGroup];
#pragma unroll
      for (int v = 0; v < kCoGroup / 4; ++v) {
        const float4 f = wv[v];
        wt[4 * v] = f.x; wt[4 * v + 1] = f.y;
        wt[4 * v + 2] = f.z; wt[4 * v + 3] = f.w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float xv = patch[a + kh][c + kw];
#pragma unroll
          for (int j = 0; j < kCoGroup; ++j)
            acc[a * 2 + c][j] = fmaf(xv, wt[j], acc[a * 2 + c][j]);
        }
    }
  }
}

// the whole 3x3 conv of the tile whose input origin is (y0, x0) on an
// (h, w, 64) NHWC image (0 outside it), all 64 input channels
template <typename T>
__device__ __forceinline__ void conv_tile(const T* __restrict__ img, int h,
                                          int w, int y0, int x0,
                                          const float* __restrict__ wts,
                                          const Window& win,
                                          float (&acc)[4][kCoGroup]) {
  __shared__ float in[kChunk][kCH][kCW + 1];
  __shared__ __align__(16) float ws[kChunk][9][kC];
  zero(acc);
  for (int chunk = 0; chunk < kC / kChunk; ++chunk) {
    __syncthreads();  // the previous chunk is consumed
    stage_input<T>(in, img, h, w, y0, x0, chunk, win.tid);
    stage_weights(ws, wts, chunk, win.tid);
    __syncthreads();
    accumulate_chunk(in, ws, win, acc);
  }
}

// + b (fp32), ReLU, 2x2 max, one rounding to T: out[py, px, cg*16 .. +15]
// of a (ph, pw, 64) NHWC image
template <typename T>
__device__ __forceinline__ void store_pooled(const float (&acc)[4][kCoGroup],
                                             const float* __restrict__ b,
                                             T* __restrict__ out, int py,
                                             int px, int ph, int pw,
                                             const Window& win) {
  if (py >= ph || px >= pw) return;
  T* o = out + (static_cast<size_t>(py) * pw + px) * kC + win.cg * kCoGroup;
#pragma unroll
  for (int j = 0; j < kCoGroup; ++j) {
    const float bias = b[win.cg * kCoGroup + j];
    float m = fmaxf(acc[0][j] + bias, 0.f);
#pragma unroll
    for (int q = 1; q < 4; ++q) m = fmaxf(m, fmaxf(acc[q][j] + bias, 0.f));
    o[j] = from_float<T>(m);
  }
}

}  // namespace b1tile
