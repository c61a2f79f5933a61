// Fused VGG block 1: conv1_1 (3->64) + ReLU + conv1_2 (64->64) + ReLU +
// 2x2/2 max-pool, with the conv1_1 activation kept on chip.
//
// Replaces: zeroshotsemanticsegmentation_tpu/ops/block1_fused.py,
// `_kernel_full` (the Pallas TPU kernel launched by `fused_block1_full`).
//
// Input x (B, Hp, Wp, 3) NHWC in T (float or bfloat16), VALID convs, output
// (B, (Hp-4)/2, (Wp-4)/2, 64) NHWC in T, which is channels_last for the
// convolutions that follow. Rounding points follow `_kernel_full`: conv1_1
// accumulates in fp32, rounds to T, adds the bias in T, then ReLU; conv1_2
// accumulates in fp32, adds the bias in fp32, then ReLU, the 2x2 max and the
// cast to T. The wrapper passes the weights and b1 as fp32 values already
// rounded to T, and b2 in fp32.
//
// Bound on this card: operations. At 512x512 (Hp = Wp = 522) one image costs
// 0.93 GFLOP in conv1_1 and 19.8 GFLOP in conv1_2, ~1.33 TFLOP at B=64:
// ~1.35 ms at the 989 TFLOP/s bf16 tensor-core peak, while the bytes (input
// 105 MB + output 550 MB in bf16) need ~0.2 ms. The conv1_1 activation
// (2.2 GB at B=64 in bf16) never reaches device memory.
//
// Design (a first, simple kernel on CUDA cores; tensor cores and TMA are
// later work): one 256-thread block per 8x8 tile of pooled outputs. The
// block stages its 20x20x3 input patch and conv1_1's weights in shared
// memory, then walks the 64 conv1_1 channels in chunks of 8: it computes the
// chunk's 18x18 conv1_1 activations into shared memory, stages the matching
// 3x3x8x64 slice of conv1_2's weights, and each thread accumulates one
// pooled pixel's 2x2 conv1_2 window for 16 output channels in 64 fp32
// registers (a 4x4 activation patch per input channel feeds all 9 taps of
// the 4 pixels). The channel group is uniform within a warp, so the weight
// reads are shared-memory broadcasts. ReLU and the 2x2 max run in registers
// and only the pooled value is stored. Shared memory stays under 48 KB.
// The conv1_2 window accumulation and the pooled store live in
// csrc/block1_tile.cuh, shared with the training kernels.

#include "block1_tile.cuh"

namespace {

using namespace b1tile;

constexpr int kIH = 2 * kTPH + 4;          // input tile rows (20)
constexpr int kIW = 2 * kTPW + 4;          // input tile cols (20)

template <typename T>
__global__ void __launch_bounds__(kThreads) block1_kernel(
    const T* __restrict__ x,        // (B, Hp, Wp, 3)
    const float* __restrict__ k1,   // (3, 3, 3, 64) HWIO, rounded to T
    const float* __restrict__ b1,   // (64), rounded to T
    const float* __restrict__ k2,   // (3, 3, 64, 64) HWIO, rounded to T
    const float* __restrict__ b2,   // (64)
    T* __restrict__ out,            // (B, PH, PW, 64)
    int hp, int wp, int ph, int pw) {
  __shared__ float xin[3][kIH][kIW];
  __shared__ float k1s[27][kC];
  __shared__ float b1s[kC];
  __shared__ float c11[kChunk][kCH][kCW + 1];
  __shared__ __align__(16) float k2s[kChunk][9][kC];

  const Window win(threadIdx.x);
  const int tid = win.tid;
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTPH;
  const int px0 = blockIdx.x * kTPW;
  // the input, conv1_1 and conv1_2 tiles share their origin (2*py0, 2*px0)
  const int oy = 2 * py0, ox = 2 * px0;

  const T* xb = x + static_cast<size_t>(b) * hp * wp * 3;
  for (int i = tid; i < kIH * kIW * 3; i += kThreads) {
    const int c = i % 3;
    const int p = i / 3;
    const int yy = p / kIW, xx = p % kIW;
    const int gy = oy + yy, gx = ox + xx;
    xin[c][yy][xx] = (gy < hp && gx < wp)
        ? to_float<T>(xb[(static_cast<size_t>(gy) * wp + gx) * 3 + c]) : 0.f;
  }
  for (int i = tid; i < 27 * kC; i += kThreads) k1s[i / kC][i % kC] = k1[i];
  if (tid < kC) b1s[tid] = b1[tid];

  float acc[4][kCoGroup];
  zero(acc);

  for (int chunk = 0; chunk < kC / kChunk; ++chunk) {
    __syncthreads();  // inputs staged / previous chunk consumed
    // conv1_1 + bias + ReLU for this chunk's channels over the 18x18 tile
    for (int i = tid; i < kChunk * kCH * kCW; i += kThreads) {
      const int cl = i / (kCH * kCW);
      const int r = i % (kCH * kCW);
      const int yy = r / kCW, xx = r % kCW;
      const int co = chunk * kChunk + cl;
      float s = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            s = fmaf(xin[ci][yy + kh][xx + kw],
                     k1s[(kh * 3 + kw) * 3 + ci][co], s);
      const float v = round_to<T>(round_to<T>(s) + b1s[co]);
      c11[cl][yy][xx] = fmaxf(v, 0.f);
    }
    stage_weights(k2s, k2, chunk, tid);  // the matching conv1_2 slice
    __syncthreads();
    accumulate_chunk(c11, k2s, win, acc);
  }

  store_pooled<T>(acc, b2, out + static_cast<size_t>(b) * ph * pw * kC,
                  py0 + win.ly, px0 + win.lx, ph, pw, win);
}

template <typename T>
int launch(const void* x, const void* k1, const void* b1, const void* k2,
           const void* b2, void* out, int batch, int hp, int wp,
           cudaStream_t stream) {
  const int ph = (hp - 4) / 2, pw = (wp - 4) / 2;
  const dim3 grid((pw + kTPW - 1) / kTPW, (ph + kTPH - 1) / kTPH, batch);
  block1_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<const float*>(k2),
      static_cast<const float*>(b2), static_cast<T*>(out), hp, wp, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16
extern "C" int block1_fused_forward(
    const void* x, const void* k1, const void* b1, const void* k2,
    const void* b2, void* out, int batch, int hp, int wp, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k1, b1, k2, b2, out, batch, hp, wp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, k1, b1, k2, b2, out, batch, hp, wp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
