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
// cast to T. b1 comes as fp32 values already rounded to T, b2 in fp32.
//
// Bound on this card: operations. At 512x512 (Hp = Wp = 522) one image costs
// 0.93 GFLOP in conv1_1 and 19.8 GFLOP in conv1_2, ~1.33 TFLOP at B=64:
// ~1.35 ms at the 989 TFLOP/s bf16 tensor-core peak, while the bytes (input
// 105 MB + output 550 MB in bf16) need ~0.2 ms. The conv1_1 activation
// (2.2 GB at B=64 in bf16) never reaches device memory.
//
// bf16 (serving's and stage 2's dtype) runs on the tensor cores,
// `block1_fused_wgmma`: persistent blocks of two warpgroups, one an SM,
// walk tiles of 8x8 pooled pixels in (b, ty, tx) order. The packed k2 image
// (72 KB, `pack_conv_weights` in ops/block1_fused.py) and conv1_1's packed
// B (27 taps x channels zero-padded to K = 32, 4 KB) are loaded once for
// the block's life. Per tile:
//   1. the tile's 20x20x3 input patch goes from registers (loaded while the
//      previous tile was multiplied; zeros past Hp or Wp) to shared memory;
//   2. conv1_1 on wgmma: M = the 18x18 = 324 c11 pixels of the tile padded
//      to six m64 tiles (three a warpgroup), K = 32 (two k16 steps), N = 64.
//      Each thread gathers its A fragment straight from the patch (a tap k
//      = (kh * 3 + kw) * 3 + ci of pixel (iy, ix) is patch element
//      (iy + kh, ix + kw, ci)), so no im2col tile is written; the epilogue
//      rounds to bf16, adds b1 in bf16, applies ReLU and stores the 18x18x64
//      c11 tile in the swizzled layout `c3w::conv_mainloop` reads;
//   3. conv1_2 on `c3w::conv_mainloop` (csrc/conv3x3_wgmma.cuh), unchanged,
//      then K3's pool epilogue `c3w::PoolStore`.
// c11 pixels past Hp-2 or Wp-2 only feed conv1_2 outputs that PoolStore
// masks, so the VALID edges need no zero c11; only the input reads stay in
// bounds. Shared memory: 72 KB + 4 KB weights, a 40.5 KB c11 tile and a
// 2.4 KB patch: one block an SM, two barriers a tile.
//
// fp32 keeps the CUDA-core kernel (wgmma has no fp32 product and TF32 would
// miss the fp32 bars): one 256-thread block per 8x8 tile of pooled outputs.
// The block stages its 20x20x3 input patch and conv1_1's weights in shared
// memory, then walks the 64 conv1_1 channels in chunks of 8: it computes the
// chunk's 18x18 conv1_1 activations into shared memory, stages the matching
// 3x3x8x64 slice of conv1_2's weights, and each thread accumulates one
// pooled pixel's 2x2 conv1_2 window for 16 output channels in 64 fp32
// registers. ReLU and the 2x2 max run in registers and only the pooled value
// is stored. The conv1_2 window accumulation and the pooled store live in
// csrc/block1_tile.cuh, shared with the training kernels.

#include "block1_tile.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using namespace b1tile;
using bf16 = __nv_bfloat16;

constexpr int kIH = 2 * kTPH + 4;          // input tile rows (20)
constexpr int kIW = 2 * kTPW + 4;          // input tile cols (20)

__global__ void __launch_bounds__(kThreads) block1_kernel(
    const float* __restrict__ x,    // (B, Hp, Wp, 3)
    const float* __restrict__ k1,   // (3, 3, 3, 64) HWIO
    const float* __restrict__ b1,   // (64)
    const float* __restrict__ k2,   // (3, 3, 64, 64) HWIO
    const float* __restrict__ b2,   // (64)
    float* __restrict__ out,        // (B, PH, PW, 64)
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

  const float* xb = x + static_cast<size_t>(b) * hp * wp * 3;
  for (int i = tid; i < kIH * kIW * 3; i += kThreads) {
    const int c = i % 3;
    const int p = i / 3;
    const int yy = p / kIW, xx = p % kIW;
    const int gy = oy + yy, gx = ox + xx;
    xin[c][yy][xx] = (gy < hp && gx < wp)
        ? xb[(static_cast<size_t>(gy) * wp + gx) * 3 + c] : 0.f;
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
      c11[cl][yy][xx] = fmaxf(s + b1s[co], 0.f);
    }
    stage_weights(k2s, k2, chunk, tid);  // the matching conv1_2 slice
    __syncthreads();
    accumulate_chunk(c11, k2s, win, acc);
  }

  store_pooled<float>(acc, b2, out + static_cast<size_t>(b) * ph * pw * kC,
                      py0 + win.ly, px0 + win.lx, ph, pw, win);
}

// ---- bf16 on the tensor cores -------------------------------------------

constexpr int kPatch = c3w::kIn + 2;                 // input patch side (20)
constexpr int kPatchElems = kPatch * kPatch * 3;     // 1200
constexpr int kPatchLoads = (kPatchElems + c3w::kConvThreads - 1)
                            / c3w::kConvThreads;     // 5 a thread
constexpr int kC11Pix = c3w::kIn * c3w::kIn;         // 324
constexpr int kK1Bytes = 2 * c3w::kStepBytes;        // conv1_1's B, K = 32
constexpr int kK1Off = c3w::kWBytes;
constexpr int kC11Off = kK1Off + kK1Bytes;
constexpr int kPatchOff = kC11Off + c3w::kTileBytes;
constexpr int kFusedSmem = kPatchOff + kPatchElems * 2;  // 121,696

__global__ void __launch_bounds__(c3w::kConvThreads, 1) block1_fused_wgmma(
    const bf16* __restrict__ x,        // (B, Hp, Wp, 3)
    const bf16* __restrict__ k1pack,   // conv1_1's packed B (2 k16 steps)
    const float* __restrict__ b1,      // (64), rounded to bf16
    const bf16* __restrict__ k2pack,   // conv1_2's packed B (36 steps)
    const float* __restrict__ b2,      // (64)
    bf16* __restrict__ out,            // (B, PH, PW, 64)
    int batch, int hp, int wp, int tiles_y, int tiles_x) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const uint32_t wts = c3w::smem_u32(smem);
  const uint32_t k1s = wts + kK1Off, c11 = wts + kC11Off;
  uint8_t* const c11p = smem + kC11Off;
  bf16* const patch = reinterpret_cast<bf16*>(smem + kPatchOff);
  const int ph = (hp - 4) / 2, pw = (wp - 4) / 2;
  const int per_img = tiles_y * tiles_x, total = batch * per_img;

  c3w::load_weights(wts, k2pack, tid);
  for (int i = tid; i < kK1Bytes / 16; i += c3w::kConvThreads)
    c3w::cp_async16(k1s + i * 16, k1pack + i * 8, true);
  c3w::cp_async_commit();

  // this thread's A-fragment taps: register (hi, e) of k16 step ks holds
  // k = 16 ks + 8 hi + 2 (lane % 4) + e; its offset in the patch, -1 for
  // the zero padding past k = 26
  int koff[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * ks + 8 * hi + 2 * (lane % 4) + e;
        koff[ks][hi][e] = k < 27
            ? ((k / 9) * kPatch + (k / 3) % 3) * 3 + k % 3 : -1;
      }
  // b1 of this thread's accumulator channels 8 c + 2 (lane % 4) + j
  float b1r[8][2];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) b1r[c][j] = b1[8 * c + 2 * (lane % 4) + j];

  // patch element i = tid + 256 j: row i / 60 of the tile's 20 input rows,
  // column-channel r = i % 60 of its contiguous 20x3 run; zeros past the
  // image
  bf16 v[kPatchLoads];
  auto fetch = [&](int tile) {
    const int b = tile / per_img, ty = (tile % per_img) / tiles_x,
              tx = tile % tiles_x;
    const int y0 = 2 * c3w::kWin * ty, x0 = 2 * c3w::kWin * tx;
    const bf16* img = x + static_cast<size_t>(b) * hp * wp * 3;
#pragma unroll
    for (int j = 0; j < kPatchLoads; ++j) {
      const int i = tid + c3w::kConvThreads * j;
      const int iy = i / (3 * kPatch), r = i % (3 * kPatch);
      const int y = y0 + iy, xx = x0 + r / 3;
      v[j] = (i < kPatchElems && y < hp && xx < wp)
          ? img[(static_cast<size_t>(y) * wp + x0) * 3 + r]
          : __float2bfloat16_rn(0.f);
    }
  };

  if (static_cast<int>(blockIdx.x) < total) fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
#pragma unroll
    for (int j = 0; j < kPatchLoads; ++j) {
      const int i = tid + c3w::kConvThreads * j;
      if (i < kPatchElems) patch[i] = v[j];
    }
    const int next = tile + gridDim.x;
    if (next < total) fetch(next);  // in flight through both convolutions
    c3w::cp_async_wait<0>();        // the weights (first tile only)
    c3w::fence_async_smem();
    __syncthreads();  // the patch is staged; the last c11 tile is consumed

    // conv1_1: rows m = 64 (3 wg + i) + 16 warp + lane / 4 + 8 h of the
    // six m64 tiles are c11 pixels m = 18 iy + ix of the tile (m < 324)
    float acc1[3][32];
    uint32_t a[3][2][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int t = 0; t < 32; ++t) acc1[i][t] = 0.f;
      c3w::fence_acc(acc1[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * (3 * wg + i) + 16 * warp + lane / 4 + 8 * h;
        const bool ok = m < kC11Pix;
        const int base = ok ? ((m / c3w::kIn) * kPatch + m % c3w::kIn) * 3 : 0;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            bf16 e[2];
#pragma unroll
            for (int q = 0; q < 2; ++q)
              e[q] = (ok && koff[ks][hi][q] >= 0)
                  ? patch[base + koff[ks][hi][q]] : __float2bfloat16_rn(0.f);
            const __nv_bfloat162 pr = __halves2bfloat162(e[0], e[1]);
            a[i][ks][h + 2 * hi] = *reinterpret_cast<const uint32_t*>(&pr);
          }
      }
    }
    c3w::wg_fence();
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        c3w::mma<0>(acc1[i], a[i][ks],
                    c3w::desc(k1s + ks * c3w::kStepBytes, 128, 256));
    c3w::wg_commit();
    c3w::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      c3w::fence_acc(acc1[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * (3 * wg + i) + 16 * warp + lane / 4 + 8 * h;
        if (m >= kC11Pix) continue;
        const int sw = ((m % c3w::kIn) >> 1) & 7;
        uint8_t* px = c11p + m * 128 + 4 * (lane % 4);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float r[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float s = __bfloat162float(
                __float2bfloat16_rn(acc1[i][4 * c + 2 * h + j]));
            r[j] = fmaxf(s + b1r[c][j], 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(px + ((c ^ sw) << 4)) =
              __floats2bfloat162_rn(r[0], r[1]);
        }
      }
    }
    __syncthreads();  // the c11 tile is complete

    float acc[2][32];
    c3w::conv_mainloop(c11, wts, wg, warp, lane, acc);
    c3w::PoolStore{b2, out, ph, pw}(tile / per_img, (tile % per_img) / tiles_x,
                                    tile % tiles_x, acc, wg, warp, lane);
  }
  c3w::cp_async_wait<0>();
}

int forward_f32(const void* x, const void* k1, const void* b1,
                const void* k2, const void* b2, void* out, int batch, int hp,
                int wp, cudaStream_t stream) {
  const int ph = (hp - 4) / 2, pw = (wp - 4) / 2;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((pw + kTPW - 1) / kTPW, (ph + kTPH - 1) / kTPH, batch);
  block1_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<const float*>(k2),
      static_cast<const float*>(b2), static_cast<float*>(out), hp, wp, ph,
      pw);
  return static_cast<int>(cudaGetLastError());
}

int forward_wgmma(const void* x, const void* k1p, const void* b1,
                  const void* k2p, const void* b2, void* out, int batch,
                  int hp, int wp, cudaStream_t stream) {
  const int ty = ((hp - 4) / 2 + c3w::kWin - 1) / c3w::kWin;
  const int tx = ((wp - 4) / 2 + c3w::kWin - 1) / c3w::kWin;
  const int64_t tiles = int64_t{batch} * ty * tx;
  if (tiles >= (int64_t{1} << 31) - 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(block1_fused_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFusedSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  block1_fused_wgmma<<<grid, c3w::kConvThreads, kFusedSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k1p),
      static_cast<const float*>(b1), static_cast<const bf16*>(k2p),
      static_cast<const float*>(b2), static_cast<bf16*>(out), batch, hp, wp,
      ty, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype 0 = float32: k1, k2 HWIO fp32, b1 fp32; dtype 1 = bfloat16: k1 and
// k2 the packed wgmma images of `pack_conv_weights` (ops/block1_fused.py),
// b1 fp32 values rounded to bf16. b2 fp32 either way. Hp - 4 and Wp - 4
// even and positive (the wrapper checks).
extern "C" int block1_fused_forward(
    const void* x, const void* k1, const void* b1, const void* k2,
    const void* b2, void* out, int batch, int hp, int wp, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || hp < 6 || wp < 6 || hp % 2 || wp % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return forward_f32(x, k1, b1, k2, b2, out, batch, hp, wp, s);
  if (dtype == 1)
    return forward_wgmma(x, k1, b1, k2, b2, out, batch, hp, wp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
