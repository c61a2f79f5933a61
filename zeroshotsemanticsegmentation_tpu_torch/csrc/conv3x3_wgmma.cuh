// The bf16 3x3, 64 -> 64 channel convolution on Hopper's tensor cores: one
// implicit-GEMM mainloop (`conv_mainloop`) that K3's forward, K4's route
// recompute and K4's dgrad (csrc/block1_train.cu) and K2's conv1_2
// (csrc/block1_fused.cu) all run, K3's and K2's pool epilogue
// (`PoolStore`), and the `wgmma` pieces K4's weight gradient and K7
// (csrc/pdot.cu) build on.
//
// The GEMM: M = a tile's output pixels, N = the 64 output channels, K = 576
// (9 taps x 64 input channels), bf16 products summed in fp32 by
// `wgmma.mma_async` m64n64k16. A block of two warpgroups owns a tile of
// 8x8 2x2 windows (16x16 output pixels, an 18x18 input region); warpgroup
// wg takes window rows 4 wg .. 4 wg + 3 as two m64 tiles, dy = 0 and 1.
// Row m = 16 warp + 8 h + r of tile dy is output pixel
// (2 (4 wg + warp) + dy, 2 r + h) of the tile, so a thread's accumulator
// rows lane/4 and lane/4 + 8 of both tiles (wgmma's D layout) are the four
// pixels of one 2x2 window, in scan order (0,0), (0,1), (1,0), (1,1): the
// pool and the first-max route need no exchange between threads.
//
// Operands. B (weights, k16 x n64 per step) stays in shared memory for a
// persistent block's whole life: the host packs the 9 x 64 x 64 bf16 values
// once per call in the no-swizzle K-major layout a descriptor reads (core
// matrices of 8 n-rows x 16 bytes, LBO = 128 B between the two k-halves of
// a step, SBO = 256 B between n-groups; 2048 B a step, 72 KB in all; see
// `pack_conv_weights` in ops/block1_fused.py). A comes from registers:
// `ldmatrix` reads the 16 rows of a warp at tap-shifted pixel addresses of
// the input tile, so a shifted 3x3 window needs no re-layout. The tile is
// stored a pixel (128 B) at a time with 16-byte chunk g at g ^ ((ix/2) % 8):
// the eight rows of an ldmatrix matrix are pixels 2 apart along x, which
// this swizzle puts in eight different bank groups. Tiles arrive by
// `cp.async` (zero fill outside the image: the VALID conv's ragged edges
// and dgrad's pad-2 border without padding copies) into a double buffer,
// the next tile's copy in flight while the current one is multiplied.
//
// Order of the sums: tap-major (kh, kw), then 16-channel steps, fixed by
// the unrolled loop; so every caller of `conv_mainloop` gets bit-identical
// sums for the same input, which K4's route relies on to recompute K3's
// pre-activations exactly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace c3w {

constexpr int kC = 64;
constexpr int kWin = 8;                       // 2x2 windows per tile side
constexpr int kIn = 2 * kWin + 2;             // input tile side (18)
constexpr int kTileBytes = kIn * kIn * kC * 2;          // 41,472
constexpr int kStepBytes = 16 * kC * 2;       // one packed k16 x n64 step
constexpr int kWBytes = 9 * 4 * kStepBytes;   // 73,728
constexpr int kConvThreads = 256;             // two warpgroups
constexpr int kConvSmem = kWBytes + 2 * kTileBytes;    // 156,672

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's shared-memory writes visible to wgmma's operand reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// a no-swizzle shared-memory matrix descriptor; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across wgmma's
// asynchronous writes
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n64, fp32) += A (m64 x k16 bf16, registers) x B (k16 x n64 bf16,
// shared memory through `db`); kTransB = 1 reads B MN-major (N contiguous)
template <int kTransB>
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(kTransB),
        "r"(1));
}

// the 18x18 input region at (y0, x0) of an (h, w, 64) NHWC bf16 image into
// the swizzled tile at `dst`, zeros outside the image (cp.async, not
// committed)
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* img, int h,
                                          int w, int y0, int x0, int tid) {
  for (int i = tid; i < kIn * kIn * 8; i += kConvThreads) {
    const int p = i >> 3, g = i & 7;
    const int iy = p / kIn, ix = p % kIn;
    const int y = y0 + iy, x = x0 + ix;
    const bool ok = y >= 0 && y < h && x >= 0 && x < w;
    const __nv_bfloat16* src =
        ok ? img + (static_cast<size_t>(y) * w + x) * kC + g * 8 : img;
    cp_async16(dst + p * 128 + ((g ^ ((ix >> 1) & 7)) << 4), src, ok);
  }
}

// the packed weights (kWBytes) into shared memory (cp.async, not committed)
__device__ __forceinline__ void load_weights(uint32_t dst,
                                             const __nv_bfloat16* wpack,
                                             int tid) {
  for (int i = tid; i < kWBytes / 16; i += kConvThreads)
    cp_async16(dst + i * 16, wpack + i * 8, true);
}

// the 3x3 conv of the tile at `tile` with the packed weights at `wts`:
// acc[dy] = warpgroup wg's m64 tile dy (see the note at the top)
__device__ __forceinline__ void conv_mainloop(uint32_t tile, uint32_t wts,
                                              int wg, int warp, int lane,
                                              float (&acc)[2][32]) {
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[dy][i] = 0.f;
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  // this lane's ldmatrix row m = lane % 16 (h = m / 8, r = m % 8) and its
  // 8-channel half of the k16 step
  const int r = lane & 7, h = (lane >> 3) & 1, half = lane >> 4;
  const int wy = 4 * wg + warp;
  uint32_t a[2][2][4];
#pragma unroll
  for (int s = 0; s < 36; ++s) {
    const int t = s / 4, ks = s % 4, kh = t / 3, kw = t % 3;
    const int ix = 2 * r + h + kw;
    const int g = 2 * ks + half;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int iy = 2 * wy + dy + kh;
      ldsm_x4(tile + (iy * kIn + ix) * 128 + ((g ^ ((ix >> 1) & 7)) << 4),
              a[s & 1][dy]);
    }
    wg_fence();
    const uint64_t db = desc(wts + s * kStepBytes, 128, 256);
    mma<0>(acc[0], a[s & 1][0], db);
    mma<0>(acc[1], a[s & 1][1], db);
    wg_commit();
    wg_wait<1>();  // step s - 1 is done: its A registers may be reloaded
  }
  wg_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// the pooled window of accumulator rows (lane / 4, + 8) of both m64 tiles:
// pre-activation of quadrant q = (dy, dx) of channel 8 c + 2 (lane % 4) + j
__device__ __forceinline__ float quad(const float (&acc)[2][32], int q, int c,
                                      int j) {
  return acc[q >> 1][4 * c + 2 * (q & 1) + j];
}

// the pool epilogue of K3 and K2: + b2 in fp32, ReLU, 2x2 max, one rounding
// to bf16; pooled pixels past (ph, pw) are not stored
struct PoolStore {
  const float* b2;
  __nv_bfloat16* out;
  int ph, pw;
  __device__ __forceinline__ void operator()(int b, int ty, int tx,
                                             const float (&acc)[2][32],
                                             int wg, int warp,
                                             int lane) const {
    const int py = kWin * ty + 4 * wg + warp;
    const int px = kWin * tx + lane / 4;
    if (py >= ph || px >= pw) return;
    const int ch = 2 * (lane % 4);
    __nv_bfloat16* o =
        out + ((static_cast<size_t>(b) * ph + py) * pw + px) * kC + ch;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float m[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bias = b2[8 * c + ch + j];
        m[j] = fmaxf(quad(acc, 0, c, j) + bias, 0.f);
#pragma unroll
        for (int q = 1; q < 4; ++q)
          m[j] = fmaxf(m[j], fmaxf(quad(acc, q, c, j) + bias, 0.f));
      }
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * c) =
          __floats2bfloat162_rn(m[0], m[1]);
    }
  }
};

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... of a
// (batch, tiles_y, tiles_x) grid of 16x16-output tiles; tile (ty, tx) reads
// the input region at (16 ty - pad, 16 tx - pad) of the (h, w, 64) image
// `img`. The weights are loaded once; each tile's input is copied while
// the previous one is multiplied. `epi(b, ty, tx, acc, wg, warp, lane)`
// stores a tile's result.
template <class Epilogue>
__device__ __forceinline__ void conv_tiles(const __nv_bfloat16* img, int h,
                                           int w, int pad,
                                           const __nv_bfloat16* wpack,
                                           int batch, int tiles_y,
                                           int tiles_x, const Epilogue& epi) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const uint32_t wts = smem_u32(smem), tiles = wts + kWBytes;
  const int per_img = tiles_y * tiles_x, total = batch * per_img;
  auto load = [&](int tile, uint32_t dst) {
    const int b = tile / per_img, ty = (tile % per_img) / tiles_x,
              tx = tile % tiles_x;
    load_tile(dst, img + static_cast<size_t>(b) * h * w * kC, h, w,
              16 * ty - pad, 16 * tx - pad, tid);
  };
  load_weights(wts, wpack, tid);
  if (static_cast<int>(blockIdx.x) < total) load(blockIdx.x, tiles);
  cp_async_commit();
  int it = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++it) {
    const int next = tile + gridDim.x;
    if (next < total) load(next, tiles + ((it + 1) & 1) * kTileBytes);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the weights) have landed
    fence_async_smem();
    __syncthreads();
    float acc[2][32];
    conv_mainloop(tiles + (it & 1) * kTileBytes, wts, wg, warp, lane, acc);
    epi(tile / per_img, (tile % per_img) / tiles_x, tile % tiles_x, acc, wg,
        warp, lane);
    __syncthreads();  // the buffer is consumed before it is refilled
  }
  cp_async_wait<0>();
}

}  // namespace c3w
