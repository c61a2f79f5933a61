// VGG block 1 under training: conv1_2 (64->64) + bias + ReLU + 2x2/2
// max-pool from the conv1_1 activation in device memory (forward), and its
// recompute backward.
//
// Replaces: zeroshotsemanticsegmentation_tpu/ops/block1_fused.py,
//   forward  `_kernel` (launched by `_conv2_pool_fwd_impl`; K3),
//   backward `_bwd_kernel` (launched by `_conv2_pool_bwd_impl`; K4),
// the two-stage form `fused_block1` that `block1_op` runs under autodiff.
//
// Layouts: c11 (B, Hc, Wc, 64) NHWC in T (float or bfloat16), the ReLU'd
// conv1_1 output; conv1_2 is VALID, so its output is (Hc-2, Wc-2) and the
// pooled output (B, (Hc-2)/2, (Wc-2)/2, 64) in T. Weights come as HWIO fp32
// values for fp32, as the packed bf16 wgmma image for bf16; b2 in fp32.
// Rounding follows `_kernel`: taps in T, fp32 accumulation, + b2 in fp32,
// ReLU, max, one rounding to T.
//
// Bound on this card at B=24, 512x512 (Hc = Wc = 520): operations.
// Forward: 2*24*518^2*576*64 = 474.8 GFLOP, 0.48 ms at the 989 TFLOP/s bf16
// tensor-core peak; its bytes (c11 830 MB + output 206 MB) need 0.31 ms.
// Backward: the recompute, dK2 and d(c11) are 474.8 GFLOP each, 1.44 ms;
// it moves >= 1.87 GB (0.56 ms).
//
// bf16 (the training path's dtype) runs on the tensor cores; these kernels
// replace the CUDA-core fp32-FMA kernels below for bf16, whose floor was
// 7.1 ms a pass at the 67 TFLOP/s fp32 peak:
//   forward `conv2_pool_fwd_wgmma`, route `conv2_pool_route_wgmma` and
//     dgrad `conv2_dgrad_wgmma` are persistent blocks on one mainloop,
//     `c3w::conv_mainloop` (csrc/conv3x3_wgmma.cuh: wgmma m64n64k16, A
//     from registers by ldmatrix at tap-shifted rows, the packed weights in
//     shared memory for the block's life, cp.async double-buffered tiles)
//     with three epilogues: + b2, ReLU, first-max pool, one bf16 store; the
//     same recompute routed to dz; d(c11) from dz padded by 2 (zero fill)
//     with the packed flipped, transposed k2. The forward and the route
//     call the same function on the same tiles, so the route's
//     pre-activations are bit for bit the forward's.
//   `conv2_wgrad_wgmma`: dK2[t] (co x ci) = dz^T x (c11 shifted by t) on
//     wgmma. A block owns a fixed run of kChunkSegs steps of kSeg pixels
//     of one output row; its three warpgroups hold kh = 0, 1, 2 and the
//     three kw taps each (96 fp32 accumulators a thread). A is dz by
//     ldmatrix.trans; B is the c11 rows y + kh read MN-major from
//     channel-planar shared memory, so each kw shift is the descriptor's
//     start address plus 16 B, not a copy. db2 sums warpgroup 0's dz
//     fragments. Partials then `wgrad_reduce`, as for fp32.
// fp32 keeps the CUDA-core kernels (wgmma has no fp32 product, and TF32
// would miss the fp32 bars), one 256-thread block per tile:
//   forward `conv2_pool_fwd`: the tile machinery of block1_fused.cu
//     (csrc/block1_tile.cuh) reading its 18x18 input tile from c11 in
//     device memory, 8 channels at a time; ReLU and the pool run in
//     registers and only the pooled value is stored.
//   backward, three steps plus a reduction (the TPU kernel's grid-carried
//   dK/db accumulators and its overlap-added row segments do not carry over
//   to blocks that run in no order):
//   1. `conv2_pool_route`: the forward tile again, recomputing the 4
//      pre-activations of each 2x2 window; g goes to the first maximum in
//      window scan order (0,0), (0,1), (1,0), (1,1) when its pre-activation
//      is > 0 (ReLU'), else 0. dz (B, Hc-2, Wc-2, 64) is stored in T, as
//      `_bwd_kernel` stores it.
//   2. `conv2_wgrad`: dK2[t][co][ci] = sum over pixels p of dz[p][co] *
//      c11[p + t][ci] as a split-K product: block (chunk, tap) walks one
//      contiguous run of kChunk pixels in 32-pixel steps through shared
//      memory (coalesced 64-channel rows) and keeps a 4x4 (co, ci) tile per
//      thread; tap 0 blocks also sum dz for db2. The run has a fixed length,
//      so each thread's sequential fp32 sum is equally long (and its
//      rounding equally small) at every batch and image size, and the grid
//      grows with the pixels. Each block writes fp32 partials and
//      `wgrad_reduce` adds them in fp64 in a fixed order: deterministic, no
//      atomics.
//   3. `conv_tile` on dz padded by 2 with the flipped, transposed k2 gives
//      d(c11) in gather form: each c11 pixel sums its 3x3 dz neighbours, so
//      no atomics and no overlap-add.

#include "block1_tile.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using namespace b1tile;

constexpr int kSub = 32;      // pixels per shared-memory step of conv2_wgrad
constexpr int kChunk = 4096;  // pixels per conv2_wgrad block
constexpr int kWThreads = 256;
constexpr int kMaxBatch = 65535;  // grid z
static_assert(kChunk % kSub == 0, "a chunk is whole steps");


template <typename T>
__global__ void __launch_bounds__(kThreads) conv2_pool_fwd(
    const T* __restrict__ c11,      // (B, Hc, Wc, 64)
    const float* __restrict__ k2,   // (3, 3, 64, 64) HWIO, rounded to T
    const float* __restrict__ b2,   // (64)
    T* __restrict__ out,            // (B, PH, PW, 64)
    int hc, int wc, int ph, int pw) {
  const Window win(threadIdx.x);
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTPH, px0 = blockIdx.x * kTPW;
  float acc[4][kCoGroup];
  conv_tile<T>(c11 + static_cast<size_t>(b) * hc * wc * kC, hc, wc, 2 * py0,
               2 * px0, k2, win, acc);
  store_pooled<T>(acc, b2, out + static_cast<size_t>(b) * ph * pw * kC,
                  py0 + win.ly, px0 + win.lx, ph, pw, win);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv2_pool_route(
    const T* __restrict__ c11,      // (B, Hc, Wc, 64)
    const float* __restrict__ k2,   // (3, 3, 64, 64) HWIO, rounded to T
    const float* __restrict__ b2,   // (64)
    const T* __restrict__ g,        // (B, PH, PW, 64)
    T* __restrict__ dz,             // (B, 2 PH, 2 PW, 64)
    int hc, int wc, int ph, int pw) {
  const Window win(threadIdx.x);
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTPH, px0 = blockIdx.x * kTPW;
  float acc[4][kCoGroup];
  conv_tile<T>(c11 + static_cast<size_t>(b) * hc * wc * kC, hc, wc, 2 * py0,
               2 * px0, k2, win, acc);
  const int py = py0 + win.ly, px = px0 + win.lx;
  if (py >= ph || px >= pw) return;
  const int ch0 = win.cg * kCoGroup;
  const T* gp = g + ((static_cast<size_t>(b) * ph + py) * pw + px) * kC + ch0;
  T* dzb = dz + static_cast<size_t>(b) * (2 * ph) * (2 * pw) * kC + ch0;
  float dzv[4][kCoGroup];
#pragma unroll
  for (int j = 0; j < kCoGroup; ++j) {
    const float bias = b2[ch0 + j];
    float pre[4], m = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pre[q] = acc[q][j] + bias;
      m = fmaxf(m, fmaxf(pre[q], 0.f));
    }
    int first = 3;
#pragma unroll
    for (int q = 2; q >= 0; --q)
      if (fmaxf(pre[q], 0.f) == m) first = q;
    const float gv = to_float<T>(gp[j]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dzv[q][j] = (q == first && pre[q] > 0.f) ? gv : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int y = 2 * py + q / 2, x = 2 * px + q % 2;
    T* o = dzb + (static_cast<size_t>(y) * (2 * pw) + x) * kC;
#pragma unroll
    for (int j = 0; j < kCoGroup; ++j) o[j] = from_float<T>(dzv[q][j]);
  }
}

// partial[chunk][t][co][ci] and, for tap 0, dbp[chunk][co]
template <typename T>
__global__ void __launch_bounds__(kWThreads) conv2_wgrad(
    const T* __restrict__ dz,       // (B, Ho, Wo, 64)
    const T* __restrict__ c11,      // (B, Ho + 2, Wo + 2, 64)
    float* __restrict__ partial, float* __restrict__ dbp, int ho, int wo,
    int npix) {
  __shared__ __align__(16) float dzs[kSub][kC];
  __shared__ __align__(16) float cs[kSub][kC];
  const int tid = threadIdx.x;
  const int tap = blockIdx.y, kh = tap / 3, kw = tap % 3;
  const int hc = ho + 2, wc = wo + 2;
  const int p_begin = blockIdx.x * kChunk;
  const int p_end = min(npix, p_begin + kChunk);
  const int co0 = (tid / 16) * 4, ci0 = (tid % 16) * 4;
  // loader role: channel `lc` of pixels lp, lp + 4, ..., of each step
  const int lc = tid % kC, lp = tid / kC;
  float acc[4][4] = {};
  float db[4] = {};
  for (int p0 = p_begin; p0 < p_end; p0 += kSub) {
    __syncthreads();  // the previous step is consumed
    for (int s = lp; s < kSub; s += kWThreads / kC) {
      const int p = p0 + s;
      float dv = 0.f, cv = 0.f;
      if (p < p_end) {
        const int x = p % wo;
        const int r = p / wo;
        const int y = r % ho, b = r / ho;
        dv = to_float<T>(dz[static_cast<size_t>(p) * kC + lc]);
        cv = to_float<T>(c11[((static_cast<size_t>(b) * hc + y + kh) * wc
                              + x + kw) * kC + lc]);
      }
      dzs[s][lc] = dv;
      cs[s][lc] = cv;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kSub; ++s) {
      const float4 d = *reinterpret_cast<const float4*>(&dzs[s][co0]);
      const float4 c = *reinterpret_cast<const float4*>(&cs[s][ci0]);
      const float dv[4] = {d.x, d.y, d.z, d.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        db[i] += dv[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dv[i], cv[j], acc[i][j]);
      }
    }
  }
  float* out = partial + (static_cast<size_t>(blockIdx.x) * 9 + tap) * kC * kC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(co0 + i) * kC + ci0 + j] = acc[i][j];
  if (tap == 0 && ci0 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dbp[blockIdx.x * kC + co0 + i] = db[i];
  }
}

// dk[t][co][ci] = sum over chunks of partial, db[co] likewise, in order;
// summed in fp64, so the count of chunks adds no rounding of its own
__global__ void wgrad_reduce(const float* __restrict__ partial,
                             const float* __restrict__ dbp,
                             float* __restrict__ dk, float* __restrict__ db,
                             int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int kDk = 9 * kC * kC;
  if (i < kDk) {
    double s = 0.0;
    for (int c = 0; c < n_chunks; ++c)
      s += partial[static_cast<size_t>(c) * kDk + i];
    dk[i] = static_cast<float>(s);
  } else if (i < kDk + kC) {
    const int co = i - kDk;
    double s = 0.0;
    for (int c = 0; c < n_chunks; ++c) s += dbp[c * kC + co];
    db[co] = static_cast<float>(s);
  }
}

// dc11 (B, Hc, Wc, 64): the 3x3 conv of dz padded by 2 with k2 flipped and
// its channels swapped (kflip[th][tw][co][ci] = k2[2-th][2-tw][ci][co])
template <typename T>
__global__ void __launch_bounds__(kThreads) conv2_dgrad(
    const T* __restrict__ dz,        // (B, Ho, Wo, 64)
    const float* __restrict__ kflip, // (3, 3, 64, 64)
    T* __restrict__ dc11,            // (B, Ho + 2, Wo + 2, 64)
    int ho, int wo) {
  const Window win(threadIdx.x);
  const int b = blockIdx.z;
  const int hc = ho + 2, wc = wo + 2;
  const int y0 = blockIdx.y * 2 * kTPH, x0 = blockIdx.x * 2 * kTPW;
  float acc[4][kCoGroup];
  conv_tile<T>(dz + static_cast<size_t>(b) * ho * wo * kC, ho, wo, y0 - 2,
               x0 - 2, kflip, win, acc);
  T* ob = dc11 + static_cast<size_t>(b) * hc * wc * kC + win.cg * kCoGroup;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int y = y0 + 2 * win.ly + q / 2, x = x0 + 2 * win.lx + q % 2;
    if (y >= hc || x >= wc) continue;
    T* o = ob + (static_cast<size_t>(y) * wc + x) * kC;
#pragma unroll
    for (int j = 0; j < kCoGroup; ++j) o[j] = from_float<T>(acc[q][j]);
  }
}

// ---- bf16 on the tensor cores -------------------------------------------

using bf16 = __nv_bfloat16;
using c3w::PoolStore;
using c3w::quad;

// K4's route: g to the first maximum in window scan order where its
// pre-activation is > 0; dz in bf16
struct RouteStore {
  const float* b2;
  const bf16* g;
  bf16* dz;
  int ph, pw;
  __device__ __forceinline__ void operator()(int b, int ty, int tx,
                                             const float (&acc)[2][32],
                                             int wg, int warp,
                                             int lane) const {
    const int py = c3w::kWin * ty + 4 * wg + warp;
    const int px = c3w::kWin * tx + lane / 4;
    if (py >= ph || px >= pw) return;
    const int ch = 2 * (lane % 4);
    const bf16* gp =
        g + ((static_cast<size_t>(b) * ph + py) * pw + px) * kC + ch;
    bf16* dzb = dz + ((static_cast<size_t>(b) * (2 * ph) + 2 * py) * (2 * pw)
                      + 2 * px) * kC + ch;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const __nv_bfloat162 g2 =
          *reinterpret_cast<const __nv_bfloat162*>(gp + 8 * c);
      const float gv[2] = {__low2float(g2), __high2float(g2)};
      float dzv[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bias = b2[8 * c + ch + j];
        float pre[4], m = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pre[q] = quad(acc, q, c, j) + bias;
          m = fmaxf(m, fmaxf(pre[q], 0.f));
        }
        int first = 3;
#pragma unroll
        for (int q = 2; q >= 0; --q)
          if (fmaxf(pre[q], 0.f) == m) first = q;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dzv[q][j] = (q == first && pre[q] > 0.f) ? gv[j] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<__nv_bfloat162*>(
            dzb + ((q >> 1) * (2 * pw) + (q & 1)) * kC + 8 * c) =
            __floats2bfloat162_rn(dzv[q][0], dzv[q][1]);
    }
  }
};

// K4's dgrad: the tile's 16x16 d(c11) pixels, one rounding to bf16
struct PixelStore {
  bf16* out;
  int h, w;
  __device__ __forceinline__ void operator()(int b, int ty, int tx,
                                             const float (&acc)[2][32],
                                             int wg, int warp,
                                             int lane) const {
    const int ch = 2 * (lane % 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = 2 * (c3w::kWin * ty + 4 * wg + warp) + (q >> 1);
      const int x = 2 * (c3w::kWin * tx + lane / 4) + (q & 1);
      if (y >= h || x >= w) continue;
      bf16* o = out + ((static_cast<size_t>(b) * h + y) * w + x) * kC + ch;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * c) =
            __floats2bfloat162_rn(quad(acc, q, c, 0), quad(acc, q, c, 1));
    }
  }
};

__global__ void __launch_bounds__(c3w::kConvThreads, 1) conv2_pool_fwd_wgmma(
    const bf16* __restrict__ c11, const bf16* __restrict__ wpack,
    const float* __restrict__ b2, bf16* __restrict__ out, int batch, int hc,
    int wc, int tiles_y, int tiles_x) {
  const int ph = (hc - 2) / 2, pw = (wc - 2) / 2;
  c3w::conv_tiles(c11, hc, wc, 0, wpack, batch, tiles_y, tiles_x,
                  PoolStore{b2, out, ph, pw});
}

__global__ void __launch_bounds__(c3w::kConvThreads, 1)
    conv2_pool_route_wgmma(const bf16* __restrict__ c11,
                           const bf16* __restrict__ wpack,
                           const float* __restrict__ b2,
                           const bf16* __restrict__ g, bf16* __restrict__ dz,
                           int batch, int hc, int wc, int tiles_y,
                           int tiles_x) {
  const int ph = (hc - 2) / 2, pw = (wc - 2) / 2;
  c3w::conv_tiles(c11, hc, wc, 0, wpack, batch, tiles_y, tiles_x,
                  RouteStore{b2, g, dz, ph, pw});
}

__global__ void __launch_bounds__(c3w::kConvThreads, 1) conv2_dgrad_wgmma(
    const bf16* __restrict__ dz, const bf16* __restrict__ kflip_pack,
    bf16* __restrict__ dc11, int batch, int ho, int wo, int tiles_y,
    int tiles_x) {
  c3w::conv_tiles(dz, ho, wo, 2, kflip_pack, batch, tiles_y, tiles_x,
                  PixelStore{dc11, ho + 2, wo + 2});
}

// conv2_wgrad_wgmma's plan: a step is kSeg pixels of one conv1_2 output
// row, a block kChunkSegs steps in (b, segment, y) order: consecutive
// steps go down a column of segments, so two of the three c11 rows a step
// reads were read by the step before and come from L2
constexpr int kSeg = 64;
constexpr int kChunkSegs = 64;
// shared memory of one step, channel-planar: 8-channel plane g of pixel p
// at g * plane + 16 p; planes padded by 16 B so that the 8 planes of one
// pixel's copy land in different bank groups
constexpr int kDzPlane = kSeg * 16 + 16;               // 1040
constexpr int kC11Plane = (kSeg + 8) * 16 + 16;        // 1168: >= kSeg + 2
constexpr int kDzBytes = 8 * kDzPlane;
constexpr int kRowBytes = 8 * kC11Plane;
constexpr int kStageBytes = kDzBytes + 3 * kRowBytes;  // 36,352
constexpr int kWgradThreads = 384;                     // warpgroup = kh
constexpr int kWgradSmem = 2 * kStageBytes;

// step s: dz row segment (b, y, x0 .. x0 + 63) and c11 rows y + kh,
// x0 .. x0 + 65, zeros past the row ends (cp.async, not committed)
__device__ __forceinline__ void load_wgrad_step(uint32_t st,
                                                const bf16* __restrict__ dz,
                                                const bf16* __restrict__ c11,
                                                int s, int segs_row, int ho,
                                                int wo, int tid) {
  const int y = s % ho, r = s / ho;
  const int xs = r % segs_row, b = r / segs_row, x0 = xs * kSeg;
  const int hc = ho + 2, wc = wo + 2;
  const bf16* dzr = dz + (static_cast<size_t>(b) * ho + y) * wo * kC;
  for (int i = tid; i < kSeg * 8; i += kWgradThreads) {
    const int p = i >> 3, g = i & 7, x = x0 + p;
    const bool ok = x < wo;
    c3w::cp_async16(st + g * kDzPlane + p * 16,
                    ok ? dzr + static_cast<size_t>(x) * kC + g * 8 : dz, ok);
  }
  for (int i = tid; i < 3 * (kSeg + 2) * 8; i += kWgradThreads) {
    const int g = i & 7, q = i >> 3;
    const int kh = q / (kSeg + 2), p = q % (kSeg + 2), x = x0 + p;
    const bool ok = x < wc;
    const bf16* row = c11 + (static_cast<size_t>(b) * hc + y + kh) * wc * kC;
    c3w::cp_async16(
        st + kDzBytes + kh * kRowBytes + g * kC11Plane + p * 16,
        ok ? row + static_cast<size_t>(x) * kC + g * 8 : c11, ok);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// partial[chunk][t][co][ci] and dbp[chunk][co], as conv2_wgrad writes them
__global__ void __launch_bounds__(kWgradThreads, 1) conv2_wgrad_wgmma(
    const bf16* __restrict__ dz, const bf16* __restrict__ c11,
    float* __restrict__ partial, float* __restrict__ dbp, int ho, int wo,
    int total_segs) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, kh = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const uint32_t base = c3w::smem_u32(smem);
  const int segs_row = (wo + kSeg - 1) / kSeg;
  const int s0 = blockIdx.x * kChunkSegs;
  const int s1 = min(total_segs, s0 + kChunkSegs);
  float acc[3][32];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[kw][i] = 0.f;
    c3w::fence_acc(acc[kw]);
  }
  float db_lo = 0.f, db_hi = 0.f;  // channels 16 warp + lane / 4, + 8
  // this lane's ldmatrix.trans address: pixel (lane % 8) + 8 (lane / 16) of
  // plane 2 warp + (lane / 8) % 2, i.e. A = dz^T rows 16 warp .. + 15
  const uint32_t a_off = (2 * warp + ((lane >> 3) & 1)) * kDzPlane
                         + ((lane & 7) + 8 * (lane >> 4)) * 16;
  load_wgrad_step(base, dz, c11, s0, segs_row, ho, wo, tid);
  c3w::cp_async_commit();
  uint32_t a[2][4];
  for (int s = s0; s < s1; ++s) {
    const int it = s - s0;
    if (s + 1 < s1)
      load_wgrad_step(base + ((it + 1) & 1) * kStageBytes, dz, c11, s + 1,
                      segs_row, ho, wo, tid);
    c3w::cp_async_commit();
    c3w::cp_async_wait<1>();
    c3w::fence_async_smem();
    __syncthreads();
    const uint32_t st = base + (it & 1) * kStageBytes;
    const uint32_t brow = st + kDzBytes + kh * kRowBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t (&ak)[4] = a[ks & 1];
      c3w::ldsm_x4_trans(st + a_off + ks * 256, ak);
      if (kh == 0) {
        db_lo += bf16_lo(ak[0]) + bf16_hi(ak[0]) + bf16_lo(ak[2])
                 + bf16_hi(ak[2]);
        db_hi += bf16_lo(ak[1]) + bf16_hi(ak[1]) + bf16_lo(ak[3])
                 + bf16_hi(ak[3]);
      }
      c3w::wg_fence();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
        c3w::mma<1>(acc[kw], ak,
                    c3w::desc(brow + (ks * 16 + kw) * 16, 128, kC11Plane));
      c3w::wg_commit();
      c3w::wg_wait<1>();
    }
    c3w::wg_wait<0>();
    __syncthreads();  // the stage is consumed before it is refilled
  }
  c3w::cp_async_wait<0>();
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) c3w::fence_acc(acc[kw]);
  const int co = 16 * warp + lane / 4, ci = 2 * (lane % 4);
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    float* out = partial
        + ((static_cast<size_t>(blockIdx.x) * 9 + kh * 3 + kw) * kC + co)
              * kC + ci;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(out + 8 * e * kC + 8 * c) =
            make_float2(acc[kw][4 * c + 2 * e], acc[kw][4 * c + 2 * e + 1]);
  }
  if (kh == 0) {
    db_lo += __shfl_xor_sync(0xffffffffu, db_lo, 1);
    db_hi += __shfl_xor_sync(0xffffffffu, db_hi, 1);
    db_lo += __shfl_xor_sync(0xffffffffu, db_lo, 2);
    db_hi += __shfl_xor_sync(0xffffffffu, db_hi, 2);
    if (lane % 4 == 0) {
      dbp[blockIdx.x * kC + co] = db_lo;
      dbp[blockIdx.x * kC + co + 8] = db_hi;
    }
  }
}

// the shapes the kernels take: at most kMaxBatch samples (the CUDA-core
// kernels' grid z) and even conv1_2 output sides
bool valid_geometry(int batch, int hc, int wc) {
  const int ho = hc - 2, wo = wc - 2;
  return batch > 0 && batch <= kMaxBatch && ho > 0 && wo > 0 && ho % 2 == 0
         && wo % 2 == 0;
}

// the dK2 chunk count, 0 for a shape the backward does not take (both
// wgrad kernels number the conv1_2 output pixels with 32-bit ints):
// fp32 (dtype 0) conv2_wgrad takes kChunk pixels a block; bf16 (dtype 1)
// conv2_wgrad_wgmma kChunkSegs row segments of kSeg pixels
int wgrad_chunks(int batch, int hc, int wc, int dtype) {
  const int64_t npix = static_cast<int64_t>(batch) * (hc - 2) * (wc - 2);
  if (!valid_geometry(batch, hc, wc) || npix * kC >= (int64_t{1} << 31))
    return 0;
  if (dtype == 1) {
    const int64_t segs =
        static_cast<int64_t>(batch) * (hc - 2) * ((wc - 2 + kSeg - 1) / kSeg);
    return static_cast<int>((segs + kChunkSegs - 1) / kChunkSegs);
  }
  return static_cast<int>((npix + kChunk - 1) / kChunk);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// a persistent grid: one block of 156,672 B of shared memory per SM
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int64_t tiles, int* grid) {
  if (tiles >= (int64_t{1} << 31) - 65536) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c3w::kConvSmem);
  *grid = static_cast<int>(tiles < sms ? tiles : sms);
  return err;
}

template <typename T>
int forward(const void* c11, const void* k2, const void* b2, void* out,
            int batch, int hc, int wc, cudaStream_t stream) {
  if (!valid_geometry(batch, hc, wc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ph = (hc - 2) / 2, pw = (wc - 2) / 2;
  const dim3 grid((pw + kTPW - 1) / kTPW, (ph + kTPH - 1) / kTPH, batch);
  conv2_pool_fwd<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(c11), static_cast<const float*>(k2),
      static_cast<const float*>(b2), static_cast<T*>(out), hc, wc, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

int forward_wgmma(const void* c11, const void* wpack, const void* b2,
                  void* out, int batch, int hc, int wc, cudaStream_t stream) {
  if (!valid_geometry(batch, hc, wc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ty = ceil_div((hc - 2) / 2, c3w::kWin);
  const int tx = ceil_div((wc - 2) / 2, c3w::kWin);
  int grid = 0;
  cudaError_t err =
      persistent_grid(conv2_pool_fwd_wgmma, int64_t{batch} * ty * tx, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv2_pool_fwd_wgmma<<<grid, c3w::kConvThreads, c3w::kConvSmem, stream>>>(
      static_cast<const bf16*>(c11), static_cast<const bf16*>(wpack),
      static_cast<const float*>(b2), static_cast<bf16*>(out), batch, hc, wc,
      ty, tx);
  return static_cast<int>(cudaGetLastError());
}

// the backward's steps, selected by `parts` (kAll on the training path; a
// single step lets a caller time it alone)
constexpr int kRoute = 1, kWgrad = 2, kDgrad = 4, kAll = 7;

int reduce_wgrad(const void* partial, const void* dbp, void* dk, void* db,
                 int n_chunks, cudaStream_t stream) {
  constexpr int kOut = 9 * kC * kC + kC;
  wgrad_reduce<<<(kOut + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(dbp),
      static_cast<float*>(dk), static_cast<float*>(db), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* c11, const void* k2, const void* kflip,
             const void* b2, const void* g, void* dz, void* partial,
             void* dbp, void* dk, void* db, void* dc11, int batch, int hc,
             int wc, int n_chunks, int parts, cudaStream_t stream) {
  const int ho = hc - 2, wo = wc - 2, ph = ho / 2, pw = wo / 2;
  cudaError_t err = cudaSuccess;
  if (parts & kRoute) {
    const dim3 tiles((pw + kTPW - 1) / kTPW, (ph + kTPH - 1) / kTPH, batch);
    conv2_pool_route<T><<<tiles, kThreads, 0, stream>>>(
        static_cast<const T*>(c11), static_cast<const float*>(k2),
        static_cast<const float*>(b2), static_cast<const T*>(g),
        static_cast<T*>(dz), hc, wc, ph, pw);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (parts & kWgrad) {
    conv2_wgrad<T><<<dim3(n_chunks, 9), kWThreads, 0, stream>>>(
        static_cast<const T*>(dz), static_cast<const T*>(c11),
        static_cast<float*>(partial), static_cast<float*>(dbp), ho, wo,
        batch * ho * wo);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    const int rc = reduce_wgrad(partial, dbp, dk, db, n_chunks, stream);
    if (rc != 0) return rc;
  }
  if (parts & kDgrad) {
    const dim3 ctiles((wc + 2 * kTPW - 1) / (2 * kTPW),
                      (hc + 2 * kTPH - 1) / (2 * kTPH), batch);
    conv2_dgrad<T><<<ctiles, kThreads, 0, stream>>>(
        static_cast<const T*>(dz), static_cast<const float*>(kflip),
        static_cast<T*>(dc11), ho, wo);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

int backward_wgmma(const void* c11, const void* k2p, const void* kflipp,
                   const void* b2, const void* g, void* dz, void* partial,
                   void* dbp, void* dk, void* db, void* dc11, int batch,
                   int hc, int wc, int n_chunks, int parts,
                   cudaStream_t stream) {
  const int ho = hc - 2, wo = wc - 2;
  cudaError_t err = cudaSuccess;
  int grid = 0;
  if (parts & kRoute) {
    const int ty = ceil_div(ho / 2, c3w::kWin);
    const int tx = ceil_div(wo / 2, c3w::kWin);
    if ((err = persistent_grid(conv2_pool_route_wgmma,
                               int64_t{batch} * ty * tx, &grid))
        != cudaSuccess)
      return static_cast<int>(err);
    conv2_pool_route_wgmma<<<grid, c3w::kConvThreads, c3w::kConvSmem,
                             stream>>>(
        static_cast<const bf16*>(c11), static_cast<const bf16*>(k2p),
        static_cast<const float*>(b2), static_cast<const bf16*>(g),
        static_cast<bf16*>(dz), batch, hc, wc, ty, tx);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (parts & kWgrad) {
    if ((err = cudaFuncSetAttribute(
             conv2_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kWgradSmem)) != cudaSuccess)
      return static_cast<int>(err);
    conv2_wgrad_wgmma<<<n_chunks, kWgradThreads, kWgradSmem, stream>>>(
        static_cast<const bf16*>(dz), static_cast<const bf16*>(c11),
        static_cast<float*>(partial), static_cast<float*>(dbp), ho, wo,
        batch * ho * ceil_div(wo, kSeg));
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    const int rc = reduce_wgrad(partial, dbp, dk, db, n_chunks, stream);
    if (rc != 0) return rc;
  }
  if (parts & kDgrad) {
    const int ty = ceil_div(hc, 2 * c3w::kWin);
    const int tx = ceil_div(wc, 2 * c3w::kWin);
    if ((err = persistent_grid(conv2_dgrad_wgmma, int64_t{batch} * ty * tx,
                               &grid))
        != cudaSuccess)
      return static_cast<int>(err);
    conv2_dgrad_wgmma<<<grid, c3w::kConvThreads, c3w::kConvSmem, stream>>>(
        static_cast<const bf16*>(dz), static_cast<const bf16*>(kflipp),
        static_cast<bf16*>(dc11), batch, ho, wo, ty, tx);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 (k2 HWIO fp32), 1 = bfloat16 (k2 the wgmma image of
// `pack_conv_weights` in ops/block1_fused.py)
extern "C" int block1_train_forward(const void* c11, const void* k2,
                                    const void* b2, void* out, int batch,
                                    int hc, int wc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(c11, k2, b2, out, batch, hc, wc, s);
  if (dtype == 1) return forward_wgmma(c11, k2, b2, out, batch, hc, wc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the number of dK2 chunks, n_chunks, for a c11 of (B, Hc, Wc, 64) in
// `dtype`: the leading extent of the backward's partial scratch (0: the
// backward refuses the shape)
extern "C" int block1_train_wgrad_chunks(int batch, int hc, int wc,
                                         int dtype) {
  return wgrad_chunks(batch, hc, wc, dtype);
}

// scratch: dz (B, Hc-2, Wc-2, 64) in T, partial (n_chunks, 9, 64, 64) and
// dbp (n_chunks, 64) fp32; outputs dk (9, 64, 64) [tap][co][ci] and db (64)
// fp32, dc11 (B, Hc, Wc, 64) in T. k2 and kflip as block1_train_forward
// takes k2. parts: 1 route (dz), 2 dK2/db2, 4 d(c11); 7 the whole backward
extern "C" int block1_train_backward(
    const void* c11, const void* k2, const void* kflip, const void* b2,
    const void* g, void* dz, void* partial, void* dbp, void* dk, void* db,
    void* dc11, int batch, int hc, int wc, int n_chunks, int dtype,
    int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0 || n_chunks != wgrad_chunks(batch, hc, wc, dtype)
      || parts < 1 || parts > kAll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return backward<float>(c11, k2, kflip, b2, g, dz, partial, dbp, dk, db,
                           dc11, batch, hc, wc, n_chunks, parts, s);
  if (dtype == 1)
    return backward_wgmma(c11, k2, kflip, b2, g, dz, partial, dbp, dk, db,
                          dc11, batch, hc, wc, n_chunks, parts, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
