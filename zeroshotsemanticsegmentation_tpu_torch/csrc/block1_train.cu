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
// values rounded to T, b2 in fp32. Rounding follows `_kernel`: taps in T,
// fp32 accumulation, + b2 in fp32, ReLU, max, one rounding to T.
//
// Bound on this card at B=24, 512x512 (Hc = Wc = 520): operations.
// Forward: 2*24*518^2*576*64 = 474.8 GFLOP, 0.48 ms at the 989 TFLOP/s bf16
// tensor-core peak; its bytes (c11 830 MB + output 206 MB) need 0.31 ms.
// Backward: the recompute, dK2 and d(c11) are 474.8 GFLOP each, 1.44 ms;
// it moves >= 1.87 GB (0.56 ms).
//
// Design (first, simple kernels on CUDA cores in fp32 FMA; tensor cores and
// TMA are later work). Every launch is one 256-thread block per tile:
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

// the shapes the kernels take: a grid z of at most kMaxBatch samples and
// even conv1_2 output sides
bool valid_geometry(int batch, int hc, int wc) {
  const int ho = hc - 2, wo = wc - 2;
  return batch > 0 && batch <= kMaxBatch && ho > 0 && wo > 0 && ho % 2 == 0
         && wo % 2 == 0;
}

// conv2_wgrad's chunk count, 0 for a shape the backward does not take:
// conv2_wgrad numbers the conv1_2 output pixels with 32-bit ints
int wgrad_chunks(int batch, int hc, int wc) {
  const int64_t npix = static_cast<int64_t>(batch) * (hc - 2) * (wc - 2);
  if (!valid_geometry(batch, hc, wc) || npix * kC >= (int64_t{1} << 31))
    return 0;
  return static_cast<int>((npix + kChunk - 1) / kChunk);
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

template <typename T>
int backward(const void* c11, const void* k2, const void* kflip,
             const void* b2, const void* g, void* dz, void* partial,
             void* dbp, void* dk, void* db, void* dc11, int batch, int hc,
             int wc, int n_chunks, cudaStream_t stream) {
  if (n_chunks == 0 || n_chunks != wgrad_chunks(batch, hc, wc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = hc - 2, wo = wc - 2, ph = ho / 2, pw = wo / 2;
  const dim3 tiles((pw + kTPW - 1) / kTPW, (ph + kTPH - 1) / kTPH, batch);
  conv2_pool_route<T><<<tiles, kThreads, 0, stream>>>(
      static_cast<const T*>(c11), static_cast<const float*>(k2),
      static_cast<const float*>(b2), static_cast<const T*>(g),
      static_cast<T*>(dz), hc, wc, ph, pw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv2_wgrad<T><<<dim3(n_chunks, 9), kWThreads, 0, stream>>>(
      static_cast<const T*>(dz), static_cast<const T*>(c11),
      static_cast<float*>(partial), static_cast<float*>(dbp), ho, wo,
      batch * ho * wo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kOut = 9 * kC * kC + kC;
  wgrad_reduce<<<(kOut + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(dbp),
      static_cast<float*>(dk), static_cast<float*>(db), n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 ctiles((wc + 2 * kTPW - 1) / (2 * kTPW),
                    (hc + 2 * kTPH - 1) / (2 * kTPH), batch);
  conv2_dgrad<T><<<ctiles, kThreads, 0, stream>>>(
      static_cast<const T*>(dz), static_cast<const float*>(kflip),
      static_cast<T*>(dc11), ho, wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16
extern "C" int block1_train_forward(const void* c11, const void* k2,
                                    const void* b2, void* out, int batch,
                                    int hc, int wc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(c11, k2, b2, out, batch, hc, wc, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(c11, k2, b2, out, batch, hc, wc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the number of conv2_wgrad chunks, n_chunks, for a c11 of (B, Hc, Wc, 64):
// the leading extent of the backward's partial scratch (0: the backward
// refuses the shape)
extern "C" int block1_train_wgrad_chunks(int batch, int hc, int wc) {
  return wgrad_chunks(batch, hc, wc);
}

// scratch: dz (B, Hc-2, Wc-2, 64) in T, partial (n_chunks, 9, 64, 64) and
// dbp (n_chunks, 64) fp32; outputs dk (9, 64, 64) [tap][co][ci] and db (64)
// fp32, dc11 (B, Hc, Wc, 64) in T
extern "C" int block1_train_backward(
    const void* c11, const void* k2, const void* kflip, const void* b2,
    const void* g, void* dz, void* partial, void* dbp, void* dk, void* db,
    void* dc11, int batch, int hc, int wc, int n_chunks, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(c11, k2, kflip, b2, g, dz, partial, dbp, dk, db,
                           dc11, batch, hc, wc, n_chunks, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(c11, k2, kflip, b2, g, dz, partial, dbp,
                                   dk, db, dc11, batch, hc, wc, n_chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
