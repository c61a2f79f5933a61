// fc6's forward on the tensor cores: a bf16 implicit-GEMM VALID
// convolution, stride 1, no patch matrix.
//
// Replaces no Pallas kernel: the JAX package leaves fc6's forward
// (zeroshotsemanticsegmentation_tpu/ops/conv7x7.py, `conv_valid_mmgrad`) to
// XLA's convolution, and the port left it to cuDNN, which runs it off the
// tensor cores (`precomputed_convolve_sgemm`, about 28 ms a serving
// request). Added for that.
//
//   y[b, oh, ow, co] = sum_{dh, dw, ci} x[b, oh + dh, ow + dw, ci]
//                                       * W[co, dh, dw, ci]
//
// as one GEMM: M = B * OH * OW output pixels, N = Cout, K = KH * KW * Cin in
// (dh, dw, ci) order. x is NHWC, W the packed (Cout, KH * KW * Cin) matrix
// (ops/conv7x7.py `pack_weight`), y row-major (M, Cout), i.e. NHWC. bf16
// products, fp32 sums in one fixed order (tap-major, then 64-channel blocks
// ascending; inside a block wgmma's k16 steps in order), each output rounded
// once to bf16. No atomics and no split K: deterministic, which remat's
// recomputation relies on. The tensor cores' fp32 accumulation does not
// round to nearest: at K = 25088 the sums strayed up to about 1e-4 from
// the exact ones at an output scale of 5.5 (H100), against bf16's rounding
// of 2^-9 relative, so 1.3% of the outputs round the other way from the
// exact sum's rounding (cuDNN's CUDA-core sgemm: 0.1%), and the error norm
// is 1.0002x cuDNN's.
//
// Bound on this card (bf16 dense peak 989 TFLOP/s; fc6 at 512x512, 23x23 ->
// 17x17, Cin 512, Cout 4096): B=16 (serving), M = 4624: 950.3 GFLOP, 0.961
// ms (operations; x 8.7 MB, W 205.5 MB, y 37.9 MB: 0.075 ms of bytes);
// B=24 (training), M = 6936: 1.4255 TFLOP, 1.441 ms (operations).
//
// Design (csrc/tma_wgmma.cuh: the ring, the consumers' mainloop and the
// epilogue that K7's `pdot_tma` runs too): persistent blocks of three
// warpgroups on a 128 x 256 output tile. A k-step is one tap (dh, dw)
// times 64 input channels.
//   A, the patches: the producer warpgroup gathers a k-step's 128 rows of
//     128 contiguous bytes, each from the NHWC input at its output pixel
//     shifted by the tap, by cp.async into the 128-byte swizzle wgmma reads
//     (16-byte chunk g of row r at g ^ (r % 8)); thread t copies chunk t % 8
//     of rows t / 8 + 16 i, i < 8, whose pixel offsets it computes once a
//     tile. Rows past M are zero-filled. Each producer thread's copies
//     arrive on the stage's full barrier as they land
//     (cp.async.mbarrier.arrive.noinc); the consumers fence the stage for
//     wgmma's async-proxy reads after they see it full. The patches never
//     exist as a matrix in device memory; the input (8.7 MB at B=16) stays
//     in L2, so the 49 taps re-read L2, not HBM.
//   B, the weight: a (256 rows x 64 k) box by tiled TMA from the packed
//     matrix, K-major, read by wgmma with its transpose bit off.
//   Tile walk: N-panel-major (tile t: M tile t % tiles_m, N tile
//     t / tiles_m), so one weight panel (256 x K, 12.8 MB) serves
//     all of M before the next: the blocks in flight share a few panels,
//     and the weight streams from HBM about once.

#include "tma_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunks = tw::kBK * 2 / 16;           // 16-byte chunks a row
constexpr int kProducers = 128;                     // the first warpgroup
constexpr int kRowsPerThread = tw::kBM * kChunks / kProducers;   // 8
constexpr int kRowStep = kProducers / kChunks;      // 16 rows apart
constexpr int kBN = 256;                            // the Cout tile
constexpr int kNH = kBN / 128;                      // wgmma n128 halves
constexpr int kA = tw::kBM * tw::kBK * 2;           // 16 KB
constexpr int kB = kBN * tw::kBK * 2;               // 32 KB
using Ring = tw::Ring<kA + kB>;

// the convolution's shape: M output pixels of OH x OW per image, N output
// channels; the input (IH, IW, Cin) per image; k-steps of 64 channels,
// cblocks a tap, taps walked (dh, dw) with dw fastest
struct Geometry {
  int m, n, ih, iw, cin, ow, ohw, kw, kblocks, cblocks;
};

// one k-step of consumer `cw` from the stage at `slot`: A (its 64 rows) and
// B (256 rows) both K-major, 128 bytes a row, 8-row atoms 1024 B apart
struct ConvMma {
  int cw;
  __device__ __forceinline__ void operator()(uint32_t slot,
                                             float (&acc)[kNH][64]) const {
    const uint32_t sa = slot + cw * 8192;
    const uint32_t sb = slot + kA;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = tw::desc_sw128(sa + ks * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < kNH; ++h)
        tw::mma_ss_n128<0, 0>(
            acc[h], da, tw::desc_sw128(sb + h * 16384 + ks * 32, 16, 1024));
    }
  }
};

__global__ void __launch_bounds__(tw::kThreads, 1) conv7x7_igemm(
    const bf16* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
    bf16* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(128) uint8_t smem[];
  Ring ring(smem);
  const int tiles_m = (g.m + tw::kBM - 1) / tw::kBM;
  const int tiles = tiles_m * (g.n / kBN);
  const int wg = threadIdx.x / 128;
  // a phase: every producer thread's cp.async arrival, and thread 0's
  // arrival with the weight box's bytes
  ring.init(kProducers + 1);

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int t = threadIdx.x, chunk = t % kChunks, row0 = t / kChunks;
    // chunk `chunk` of rows row0 + 16 i: the swizzle's XOR is row0 % 8 for
    // all of them
    const uint32_t dst0 = row0 * 128 + ((chunk ^ (row0 & 7)) << 4);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tm = tile % tiles_m, tn = tile / tiles_m;
      int pix[kRowsPerThread];  // element offset of the row's pixel, or -1
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int m = tm * tw::kBM + row0 + kRowStep * i;
        if (m < g.m) {
          const int b = m / g.ohw, r = m - b * g.ohw;
          const int oh = r / g.ow, ow = r - oh * g.ow;
          pix[i] = ((b * g.ih + oh) * g.iw + ow) * g.cin + chunk * 8;
        } else {
          pix[i] = -1;
        }
      }
      int cb = 0, dw = 0, dh = 0;
      for (int kb = 0; kb < g.kblocks; ++kb) {
        const int off = (dh * g.iw + dw) * g.cin + cb * tw::kBK;
        ring.wait_empty();
        const uint32_t sa = ring.slot(), bar = ring.full_bar();
        if (t == 0) {
          tw::mbar_expect_tx(bar, kB);
          tw::tma_load(sa + kA, &wmap, kb * tw::kBK, tn * kBN, bar);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const bool ok = pix[i] >= 0;
          c3w::cp_async16(sa + dst0 + i * kRowStep * 128,
                          ok ? x + (pix[i] + off) : x, ok);
        }
        tw::mbar_arrive_cp_async(bar);
        ring.next();
        if (++cb == g.cblocks) {
          cb = 0;
          if (++dw == g.kw) {
            dw = 0;
            ++dh;
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {  // consumers: warpgroup cw multiplies rows 64 cw .. 64 cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4,
              lane = threadIdx.x % 32;
    const ConvMma mma{cw};
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tm = tile % tiles_m, tn = tile / tiles_m;
      float acc[kNH][64];
      tw::consume_tile<true>(ring, g.kblocks, lane, acc, mma);
      tw::store_tile(acc, out, false, g.m, g.n,
                     tm * tw::kBM + 64 * cw + 16 * warp + lane / 4, tn * kBN,
                     lane);
    }
  }
}

cudaError_t launch(const void* x, const void* w, void* out, const Geometry& g,
                   cudaStream_t s) {
  CUtensorMap map;
  if (!tw::make_map(&map, w, g.kblocks * tw::kBK, g.n, tw::kBK, kBN))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = tw::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv7x7_igemm,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ring::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (g.m + tw::kBM - 1) / tw::kBM * (g.n / kBN);
  conv7x7_igemm<<<tiles < sms ? tiles : sms, tw::kThreads, Ring::kSmem, s>>>(
      static_cast<const bf16*>(x), map, static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (batch, ih, iw, cin) NHWC bf16; w (cout, kh, kw, cin) bf16, contiguous;
// out (batch, ih - kh + 1, iw - kw + 1, cout) bf16; cout a multiple of 256,
// cin of 64; every base 16-byte aligned.
// Returns cudaErrorInvalidValue for anything else.
extern "C" int conv7x7_igemm_launch(const void* x, const void* w, void* out,
                                    int batch, int ih, int iw, int cin,
                                    int kh, int kw, int cout, void* stream) {
  const int oh = ih - kh + 1, ow = iw - kw + 1;
  const long long m = static_cast<long long>(batch) * oh * ow;
  const long long x_elems = static_cast<long long>(batch) * ih * iw * cin;
  if (batch < 1 || kh < 1 || kw < 1 || oh < 1 || ow < 1 || cin < tw::kBK
      || cin % tw::kBK != 0 || cout < kBN || cout % kBN != 0
      || x_elems >= (1ll << 31) || m * cout >= (1ll << 31)
      || !tw::aligned16(x) || !tw::aligned16(w) || !tw::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cblocks = cin / tw::kBK;
  const Geometry g{static_cast<int>(m), cout, ih, iw, cin, ow, oh * ow,
                   kw, kh * kw * cblocks, cblocks};
  return static_cast<int>(
      launch(x, w, out, g, static_cast<cudaStream_t>(stream)));
}
