// Fused SZN labels: x32 bilinear upsample + masked seen/unseen argmax + gate.
//
// Replaces: zeroshotsemanticsegmentation_tpu/ops/szn_fused.py, `_kernel`
// (the Pallas TPU kernel launched by `_fused`).
//
// Computes, for every output pixel (b, y, x), from the 1/32-resolution
// class similarities `aug` (B, h32, w32, K+1) fp32 (rows 0..K-1: cosine
// numerators against row-normalized embeddings; row K: the seenmask gate
// s0 - s1):
//   v[k]   = bilinear x32 upsample of aug[..., k] at (y, x), cropped at 19,
//            as a 2-tap fp32 blend along rows, then along columns (every row
//            of the interpolation matrix has at most two adjacent taps);
//   seen   = first argmax over k of (seen[k] ? v[k] : fill[k]);
//   unseen = first argmax over k of (unseen[k] ? v[k] : fill[k]);
//   label  = v[K] >= 0 ? unseen : seen                      (int32).
// The geometry named here is FCN-32s's; the kernel reads the upsample only
// through the host's tap tables, so any geometry whose rows have two adjacent
// taps and whose runs of 4 outputs reach at most 3 tap columns runs
// unchanged (DeepLab-v2's x8: stride 8, kernel 16, crop 4, from 1/8 heads).
// fill is 0.0 for excluded classes (the reference's zeroed-row quirk) and
// -1e30 for the gate row, which takes part in neither partition. The
// wrapper (`ops/szn_fused.py`) checks on the host that the partition has
// this form: every real class in exactly one of seen and unseen.
//
// Bound on this card: memory. At B=64, 512x512 the int32 labels are 67 MB
// written, the input 1.6 MB read: 0.0205 ms at 3.35 TB/s. The issue rate
// is the tighter floor: a class costs a pixel at least 2 instructions of
// blend and 3 of argmax update, ~1.8 G lane-instructions at K+1 = 22
// (this kernel issues about 6, 3 of them on the half-rate ALU pipe).
//
// Design:
// - One 128-thread block per band of up to 8 output rows of one image. The
//   block blends, for each row of the band, the two input rows that feed it
//   into a row of w32 tap columns in shared memory, all before one barrier;
//   then each warp labels tiles of 8 rows x 16 columns of the band. Many
//   small blocks an SM hide each other's barriers and loads. (Bands are
//   shorter where 8 rows do not fit in shared memory, down to one row.)
// - In a tap column the classes sit by partition: the seen classes first,
//   then the unseen ones, each in class order, then the gate. So a
//   partition's running first max is a loop over a contiguous range with
//   no mask test, and a position maps back to its class through a table.
//   The unrolled widths pad each range to a multiple of 4 positions with
//   -inf (which never wins), so that one 16-byte load gives four classes.
//   The positions come from the seen mask, a launch argument: every real
//   class not in it is unseen (the wrapper checks this form).
// - A thread takes a run of 4 output columns. The column tap changes where
//   (x + 19) % 32 == 0, so a run reads at most three tap columns, once per
//   class; each pixel blends them with three weights, one of which is 0
//   (two for the run's first pixel, which never passes the change).
// - Each pixel keeps the first max of both partitions; its gate row picks
//   one. A warp scans a partition only where a pixel of its tile needs it:
//   where the gate is smooth over 32 pixels most 8 x 16 tiles need one. The
//   excluded classes' 0.0 fill is one comparison at the end: the
//   partition's first excluded index wins when 0.0 beats the max or ties
//   it at a lower index. The gate row's -1e30 likewise.
// - The class loop is unrolled for the bundled widths K+1 = 22 (pascal)
//   and 34 (context); one generic instance takes every other width, with
//   scalar loads of an unpadded row.
// - Each thread writes its 4 labels with one streaming 16-byte store
//   (st.global.cs) where the row allows it; the lanes of a tile row write
//   64 consecutive bytes.
// The tap tables (first index and two weights per output coordinate) come
// from the host and are exact copies of the interpolation matrix's
// nonzeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4;                  // output columns a thread
constexpr int kMaskWords = 64;           // up to 4096 real classes
constexpr float kGateFill = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

struct SeenMask {
  unsigned long long w[kMaskWords];      // bit k % 64 of word k / 64
};

// where the classes sit in a blended row: the seen partition's classes at
// positions 0 .. ns - 1, the unseen ones from `u0`, each in class order,
// the gate at `gate`; `stride` floats a tap column
struct Layout {
  int kp1, ns, u0, gate, stride, w32;
};

// the column weights of a run of kRun output columns from x: its first tap
// column j0 and three weights a pixel over taps j0, j0 + 1, j0 + 2
struct RunW {
  int j0;
  float wa[kRun], wb[kRun], wc[kRun];
};

__device__ __forceinline__ void run_weights(RunW& w,
                                            const int* __restrict__ col_i0,
                                            const float* __restrict__ col_w,
                                            int out_w, int x) {
  int i0[kRun];
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    const int xp = min(x + p, out_w - 1);
    i0[p] = __ldg(col_i0 + xp);
    const float c0 = __ldg(col_w + xp), c1 = __ldg(col_w + out_w + xp);
    // a pixel past the run's tap change blends the second and third
    const bool s = i0[p] != i0[0];
    w.wa[p] = s ? 0.f : c0;
    w.wb[p] = s ? c0 : c1;
    w.wc[p] = s ? c1 : 0.f;
  }
  w.j0 = i0[0];
}

// the blend of pixel p; the first pixel never passes the change
template <int P>
__device__ __forceinline__ float blend(const RunW& w, float r0, float r1,
                                       float r2) {
  if constexpr (P == 0) return fmaf(w.wb[0], r1, w.wa[0] * r0);
  return fmaf(w.wc[P], r2, fmaf(w.wb[P], r1, w.wa[P] * r0));
}

template <int P = 0>
__device__ __forceinline__ void blend_all(const RunW& w, float r0, float r1,
                                          float r2, float (&v)[kRun]) {
  v[P] = blend<P>(w, r0, r1, r2);
  if constexpr (P + 1 < kRun) blend_all<P + 1>(w, r0, r1, r2, v);
}

__device__ __forceinline__ void update(const float (&v)[kRun], int pos,
                                       float (&best)[kRun],
                                       int (&arg)[kRun]) {
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    const bool gt = v[p] > best[p];  // strict: the first max
    best[p] = fmaxf(best[p], v[p]);  // NaN (a padded position) never wins
    arg[p] = gt ? pos : arg[p];
  }
}

// one partition's running first max over its `n` positions from `o`: four
// classes a 16-byte load at the unrolled widths (groups padded with -inf,
// which never win), one a load otherwise
template <int KP1>
__device__ __forceinline__ void scan(const float* ta, const float* tb,
                                     const float* tc, const RunW& w, int o,
                                     int n, float (&best)[kRun],
                                     int (&arg)[kRun]) {
  if constexpr (KP1 > 0) {
#pragma unroll
    for (int g = 0; g < (KP1 - 1 + 3) / 4; ++g) {
      if (4 * g >= n) break;
      const int q = o + 4 * g;
      const float4 v0 = *reinterpret_cast<const float4*>(ta + q);
      const float4 v1 = *reinterpret_cast<const float4*>(tb + q);
      const float4 v2 = *reinterpret_cast<const float4*>(tc + q);
      float v[kRun];
      blend_all(w, v0.x, v1.x, v2.x, v);
      update(v, q, best, arg);
      blend_all(w, v0.y, v1.y, v2.y, v);
      update(v, q + 1, best, arg);
      blend_all(w, v0.z, v1.z, v2.z, v);
      update(v, q + 2, best, arg);
      blend_all(w, v0.w, v1.w, v2.w, v);
      update(v, q + 3, best, arg);
    }
  } else {
#pragma unroll 4
    for (int q = o; q < o + n; ++q) {
      float v[kRun];
      blend_all(w, ta[q], tb[q], tc[q], v);
      update(v, q, best, arg);
    }
  }
}

// labels of output columns x .. x + kRun - 1 of the blended row `row`
template <int KP1>
__device__ __forceinline__ void label_run(
    const float* __restrict__ row, const Layout& L, const RunW& w,
    const int* __restrict__ perm, int fx_seen, int fx_unseen, int out_w,
    int x, int* __restrict__ orow, bool store) {
  const float* ta = row + w.j0 * L.stride;
  const float* tb = row + min(w.j0 + 1, L.w32 - 1) * L.stride;
  const float* tc = row + min(w.j0 + 2, L.w32 - 1) * L.stride;
  float gate[kRun];
  blend_all(w, ta[L.gate], tb[L.gate], tc[L.gate], gate);

  float bs[kRun], bu[kRun];
  int as[kRun], au[kRun];
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    bs[p] = bu[p] = -INFINITY;
    as[p] = au[p] = 0;
  }
  // a partition is scanned where a pixel of the warp's runs needs it (the
  // whole warp calls this function)
  bool need_s = false, need_u = false;
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    need_s |= !(gate[p] >= 0.f);
    need_u |= gate[p] >= 0.f;
  }
  const int kreal = L.kp1 - 1;
  if (__any_sync(0xffffffffu, need_s))
    scan<KP1>(ta, tb, tc, w, 0, L.ns, bs, as);
  if (__any_sync(0xffffffffu, need_u))
    scan<KP1>(ta, tb, tc, w, L.u0, kreal - L.ns, bu, au);

  int lbl[kRun];
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    const bool un = gate[p] >= 0.f;
    float best = un ? bu[p] : bs[p];
    int arg = best > -INFINITY ? perm[un ? au[p] : as[p]] : 0;
    // the partition's excluded classes fill with 0.0: the first of them
    // wins when 0.0 beats the max or ties it at a lower index
    const int fx = un ? fx_unseen : fx_seen;
    if (fx >= 0 && (0.f > best || (0.f == best && fx < arg))) {
      best = 0.f;
      arg = fx;
    }
    lbl[p] = kGateFill > best ? kreal : arg;  // the gate row's fill
  }
  if (!store) return;
  if (x + kRun <= out_w && (out_w % kRun) == 0) {
    __stcs(reinterpret_cast<int4*>(orow + x),
           make_int4(lbl[0], lbl[1], lbl[2], lbl[3]));
  } else {
#pragma unroll
    for (int p = 0; p < kRun; ++p)
      if (x + p < out_w) __stcs(orow + x + p, lbl[p]);
  }
}

template <int KP1>
__global__ void __launch_bounds__(kThreads) szn_labels_kernel(
    const float* __restrict__ aug,      // (B, h32, w32, kp1)
    const __grid_constant__ SeenMask seen,
    const int* __restrict__ row_i0,     // (out_h) first row tap
    const float* __restrict__ row_w,    // (2, out_h) tap weights
    const int* __restrict__ col_i0,     // (out_w)
    const float* __restrict__ col_w,    // (2, out_w)
    int* __restrict__ out,              // (B, out_h, out_w)
    int h32, int w32, int kp1_arg, int ns, int out_h, int out_w, int bands,
    int rows, int u0, int gate, int stride, int fx_seen, int fx_unseen) {
  extern __shared__ __align__(16) float smem[];
  const int kp1 = KP1 > 0 ? KP1 : kp1_arg;
  const int kreal = kp1 - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / bands;
  const int y0 = (blockIdx.x - b * bands) * rows;
  const int row_elems = w32 * stride;
  int* const slot = reinterpret_cast<int*>(smem + rows * row_elems);
  int* const perm = slot + kp1;  // position -> class, `stride` of them
  Layout L;
  L.kp1 = kp1;
  L.ns = ns;
  L.u0 = u0;
  L.gate = gate;
  L.stride = stride;
  L.w32 = w32;

  // each class's position: its rank among the seen classes, or the
  // unseen ones (every real class is in exactly one); the padding of the
  // unrolled widths holds -inf
  if (KP1 > 0)
    for (int i = tid; i < rows * row_elems; i += kThreads) smem[i] = -INFINITY;
  for (int k = tid; k < kreal; k += kThreads) {
    const int wd = k >> 6, bit = k & 63;
    int rank = __popcll(seen.w[wd] & ((1ull << bit) - 1));
    for (int i = 0; i < wd; ++i) rank += __popcll(seen.w[i]);
    const int pos = (seen.w[wd] >> bit) & 1ull ? rank : L.u0 + (k - rank);
    slot[k] = pos;
    perm[pos] = k;
  }
  if (tid == 0) slot[kreal] = L.gate;
  __syncthreads();

  // the band's row-upsampled rows (w32 tap columns each), each class at its
  // position; a row past out_h repeats the last one
  const float* img = aug + static_cast<size_t>(b) * h32 * w32 * kp1;
  const int n_in = w32 * kp1;
  for (int r = 0; r < rows; ++r) {
    const int y = min(y0 + r, out_h - 1);
    const int i0 = __ldg(row_i0 + y);
    const int i1 = min(i0 + 1, h32 - 1);  // a clamped tap has weight 0
    const float w0 = __ldg(row_w + y), w1 = __ldg(row_w + out_h + y);
    const float* a0 = img + static_cast<size_t>(i0) * n_in;
    const float* a1 = img + static_cast<size_t>(i1) * n_in;
    float* dst = smem + r * row_elems;
    for (int t = tid; t < n_in; t += kThreads) {
      const int j = t / kp1;
      dst[j * stride + slot[t - j * kp1]] =
          fmaf(w1, __ldg(a1 + t), w0 * __ldg(a0 + t));
    }
  }
  __syncthreads();

  // a warp takes tiles of `rows` rows x `cols` runs of the band: lane
  // (r, c) = (lane / cols, lane % cols), tiles `warp`, + kWarps, .. along
  // the row; a lane past the band's rows or the row's runs computes a
  // clamped copy and stores nothing
  const int cols = 32 / rows;
  const int r = lane / cols, c = lane % cols;
  const int y = y0 + r;
  const bool row_ok = y < out_h;
  int* orow = out + (static_cast<size_t>(b) * out_h + min(y, out_h - 1))
                    * out_w;
  const int tile_w = kRun * cols;
  for (int tile = warp; tile * tile_w < out_w; tile += kWarps) {
    const int x = tile * tile_w + kRun * c;
    RunW w;
    run_weights(w, col_i0, col_w, out_w, x);
    label_run<KP1>(smem + r * row_elems, L, w, perm, fx_seen, fx_unseen,
                   out_w, x, orow, row_ok);
  }
}

template <int KP1>
cudaError_t launch(const float* aug, const SeenMask& seen, const int* ri,
                   const float* rw, const int* ci, const float* cw, int* out,
                   int batch, int h32, int w32, int kp1, int ns, int out_h,
                   int out_w, int rows, int u0, int gate, int stride,
                   int fx_seen, int fx_unseen, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(rows) * w32 * stride
                      + sizeof(int) * (kp1 + stride);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(szn_labels_kernel<KP1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int bands = (out_h + rows - 1) / rows;
  const int64_t grid = int64_t{batch} * bands;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  szn_labels_kernel<KP1><<<static_cast<unsigned>(grid), kThreads, smem,
                           stream>>>(aug, seen, ri, rw, ci, cw, out, h32,
                                     w32, kp1, ns, out_h, out_w, bands, rows,
                                     u0, gate, stride, fx_seen, fx_unseen);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan and the blended row's layout come from the host
// (`k1_plan` in ops/szn_fused.py, their one definition): `instance` 22 or
// 34 (the unrolled widths, 16-byte loads of four positions) or 0 (the
// generic width, scalar loads); the seen classes at positions 0 .. ns - 1,
// the unseen ones from `u0`, the gate at `gate`, `stride` floats a tap
// column; `rows` (8, 4, 2 or 1) output rows a band. The entry checks only
// what keeps the kernel's reads and writes in bounds: the ranges do not
// overlap and, for an unrolled instance, start on 4-float boundaries. `words`
// is host memory, the seen mask: bit k % 64 of word k / 64 for real class k,
// `ns` of them set; every other real class is unseen. `fx_seen` /
// `fx_unseen`: each partition's first excluded real class, -1 for none. A
// plan past the card's limits (shared memory per block, grid) returns
// cudaErrorInvalidValue.
extern "C" int szn_fused_labels(
    const void* aug, const void* words, const void* row_i0,
    const void* row_w, const void* col_i0, const void* col_w, void* out,
    int batch, int h32, int w32, int kp1, int ns, int out_h, int out_w,
    int instance, int u0, int gate, int stride, int rows, int fx_seen,
    int fx_unseen, void* stream) {
  const int kreal = kp1 - 1;
  const bool aligned = u0 % 4 == 0 && gate % 4 == 0 && stride % 4 == 0;
  if (batch <= 0 || h32 <= 0 || w32 <= 0 || kp1 <= 0 || out_h <= 0
      || out_w <= 0 || kreal > 64 * kMaskWords || ns < 0 || ns > kreal
      || (rows != 1 && rows != 2 && rows != 4 && rows != 8)
      || (instance != 0 && (instance != kp1 || !aligned))
      || u0 < ns || gate < u0 + (kreal - ns) || stride <= gate)
    return static_cast<int>(cudaErrorInvalidValue);
  SeenMask seen;
  memcpy(&seen, words, sizeof(seen));
  const auto* a = static_cast<const float*>(aug);
  const auto* ri = static_cast<const int*>(row_i0);
  const auto* rw = static_cast<const float*>(row_w);
  const auto* ci = static_cast<const int*>(col_i0);
  const auto* cw = static_cast<const float*>(col_w);
  auto* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (instance == 22)
    err = launch<22>(a, seen, ri, rw, ci, cw, o, batch, h32, w32, kp1, ns,
                     out_h, out_w, rows, u0, gate, stride, fx_seen,
                     fx_unseen, s);
  else if (instance == 34)
    err = launch<34>(a, seen, ri, rw, ci, cw, o, batch, h32, w32, kp1, ns,
                     out_h, out_w, rows, u0, gate, stride, fx_seen,
                     fx_unseen, s);
  else if (instance == 0)
    err = launch<0>(a, seen, ri, rw, ci, cw, o, batch, h32, w32, kp1, ns,
                    out_h, out_w, rows, u0, gate, stride, fx_seen,
                    fx_unseen, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
