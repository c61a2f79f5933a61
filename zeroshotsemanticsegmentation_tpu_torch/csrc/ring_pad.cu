// Ring pad: a channels_last (NHWC) tensor padded on its spatial dims with a
// per-channel constant, in one pass, and the per-channel sum of a gradient
// over the padded ring (the constant's gradient).
//
// Replaces: no TPU kernel. The JAX package's `models/pruned.py` `_padc` is
// two `jnp.concatenate`s that XLA fuses into the consumer; in PyTorch the two
// `torch.cat`s of the constant bands ran as two transposing copies with an
// NCHW result, which put blocks 2-4 of the support-pruned VGG trunk in NCHW
// (and cuDNN's layout conversions around every conv there).
//
// ring_pad: out (B, OH, OW, C) NHWC from a (B, h, w, C), channel stride 1 and
// pixel stride C (batch and row strides free, so a column slice of an NHWC
// tensor is read in place), and c (C). Output rows [top, top + h), columns
// [left, left + w) are a's pixels; every other pixel is c. Bound on this
// card: bytes, a's bytes read once and out's written once. One block owns
// one output row (its batch and row index computed once); its threads walk
// the row's OW * C elements as 16-byte vectors where C and the pointers
// allow (else one element a thread), neighbouring threads on neighbouring
// vectors, so each warp reads and writes 512 contiguous bytes. Each thread
// issues its loads before its stores. c is staged in shared memory once a
// block. The copy moves bits: one kernel for 2-byte and one for 4-byte
// elements.
//
// ring_sum: sum over the ring positions (the pixels not copied from a) of a
// gradient g (B, C, OH, OW) with any strides, per channel, in fp32, cast to
// T once at the end. Bound: bytes of the ring, a few percent of g. Two
// passes keep the order fixed, so the sum is the same bits from run to run:
// blocks of 32 channels x 8 pixel lanes each sum a fixed stride of the ring
// and reduce their lanes in order into a partial (S, C); the second pass
// adds the S partials of a channel in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadThreads = 256;
constexpr int kPadUnroll = 4;
constexpr int kSumLanes = 8;   // pixel lanes of a ring_sum block
constexpr int kSumWidth = 32;  // channels of a ring_sum block

// V: the unit a thread moves (uint4 = 16 bytes, or one element).
template <typename V>
__global__ void __launch_bounds__(kPadThreads) ring_pad_kernel(
    const V* __restrict__ a, const V* __restrict__ c, V* __restrict__ out,
    int h, int w, int oh, int cv, int top, int left, long long sb,
    long long sh, int row_units) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* cs = reinterpret_cast<V*>(smem);
  for (int i = threadIdx.x; i < cv; i += kPadThreads) cs[i] = c[i];
  __syncthreads();
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / oh);
  const int iy = static_cast<int>(row % oh) - top;
  const bool data_row = iy >= 0 && iy < h;
  const int lo = left * cv, hi = (left + w) * cv;
  const V* arow = a + b * sb + static_cast<long long>(data_row ? iy : 0) * sh
      - lo;
  V* orow = out + row * row_units;
  const int j0 = blockIdx.y * (kPadThreads * kPadUnroll) + threadIdx.x;
  V v[kPadUnroll];
#pragma unroll
  for (int k = 0; k < kPadUnroll; ++k) {
    const int j = j0 + k * kPadThreads;
    if (j < row_units)
      v[k] = (data_row && j >= lo && j < hi) ? arow[j] : cs[j % cv];
  }
#pragma unroll
  for (int k = 0; k < kPadUnroll; ++k) {
    const int j = j0 + k * kPadThreads;
    if (j < row_units) orow[j] = v[k];
  }
}

template <typename V>
int launch_pad(const void* a, const void* c, void* out, int batch, int h,
               int w, int oh, int ow, int cv, int top, int left,
               long long sb, long long sh, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * oh;
  const long long row_units = static_cast<long long>(ow) * cv;
  const long long chunks = (row_units + kPadThreads * kPadUnroll - 1)
      / (kPadThreads * kPadUnroll);
  const size_t smem = static_cast<size_t>(cv) * sizeof(V);
  if (rows > 2147483647LL || chunks > 65535 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  ring_pad_kernel<V><<<dim3(static_cast<unsigned>(rows),
                            static_cast<unsigned>(chunks)),
                       kPadThreads, smem, stream>>>(
      static_cast<const V*>(a), static_cast<const V*>(c),
      static_cast<V*>(out), h, w, oh, cv, top, left, sb, sh,
      static_cast<int>(row_units));
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The ring's pixel `r` of an image, in row order: `top` full rows, then
// `left` + `right` pixels of each of the h data rows, then `bottom` full
// rows.
__device__ __forceinline__ void ring_pixel(long long r, int ow, int h,
                                           int top, int left, int right,
                                           int w, int* y, int* x) {
  const long long head = static_cast<long long>(top) * ow;
  const int side = left + right;
  const long long mid = static_cast<long long>(h) * side;
  if (r < head) {
    *y = static_cast<int>(r / ow);
    *x = static_cast<int>(r % ow);
  } else if (r < head + mid) {
    const long long q = r - head;
    *y = top + static_cast<int>(q / side);
    const int s = static_cast<int>(q % side);
    *x = s < left ? s : s + w;
  } else {
    const long long q = r - head - mid;
    *y = top + h + static_cast<int>(q / ow);
    *x = static_cast<int>(q % ow);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSumWidth * kSumLanes) ring_sum_partial(
    const T* __restrict__ g, float* __restrict__ part, long long npix,
    long long ring, int ch, int ow, int h, int w, int top, int left,
    int right, long long sb, long long sc, long long sh, long long sw) {
  __shared__ float acc[kSumLanes][kSumWidth];
  const int cc = blockIdx.y * kSumWidth + threadIdx.x;
  float s = 0.f;
  if (cc < ch) {
    for (long long p = static_cast<long long>(blockIdx.x) * kSumLanes
             + threadIdx.y;
         p < npix; p += static_cast<long long>(gridDim.x) * kSumLanes) {
      const long long b = p / ring;
      int y, x;
      ring_pixel(p - b * ring, ow, h, top, left, right, w, &y, &x);
      s += as_float(g[b * sb + cc * sc + y * sh + x * sw]);
    }
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && cc < ch) {
    float t = acc[0][threadIdx.x];
#pragma unroll
    for (int l = 1; l < kSumLanes; ++l) t += acc[l][threadIdx.x];
    part[static_cast<long long>(blockIdx.x) * ch + cc] = t;
  }
}

template <typename T>
__global__ void ring_sum_finish(const float* __restrict__ part,
                                T* __restrict__ out, int splits, int ch) {
  const int cc = blockIdx.x * blockDim.x + threadIdx.x;
  if (cc >= ch) return;
  float t = 0.f;
  for (int s = 0; s < splits; ++s)
    t += part[static_cast<long long>(s) * ch + cc];
  out[cc] = from_float<T>(t);
}

template <typename T>
int launch_sum(const void* g, void* part, void* out, int batch, int ch,
               int oh, int ow, int top, int bottom, int left, int right,
               long long sb, long long sc, long long sh, long long sw,
               int splits, cudaStream_t stream) {
  const int h = oh - top - bottom, w = ow - left - right;
  const long long ring = static_cast<long long>(oh) * ow
      - static_cast<long long>(h) * w;
  const long long npix = ring * batch;
  const int groups = (ch + kSumWidth - 1) / kSumWidth;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  ring_sum_partial<T><<<dim3(splits, groups), dim3(kSumWidth, kSumLanes), 0,
                        stream>>>(
      static_cast<const T*>(g), static_cast<float*>(part), npix, ring, ch,
      ow, h, w, top, left, right, sb, sc, sh, sw);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ring_sum_finish<T><<<(ch + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), splits, ch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a: (batch, h, w, ch) with channel stride 1, pixel stride ch, batch stride
// sb and row stride sh (elements); c: (ch); out: (batch, oh, ow, ch)
// contiguous, oh = h + top + bottom, ow = w + left + right. elem: 2 or 4
// bytes. vec: 1 for 16-byte vectors (ch * elem, sb * elem and sh * elem
// multiples of 16 and the three pointers 16-byte aligned, checked by the
// wrapper), 0 for one element a thread.
extern "C" int ring_pad_launch(const void* a, const void* c, void* out,
                               int batch, int h, int w, int ch, int top,
                               int bottom, int left, int right, long long sb,
                               long long sh, int elem, int vec,
                               void* stream) {
  if (batch < 1 || h < 1 || w < 1 || ch < 1 || top < 0 || bottom < 0
      || left < 0 || right < 0 || (elem != 2 && elem != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int oh = h + top + bottom, ow = w + left + right;
  if (vec) {
    const int per = 16 / elem;
    if ((ch % per) || (sb % per) || (sh % per))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_pad<uint4>(a, c, out, batch, h, w, oh, ow, ch / per, top,
                             left, sb / per, sh / per, s);
  }
  if (elem == 2)
    return launch_pad<uint16_t>(a, c, out, batch, h, w, oh, ow, ch, top,
                                left, sb, sh, s);
  return launch_pad<uint32_t>(a, c, out, batch, h, w, oh, ow, ch, top, left,
                              sb, sh, s);
}

// g: (batch, ch, oh, ow) with element strides sb, sc, sh, sw; part: (splits,
// ch) fp32 scratch; out: (ch) in g's dtype (0 = float32, 1 = bfloat16). The
// ring is every position outside rows [top, oh - bottom) x columns
// [left, ow - right), which must hold at least one position.
extern "C" int ring_sum_launch(const void* g, void* part, void* out,
                               int batch, int ch, int oh, int ow, int top,
                               int bottom, int left, int right, long long sb,
                               long long sc, long long sh, long long sw,
                               int dtype, int splits, void* stream) {
  if (batch < 1 || ch < 1 || splits < 1 || splits > 65535 || top < 0
      || bottom < 0 || left < 0 || right < 0 || oh - top - bottom < 1
      || ow - left - right < 1 || (top + bottom + left + right) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sum<float>(g, part, out, batch, ch, oh, ow, top, bottom,
                             left, right, sb, sc, sh, sw, splits, s);
  if (dtype == 1)
    return launch_sum<__nv_bfloat16>(g, part, out, batch, ch, oh, ow, top,
                                     bottom, left, right, sb, sc, sh, sw,
                                     splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
