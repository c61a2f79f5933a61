// Backward of a 2x2 stride-2 max pool with first-max routing: the cotangent
// of each pooled value goes to the FIRST element of its window (scan order
// 00, 01, 10, 11) equal to the pooled value; element 11 takes it when none of
// the first three match.
//
// Replaces: scripts/experiments/pool_bwd_pallas.py, `_bwd_kernel` (the
// Pallas TPU kernel launched by `pool_bwd_pallas`).
//
// x (B, 2h, 2w, C) NHWC, y and g (B, h, w, C), dx like x, all in T (float or
// bfloat16). Comparisons are made in fp32 (exact for bf16). The caller pads
// odd extents bottom/right with -inf, which never matches a real maximum.
//
// Bound on this card: bytes, 2.5 times x's bytes (x read, y and g read at a
// quarter of it each, dx written). The TPU kernel folds the column parity
// into its 128 lanes; here one thread owns one pooled pixel and V channels
// (V * sizeof(T) = 16 bytes where C allows, else 1): it loads the four window
// vectors, y and g as 16-byte loads, and writes the four dx vectors, with
// neighbouring threads on neighbouring channels and pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block1_tile.cuh"

namespace {

using b1tile::from_float;
using b1tile::to_float;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(256) pool_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
    T* __restrict__ dx, long long n, int h, int w, int c) {
  using P = Pack<T, V>;
  const int cv = c / V;
  const T zero = from_float<T>(0.f);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
           + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int v = static_cast<int>(i % cv);
    long long p = i / cv;
    const int px = static_cast<int>(p % w);
    p /= w;
    const int py = static_cast<int>(p % h);
    const long long b = p / h;
    const size_t yo = ((b * h + py) * w + px) * static_cast<size_t>(c) + v * V;
    const size_t x00 = ((b * 2 * h + 2 * py) * 2 * w + 2 * px)
        * static_cast<size_t>(c) + v * V;
    const size_t offs[4] = {x00, x00 + c, x00 + 2 * static_cast<size_t>(w) * c,
                            x00 + (2 * static_cast<size_t>(w) + 1) * c};
    P xs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      xs[k] = *reinterpret_cast<const P*>(x + offs[k]);
    const P yv = *reinterpret_cast<const P*>(y + yo);
    const P gv = *reinterpret_cast<const P*>(g + yo);
    P out[4];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float m = to_float<T>(yv.v[j]);
      const bool e00 = to_float<T>(xs[0].v[j]) == m;
      const bool e01 = !e00 && to_float<T>(xs[1].v[j]) == m;
      const bool e10 = !e00 && !e01 && to_float<T>(xs[2].v[j]) == m;
      const bool e11 = !(e00 || e01 || e10);
      out[0].v[j] = e00 ? gv.v[j] : zero;
      out[1].v[j] = e01 ? gv.v[j] : zero;
      out[2].v[j] = e10 ? gv.v[j] : zero;
      out[3].v[j] = e11 ? gv.v[j] : zero;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<P*>(dx + offs[k]) = out[k];
  }
}

template <typename T, int V>
int launch(const void* x, const void* y, const void* g, void* dx, int batch,
           int h, int w, int c, cudaStream_t stream) {
  const long long n = static_cast<long long>(batch) * h * w * (c / V);
  const long long blocks = (n + 255) / 256;
  pool_bwd_kernel<T, V><<<static_cast<unsigned>(
      blocks < 1048576 ? blocks : 1048576), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(g), static_cast<T*>(dx), n, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h, w: pooled extents; dtype: 0 = float32, 1 = bfloat16; vec: 1 for 16-byte
// channel vectors (C a multiple of 16 / sizeof(T), pointers 16-byte aligned,
// checked by the wrapper), 0 for one channel per thread.
extern "C" int pool_bwd_launch(const void* x, const void* y, const void* g,
                               void* dx, int batch, int h, int w, int c,
                               int dtype, int vec, void* stream) {
  if (batch < 1 || h < 1 || w < 1 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec && c % 4 == 0)
      return launch<float, 4>(x, y, g, dx, batch, h, w, c, s);
    return launch<float, 1>(x, y, g, dx, batch, h, w, c, s);
  }
  if (dtype == 1) {
    if (vec && c % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, y, g, dx, batch, h, w, c, s);
    return launch<__nv_bfloat16, 1>(x, y, g, dx, batch, h, w, c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
