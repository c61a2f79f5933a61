// Per-pixel row dot: out[p] = sum_c a[p, c] * b[p, c] over the last axis of
// two fp32 (..., C) tensors, any C.
//
// Replaces: scripts/probe_h2d.py, `kern` of `rowdot` (the Pallas TPU kernel
// of the probe's `rowdot_pl` mode).
//
// The sum runs in channel order from 0.0 in one fp32 accumulator, with each
// product and each addition rounded on its own (no fused multiply-add), which
// is what the plain version `ops.rowdot.rowdot_plain` does with torch ops:
// the two agree bit for bit.
//
// Bound on this card: bytes. At (8, 512, 512, 21) the two inputs are 352 MB
// and the output 8 MB, 0.107 ms at 3.35 TB/s. A pixel's row is 84 bytes, not
// a multiple of 16, so one thread per pixel would read across cache lines
// at a stride. Instead a warp owns 32 consecutive pixels, whose rows are one
// contiguous run of 32 * C floats (16-byte aligned when the tensors are):
// it reads the run with coalesced 16-byte loads, stores the products in its
// own slice of shared memory, and then each lane adds up its pixel's C
// products. Runs longer than the slice (C > 32) go through it in windows,
// in order, so each pixel's sum keeps its channel order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 1024;                // floats staged per warp

__global__ void __launch_bounds__(kThreads) rowdot_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, long long npix, int c, int vec4) {
  __shared__ __align__(16) float prod[kWarps][kSpan];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long p0 = (static_cast<long long>(blockIdx.x) * kWarps + warp)
      * 32;
  if (p0 >= npix) return;  // only warp-level synchronisation below
  const int np = static_cast<int>(npix - p0 < 32 ? npix - p0 : 32);
  const long long base = p0 * c;
  const long long len = static_cast<long long>(np) * c;
  const long long mine0 = static_cast<long long>(lane) * c;
  const long long mine1 = mine0 + c;
  float* pr = prod[warp];
  float acc = 0.f;
  for (long long w0 = 0; w0 < len; w0 += kSpan) {
    const int n = static_cast<int>(len - w0 < kSpan ? len - w0 : kSpan);
    const float* aw = a + base + w0;
    const float* bw = b + base + w0;
    __syncwarp();  // the previous window's products are consumed
    int done = 0;
    if (vec4) {  // base + w0 is a multiple of 4 floats
      const int n4 = n / 4;
      const float4* a4 = reinterpret_cast<const float4*>(aw);
      const float4* b4 = reinterpret_cast<const float4*>(bw);
      float4* p4 = reinterpret_cast<float4*>(pr);
#pragma unroll 4
      for (int i = lane; i < n4; i += 32) {
        const float4 x = __ldcs(a4 + i), y = __ldcs(b4 + i);
        p4[i] = make_float4(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y),
                            __fmul_rn(x.z, y.z), __fmul_rn(x.w, y.w));
      }
      done = 4 * n4;
    }
    for (int i = done + lane; i < n; i += 32)
      pr[i] = __fmul_rn(__ldcs(aw + i), __ldcs(bw + i));
    __syncwarp();
    const long long lo = (mine0 > w0 ? mine0 : w0) - w0;
    const long long hi = (mine1 < w0 + n ? mine1 : w0 + n) - w0;
    for (long long i = lo; i < hi; ++i) acc = __fadd_rn(acc, pr[i]);
  }
  if (lane < np) out[p0 + lane] = acc;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b: (npix, c) row-major fp32; out: (npix) fp32. vec4: both pointers are
// 16-byte aligned (checked by the wrapper).
extern "C" int rowdot_launch(const void* a, const void* b, void* out,
                             long long npix, int c, int vec4, void* stream) {
  if (npix < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  rowdot_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), npix, c, vec4);
  return static_cast<int>(cudaGetLastError());
}
