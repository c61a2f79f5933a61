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
// fill is 0.0 for excluded classes (the reference's zeroed-row quirk) and
// -1e30 for the gate row, which takes part in neither partition.
//
// Bound on this card: memory. At B=64, 512x512 the int32 labels are 67 MB
// written, the input 1.6 MB read; the arithmetic is ~3 FMA per class per
// pixel. So the least time is the label write at 3.35 TB/s, about 20 us.
//
// Design: one block per output row (y, b). The block blends the two input
// rows that feed y into a (K+1, w32) row in shared memory (the row-upsampled
// intermediate never reaches device memory), then each thread takes output
// columns, blends two taps per class from shared memory and keeps both
// running argmaxes in registers. Consecutive threads write consecutive
// labels, so the store is coalesced. The tap tables (first index and two
// weights per output coordinate) come from the host and are exact copies of
// the interpolation matrix's nonzeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) szn_labels_kernel(
    const float* __restrict__ aug,      // (B, h32, w32, kp1)
    const int* __restrict__ seen,       // (kp1) 0/1
    const int* __restrict__ unseen,     // (kp1) 0/1
    const float* __restrict__ fill,     // (kp1)
    const int* __restrict__ row_i0,     // (out_h) first row tap
    const float* __restrict__ row_w,    // (2, out_h) tap weights
    const int* __restrict__ col_i0,     // (out_w)
    const float* __restrict__ col_w,    // (2, out_w)
    int* __restrict__ out,              // (B, out_h, out_w)
    int h32, int w32, int kp1, int out_h, int out_w) {
  extern __shared__ float smem[];
  float* rows = smem;                          // (kp1, w32)
  float* sfill = rows + kp1 * w32;             // (kp1)
  int* sseen = reinterpret_cast<int*>(sfill + kp1);
  int* sunseen = sseen + kp1;

  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = row_i0[y];
  const int i1 = min(i0 + 1, h32 - 1);  // a clamped tap has weight 0
  const float w0 = row_w[y];
  const float w1 = row_w[out_h + y];
  const float* a0 = aug + (static_cast<size_t>(b) * h32 + i0) * w32 * kp1;
  const float* a1 = aug + (static_cast<size_t>(b) * h32 + i1) * w32 * kp1;
  for (int t = threadIdx.x; t < w32 * kp1; t += blockDim.x) {
    const int x = t / kp1;
    const int k = t - x * kp1;
    rows[k * w32 + x] = w0 * a0[t] + w1 * a1[t];
  }
  for (int k = threadIdx.x; k < kp1; k += blockDim.x) {
    sfill[k] = fill[k];
    sseen[k] = seen[k];
    sunseen[k] = unseen[k];
  }
  __syncthreads();

  int* orow = out + (static_cast<size_t>(b) * out_h + y) * out_w;
  for (int x = threadIdx.x; x < out_w; x += blockDim.x) {
    const int j0 = col_i0[x];
    const int j1 = min(j0 + 1, w32 - 1);
    const float c0 = col_w[x];
    const float c1 = col_w[out_w + x];
    float best_s = -INFINITY, best_u = -INFINITY, gate = 0.f;
    int arg_s = 0, arg_u = 0;
    for (int k = 0; k < kp1; ++k) {
      const float v = c0 * rows[k * w32 + j0] + c1 * rows[k * w32 + j1];
      const float vs = sseen[k] ? v : sfill[k];
      const float vu = sunseen[k] ? v : sfill[k];
      if (vs > best_s) { best_s = vs; arg_s = k; }  // strict: first max
      if (vu > best_u) { best_u = vu; arg_u = k; }
      gate = v;  // the last row, k = kp1 - 1, is the gate
    }
    orow[x] = gate >= 0.f ? arg_u : arg_s;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int szn_fused_labels(
    const void* aug, const void* seen, const void* unseen, const void* fill,
    const void* row_i0, const void* row_w, const void* col_i0,
    const void* col_w, void* out, int batch, int h32, int w32, int kp1,
    int out_h, int out_w, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kp1) * w32 + kp1)
                      + 2 * sizeof(int) * kp1;
  szn_labels_kernel<<<dim3(out_h, batch), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(aug), static_cast<const int*>(seen),
      static_cast<const int*>(unseen), static_cast<const float*>(fill),
      static_cast<const int*>(row_i0), static_cast<const float*>(row_w),
      static_cast<const int*>(col_i0), static_cast<const float*>(col_w),
      static_cast<int*>(out), h32, w32, kp1, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}
