// Fused stage-1 train-step tail: masked cosine loss, NNE argmax confusion
// histogram and score sum in one read of the full-resolution score
// (forward), and d score in one more read (backward).
//
// Replaces: zeroshotsemanticsegmentation_tpu/ops/costail_fused.py,
//   forward  `_fwd_kernel` (launched by `_cos_tail_fwd`; K5),
//   backward `_bwd_kernel` (launched by `_cos_tail_bwd`; K6),
// with their shared per-pixel recompute `_common`.
//
// Layouts: score (B, H, W, C) NHWC fp32 (C contiguous per pixel, C <= 32;
// the TPU kernel's (B, C, H*W) transpose served the TPU's lanes and is not
// carried over), label (B, H, W) int32 (< 0 = ignore), target and infer
// embedding tables (K, C) fp32, rows already normalised by the wrapper.
// Per pixel (`_common`):
//   t^  = temb[label] (0 for a label outside [0, K)), valid = label >= 0
//   r2  = |s|^2, norm = sqrt(r2 == 0 ? 1 : r2), s^ = s / norm
//   cos = s^ . t^;  pred = first argmax_k iemb[k] . s^
// Forward: per sample sum(valid * cos), count(valid); hist[label][pred]
//   over valid pixels with label < n; sum(s); loss_b = (nv - cos_b) /
//   max(nv, 1).
// Backward: ds = -(g_b / max(nv_b, 1)) * valid * (r2 == 0 ? t^ :
//   (t^ - cos * s^) / norm) + g_ssum, the exact derivative of the
//   double-where normalise.
//
// Bound on this card at B=24, 512x512, C=20: bytes. The forward reads the
// 503 MB score and 25 MB of labels (0.16 ms at 3.35 TB/s); ~6 GFLOP of fp32
// work is not the limit. The backward reads both and writes the 503 MB
// d score: 1.03 GB, 0.31 ms.
//
// Design (first, simple kernels): one thread per pixel. A block stages 256
// pixels' scores through shared memory with coalesced loads (and, in the
// backward, stores), and keeps both embedding tables there. The forward's
// grid is (blocks per sample, B); each block walks its sample's 256-pixel
// tiles with a stride, counts its histogram with shared-memory atomics and
// adds the non-zero bins to the global int32 histogram once (integer
// atomics: exact in any order). Per-block sums of cos, valid count and
// score go to partial buffers that `costail_finalize` adds in a fixed
// order, so losses and score sum are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 32;
constexpr int kMaxBatch = 65535;     // grid y
constexpr int kBlocksPerSm = 8;      // forward grid: about this many per SM
constexpr size_t kMaxSmem = 48 * 1024;  // dynamic shared memory, no opt-in

struct Pixel {
  float s[kMaxC], sn[kMaxC], t[kMaxC];
  float r2, norm, cos;
};

// the shared recompute of `_common` for the pixel whose scores are
// stage[0 .. c)
__device__ __forceinline__ void recompute(const float* stage, int lbl,
                                          const float* temb, int c, int k,
                                          Pixel& px) {
  float r2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxC; ++i) {
    px.s[i] = i < c ? stage[i] : 0.f;
    r2 += px.s[i] * px.s[i];
  }
  px.r2 = r2;
  px.norm = sqrtf(r2 == 0.f ? 1.f : r2);
  const bool has_t = lbl >= 0 && lbl < k;
  float cos = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxC; ++i) {
    px.sn[i] = px.s[i] / px.norm;
    px.t[i] = (has_t && i < c) ? temb[lbl * c + i] : 0.f;
    cos += px.sn[i] * px.t[i];
  }
  px.cos = cos;
}

// block-wide sum of v (all threads call it); the result is valid in thread 0
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  V s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// dynamic shared memory: temb (k*c), iemb (k*c), stage (256*c) fp32, then
// the (n, n) int32 histogram
__global__ void __launch_bounds__(kThreads) costail_fwd(
    const float* __restrict__ score, const int* __restrict__ label,
    const float* __restrict__ temb, const float* __restrict__ iemb, int hw,
    int c, int k, int n, float* __restrict__ cos_part,
    int* __restrict__ nv_part, float* __restrict__ ssum_part,
    int* __restrict__ hist) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;
  float* si = st + k * c;
  float* stage = si + k * c;
  int* shist = reinterpret_cast<int*>(stage + kThreads * c);
  __shared__ float fred[kThreads / 32];
  __shared__ int ired[kThreads / 32];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  for (int i = tid; i < k * c; i += kThreads) {
    st[i] = temb[i];
    si[i] = iemb[i];
  }
  for (int i = tid; i < n * n; i += kThreads) shist[i] = 0;

  float cos_acc = 0.f, ss_acc = 0.f;
  int nv_acc = 0;
  const float* sb = score + static_cast<size_t>(b) * hw * c;
  const int* lb = label + static_cast<size_t>(b) * hw;
  for (int p0 = blockIdx.x * kThreads; p0 < hw; p0 += gridDim.x * kThreads) {
    const int np = min(kThreads, hw - p0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < np * c; i += kThreads)
      stage[i] = sb[static_cast<size_t>(p0) * c + i];
    __syncthreads();
    if (tid < np) {
      const int lbl = lb[p0 + tid];
      Pixel px;
      recompute(stage + tid * c, lbl, st, c, k, px);
      float best = 0.f;
      int pred = 0;
      for (int kk = 0; kk < k; ++kk) {
        float sim = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxC; ++i)
          if (i < c) sim += si[kk * c + i] * px.sn[i];
        if (kk == 0 || sim > best) {
          best = sim;
          pred = kk;
        }
      }
      float ssum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxC; ++i) ssum += px.s[i];
      ss_acc += ssum;
      if (lbl >= 0) {
        cos_acc += px.cos;
        nv_acc += 1;
        if (lbl < n) atomicAdd(&shist[lbl * n + pred], 1);
      }
    }
  }
  const float cs = block_sum(cos_acc, fred);
  const int nv = block_sum(nv_acc, ired);
  const float ss = block_sum(ss_acc, fred);
  if (tid == 0) {
    const int slot = b * gridDim.x + blockIdx.x;
    cos_part[slot] = cs;
    nv_part[slot] = nv;
    ssum_part[slot] = ss;
  }
  __syncthreads();
  for (int i = tid; i < n * n; i += kThreads)
    if (shist[i]) atomicAdd(&hist[i], shist[i]);
}

// losses (B,), nv (B,) as fp32, ssum (1): the partials added in order
__global__ void costail_finalize(const float* __restrict__ cos_part,
                                 const int* __restrict__ nv_part,
                                 const float* __restrict__ ssum_part,
                                 int batch, int parts,
                                 float* __restrict__ losses,
                                 float* __restrict__ nv_out,
                                 float* __restrict__ ssum) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < batch) {
    float cs = 0.f;
    int nv = 0;
    for (int i = 0; i < parts; ++i) {
      cs += cos_part[b * parts + i];
      nv += nv_part[b * parts + i];
    }
    const float nvf = static_cast<float>(nv);
    losses[b] = (nvf - cs) / fmaxf(nvf, 1.f);
    nv_out[b] = nvf;
  }
  if (b == 0) {
    float s = 0.f;
    for (int i = 0; i < batch * parts; ++i) s += ssum_part[i];
    *ssum = s;
  }
}

// dynamic shared memory: temb (k*c), stage (256*c) fp32
__global__ void __launch_bounds__(kThreads) costail_bwd(
    const float* __restrict__ score, const int* __restrict__ label,
    const float* __restrict__ temb, const float* __restrict__ g_losses,
    const float* __restrict__ nv, const float* __restrict__ g_ssum, int hw,
    int c, int k, float* __restrict__ dscore) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;
  float* stage = st + k * c;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int np = min(kThreads, hw - p0);
  for (int i = tid; i < k * c; i += kThreads) st[i] = temb[i];
  const size_t base = (static_cast<size_t>(b) * hw + p0) * c;
  for (int i = tid; i < np * c; i += kThreads) stage[i] = score[base + i];
  __syncthreads();
  if (tid < np) {
    const int lbl = label[static_cast<size_t>(b) * hw + p0 + tid];
    Pixel px;
    recompute(stage + tid * c, lbl, st, c, k, px);
    const float coef = -(g_losses[b] / fmaxf(nv[b], 1.f));
    const float cv = coef * (lbl >= 0 ? 1.f : 0.f);
    const float gss = *g_ssum;
#pragma unroll
    for (int i = 0; i < kMaxC; ++i) {
      if (i < c) {
        const float dcos = px.r2 == 0.f
            ? px.t[i] : (px.t[i] - px.cos * px.sn[i]) / px.norm;
        stage[tid * c + i] = cv * dcos + gss;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < np * c; i += kThreads) dscore[base + i] = stage[i];
}

bool valid_shape(int batch, int hw, int c, int k) {
  return batch > 0 && batch <= kMaxBatch && hw > 0 && c > 0 && c <= kMaxC
         && k > 0;
}

size_t fwd_smem(int c, int k, int n) {
  return sizeof(float) * (2 * k * c + kThreads * c) + sizeof(int) * n * n;
}

size_t bwd_smem(int c, int k) {
  return sizeof(float) * (k * c + kThreads * c);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the forward's blocks per sample, `parts`, on CUDA device `device`: the
// second extent of its (B, parts) scratch; a negative value is minus a CUDA
// error code
extern "C" int costail_forward_parts(int batch, int hw, int device) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (batch <= 0 || hw <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (hw + kThreads - 1) / kThreads;
  const int fill = (sms * kBlocksPerSm + batch - 1) / batch;
  return tiles < fill ? tiles : (fill > 0 ? fill : 1);
}

// scratch: cos_part, nv_part (int32), ssum_part, each (B, parts); outputs
// losses (B,), nv (B,), ssum (1) fp32 and hist (n, n) int32, zeroed by the
// caller
extern "C" int costail_forward(const void* score, const void* label,
                               const void* temb, const void* iemb,
                               void* cos_part, void* nv_part,
                               void* ssum_part, void* losses, void* nv,
                               void* ssum, void* hist, int batch, int hw,
                               int c, int k, int n, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(c, k, n);
  if (!valid_shape(batch, hw, c, k) || n <= 0 || smem > kMaxSmem
      || parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  costail_fwd<<<dim3(parts, batch), kThreads, smem, s>>>(
      static_cast<const float*>(score), static_cast<const int*>(label),
      static_cast<const float*>(temb), static_cast<const float*>(iemb), hw,
      c, k, n, static_cast<float*>(cos_part), static_cast<int*>(nv_part),
      static_cast<float*>(ssum_part), static_cast<int*>(hist));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  costail_finalize<<<(batch + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(cos_part), static_cast<const int*>(nv_part),
      static_cast<const float*>(ssum_part), batch, parts,
      static_cast<float*>(losses), static_cast<float*>(nv),
      static_cast<float*>(ssum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int costail_backward(const void* score, const void* label,
                                const void* temb, const void* g_losses,
                                const void* nv, const void* g_ssum,
                                void* dscore, int batch, int hw, int c,
                                int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(c, k);
  if (!valid_shape(batch, hw, c, k) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((hw + kThreads - 1) / kThreads, batch);
  costail_bwd<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(score), static_cast<const int*>(label),
      static_cast<const float*>(temb), static_cast<const float*>(g_losses),
      static_cast<const float*>(nv), static_cast<const float*>(g_ssum), hw,
      c, k, static_cast<float*>(dscore));
  return static_cast<int>(cudaGetLastError());
}
