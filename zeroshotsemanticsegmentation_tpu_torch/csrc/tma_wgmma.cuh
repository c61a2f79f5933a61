// The warp-specialised TMA + wgmma pieces that K7's `pdot_tma`
// (csrc/pdot.cu) and fc6's implicit-GEMM forward (csrc/conv7x7_igemm.cu)
// share: the ring of k-steps in shared memory with its `mbarrier` full /
// empty pairs, the consumer warpgroups' mainloop, the epilogue that stores
// the accumulators, and the host's tensor maps.
//
// A block is three warpgroups (kThreads): the first produces, filling the
// ring's stages; the other two consume, each multiplying a 64-row half of a
// kBM-row tile on `wgmma` straight from shared memory by descriptor. A
// stage holds one k-step of kBK = 64 bf16 values (128 bytes a row) of A
// and of B, every operand 128-byte swizzled in 1024-byte atoms of 8 rows,
// at a 1024-byte aligned slot. The ring takes kRingBytes, as many stages as
// fit. A stage's full barrier completes when the producer's arrivals and
// the bytes it expects from TMA are in; its empty barrier when lane 0 of
// each of the 8 consumer warps has arrived, after the products that read it
// are done.
//
// Order of the sums: each consumer adds the k-steps in ring order and, in a
// step, its four k16 products in order, so a tile's sums are fixed by the
// order the producer fills the ring in.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_wgmma.cuh"

namespace tw {

constexpr int kBM = 128, kBK = 64;   // a tile's rows; a k-step's depth
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kRingBytes = 192 * 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival on `bar` once every cp.async this thread issued before has
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// waits until the phase of parity `parity` has completed; a phase that
// never completes (a lost TMA transaction) ends the launch with an error
// after 10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}
// the box at (c0, c1) (innermost coordinate first) of `map` into `dst`,
// completing `bytes` on barrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// a 128-byte-swizzle shared-memory matrix descriptor; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return c3w::desc(addr, lbo, sbo) | (uint64_t{1} << 62);
}

// d (m64 x n128, fp32) += A (m64 x k16) x B (k16 x n128), both from shared
// memory through descriptors; kTransA / kTransB = 1 read MN-major
template <int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// two adjacent outputs (i even, 8-byte aligned in fp32)
__device__ __forceinline__ void store_out2(void* out, bool out_f32, size_t i,
                                           float v0, float v1) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) =
        __floats2bfloat162_rn(v0, v1);
}

// The ring of kStageBytes stages (a multiple of 1024) at the 1024-byte
// aligned start of dynamic shared memory, then its full and empty
// barriers. Each thread walks it with its own (stage, phase).
template <int kStageBytes>
struct Ring {
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kStageBytes % 1024 == 0 && kStages >= 2, "ring stages");
  uint32_t base, full, empty;
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ explicit Ring(const void* smem) {
    base = (c3w::smem_u32(smem) + 1023) & ~1023u;
    full = base + kStages * kStageBytes;
    empty = full + 8 * kStages;
  }
  // thread 0 sets the barriers up (full: `full_count` arrivals a phase;
  // empty: one a consumer warp); every thread of the block calls this
  __device__ __forceinline__ void init(int full_count) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + 8 * s, full_count);
        mbar_init(empty + 8 * s, 8);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  __device__ __forceinline__ uint32_t slot() const {
    return base + stage * kStageBytes;
  }
  __device__ __forceinline__ uint32_t full_bar() const {
    return full + 8 * stage;
  }
  // the producer: until the consumers have freed this stage
  __device__ __forceinline__ void wait_empty() const {
    mbar_wait(empty + 8 * stage, phase ^ 1);
  }
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The consumers' mainloop for one tile: acc = the sum over `kblocks`
// k-steps of `mma(slot, acc)`, which issues a step's wgmma products from
// the stage at `slot`. Each stage is freed once the products of the step
// after it have been issued and its own are done. kGenericWrites: the
// producer fills A with cp.async (generic proxy), so the stage is fenced
// for wgmma's (async proxy) reads after it is seen full.
template <bool kGenericWrites, class RingT, int NH, class Mma>
__device__ __forceinline__ void consume_tile(RingT& ring, int kblocks,
                                             int lane, float (&acc)[NH][64],
                                             const Mma& mma) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    c3w::fence_acc(acc[h]);
  }
  int prev = -1;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(ring.full_bar(), ring.phase);
    if (kGenericWrites) c3w::fence_async_smem();
    c3w::wg_fence();
    mma(ring.slot(), acc);
    c3w::wg_commit();
    c3w::wg_wait<1>();  // k-step kb - 1 is done: its stage is free
    if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + 8 * prev);
    prev = ring.stage;
    ring.next();
  }
  c3w::wg_wait<0>();
  if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + 8 * prev);
#pragma unroll
  for (int h = 0; h < NH; ++h) c3w::fence_acc(acc[h]);
}

// The epilogue: a consumer warp's accumulator rows row0 (= the tile's
// first row + 64 consumer + 16 warp + lane / 4) and row0 + 8, columns
// col0 + 128 h + 8 c + 2 (lane % 4) (+ 1), stored to the row-major (m, n)
// output without staging, rounded once; rows past m and columns past n are
// dropped (n % 8 == 0, so a pair is in or out together).
template <int NH>
__device__ __forceinline__ void store_tile(const float (&acc)[NH][64],
                                           void* out, bool out_f32, int m,
                                           int n, int row0, int col0,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = col0 + 128 * h + 8 * c + 2 * (lane % 4);
      if (col >= n) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        if (row < m)
          store_out2(out, out_f32, static_cast<size_t>(row) * n + col,
                     acc[h][4 * c + 2 * rr], acc[h][4 * c + 2 * rr + 1]);
      }
    }
}

// ---- host -----------------------------------------------------------------

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so the library needs no -lcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a row-major (outer, inner) bf16 matrix read in
// (box_inner, box_outer) boxes with the 128-byte swizzle; out-of-bounds
// elements read as zero
inline bool make_map(CUtensorMap* map, const void* base, int inner, int outer,
                     int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tw
