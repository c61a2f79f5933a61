#pragma once
// The few CUDA runtime declarations csrc/zss_loader.cc names (see
// nvjpeg.h here). Not NVIDIA's header.
#include <cstddef>
typedef enum { cudaSuccess = 0 } cudaError_t;
struct CUstream_st; typedef struct CUstream_st* cudaStream_t;
enum cudaMemcpyKind { cudaMemcpyDeviceToHost = 2 };
#define cudaStreamNonBlocking 0x01
cudaError_t cudaMalloc(void** p, size_t n);
template <class T> cudaError_t cudaMalloc(T** p, size_t n) { return cudaMalloc((void**)p, n); }
cudaError_t cudaFree(void* p);
cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n, cudaMemcpyKind k, cudaStream_t s);
cudaError_t cudaStreamSynchronize(cudaStream_t s);
cudaError_t cudaStreamCreateWithFlags(cudaStream_t* s, unsigned int flags);
