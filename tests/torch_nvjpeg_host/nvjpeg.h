#pragma once
// The few nvJPEG declarations csrc/zss_loader.cc names, so its nvJPEG
// branch compiles on a machine without the CUDA toolkit; the functions are
// stubs defined in host_path.cc. Not NVIDIA's header.
#include <cstddef>
#include "cuda_runtime.h"
#define NVJPEG_MAX_COMPONENT 4
typedef enum { NVJPEG_STATUS_SUCCESS = 0, NVJPEG_STATUS_ERR = 1 } nvjpegStatus_t;
typedef enum { NVJPEG_CSS_444 = 0, NVJPEG_CSS_422 = 1, NVJPEG_CSS_420 = 2, NVJPEG_CSS_440 = 3, NVJPEG_CSS_411 = 4, NVJPEG_CSS_410 = 5, NVJPEG_CSS_GRAY = 6, NVJPEG_CSS_UNKNOWN = -1 } nvjpegChromaSubsampling_t;
typedef enum { NVJPEG_OUTPUT_UNCHANGED = 0, NVJPEG_OUTPUT_YUV = 1, NVJPEG_OUTPUT_Y = 2, NVJPEG_OUTPUT_RGB = 3, NVJPEG_OUTPUT_BGR = 4, NVJPEG_OUTPUT_RGBI = 5 } nvjpegOutputFormat_t;
typedef struct { unsigned char* channel[NVJPEG_MAX_COMPONENT]; size_t pitch[NVJPEG_MAX_COMPONENT]; } nvjpegImage_t;
struct nvjpegHandle; typedef struct nvjpegHandle* nvjpegHandle_t;
struct nvjpegJpegState; typedef struct nvjpegJpegState* nvjpegJpegState_t;
typedef enum { MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL } libraryPropertyType;
nvjpegStatus_t nvjpegCreateSimple(nvjpegHandle_t* h);
nvjpegStatus_t nvjpegJpegStateCreate(nvjpegHandle_t h, nvjpegJpegState_t* s);
nvjpegStatus_t nvjpegJpegStateDestroy(nvjpegJpegState_t s);
nvjpegStatus_t nvjpegGetImageInfo(nvjpegHandle_t h, const unsigned char* data, size_t length, int* nComponents, nvjpegChromaSubsampling_t* subsampling, int* widths, int* heights);
nvjpegStatus_t nvjpegDecode(nvjpegHandle_t h, nvjpegJpegState_t s, const unsigned char* data, size_t length, nvjpegOutputFormat_t output_format, nvjpegImage_t* destination, cudaStream_t stream);
nvjpegStatus_t nvjpegGetProperty(libraryPropertyType type, int* value);
