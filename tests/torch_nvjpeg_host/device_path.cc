// zss_loader.cc's nvJPEG branch against stub CUDA and nvJPEG entry points
// that record the device each call runs on: every pool thread must bind the
// batch's device (cudaSetDevice) before its first nvJPEG or stream call, a
// handle, JPEG state or stream must only be used on the device it was made
// on, and the caller's own device must stay as it was. The stub decoder
// writes 10 * device + 1 into every pixel, so each image tells where it was
// decoded. Two ordinals in one process, then the caller's current device,
// then a single-image decode, then an ordinal the machine does not have.
// Prints each violation; exit code 1 when there is any.
//
//   g++ -std=c++17 -DZSS_JPEG_NVJPEG -I<this dir> -include <zss_loader.cc>
//       device_path.cc -lz -lpthread
#include <cstdio>
#include <set>

namespace stub {
constexpr int kDevices = 4;
std::mutex mu;
int violations = 0;
std::set<int> handle_devices, state_devices;
thread_local int current = 0;       // a fresh thread starts on device 0
thread_local bool bound = false;    // cudaSetDevice called on this thread

void fail(const char* what) {
  std::lock_guard<std::mutex> lock(mu);
  ++violations;
  printf("violation: %s (thread on device %d, bound %d)\n", what, current,
         int(bound));
}

// every nvJPEG and stream call: on a bound thread, on the object's device
void check(const char* what, int device) {
  if (!bound) fail(what);
  if (device != current) fail(what);
}
}  // namespace stub

struct nvjpegHandle { int device; };
struct nvjpegJpegState { int device; };
struct CUstream_st { int device; };

nvjpegStatus_t nvjpegCreateSimple(nvjpegHandle_t* h) {
  stub::check("nvjpegCreateSimple", stub::current);
  *h = new nvjpegHandle{stub::current};
  std::lock_guard<std::mutex> lock(stub::mu);
  stub::handle_devices.insert(stub::current);
  return NVJPEG_STATUS_SUCCESS;
}
nvjpegStatus_t nvjpegJpegStateCreate(nvjpegHandle_t h, nvjpegJpegState_t* s) {
  stub::check("nvjpegJpegStateCreate", h->device);
  *s = new nvjpegJpegState{stub::current};
  std::lock_guard<std::mutex> lock(stub::mu);
  stub::state_devices.insert(stub::current);
  return NVJPEG_STATUS_SUCCESS;
}
nvjpegStatus_t nvjpegJpegStateDestroy(nvjpegJpegState_t) { return NVJPEG_STATUS_SUCCESS; }
nvjpegStatus_t nvjpegGetImageInfo(nvjpegHandle_t h, const unsigned char*, size_t, int* n, nvjpegChromaSubsampling_t* css, int* w, int* hh) {
  stub::check("nvjpegGetImageInfo", h->device);
  *n = 1;  // gray: one plane, replicated to RGB on the host
  *css = NVJPEG_CSS_GRAY;
  w[0] = 8; hh[0] = 6;
  return NVJPEG_STATUS_SUCCESS;
}
nvjpegStatus_t nvjpegDecode(nvjpegHandle_t h, nvjpegJpegState_t s, const unsigned char*, size_t, nvjpegOutputFormat_t, nvjpegImage_t* img, cudaStream_t st) {
  stub::check("nvjpegDecode (handle)", h->device);
  stub::check("nvjpegDecode (state)", s->device);
  stub::check("nvjpegDecode (stream)", st->device);
  std::memset(img->channel[0], 10 * stub::current + 1, 8 * 6);
  return NVJPEG_STATUS_SUCCESS;
}
nvjpegStatus_t nvjpegGetProperty(libraryPropertyType, int* v) { *v = 0; return NVJPEG_STATUS_SUCCESS; }
cudaError_t cudaMalloc(void** p, size_t n) {
  stub::check("cudaMalloc", stub::current);
  *p = std::malloc(n);
  return cudaSuccess;
}
cudaError_t cudaFree(void* p) { std::free(p); return cudaSuccess; }
cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n, cudaMemcpyKind, cudaStream_t st) {
  stub::check("cudaMemcpyAsync", st->device);
  std::memcpy(dst, src, n);
  return cudaSuccess;
}
cudaError_t cudaStreamSynchronize(cudaStream_t st) {
  stub::check("cudaStreamSynchronize", st->device);
  return cudaSuccess;
}
cudaError_t cudaStreamCreateWithFlags(cudaStream_t* st, unsigned int) {
  stub::check("cudaStreamCreateWithFlags", stub::current);
  *st = new CUstream_st{stub::current};
  return cudaSuccess;
}
cudaError_t cudaSetDevice(int d) {
  if (d < 0 || d >= stub::kDevices) return cudaErrorInvalidDevice;
  stub::current = d;
  stub::bound = true;
  return cudaSuccess;
}
cudaError_t cudaGetDevice(int* d) { *d = stub::current; return cudaSuccess; }
cudaError_t cudaGetDeviceCount(int* n) { *n = stub::kDevices; return cudaSuccess; }

// one batch of `n` images on 4 threads; every pixel must be 10 * want + 1
void batch(std::vector<const char*> paths, int want) {
  int n = int(paths.size());
  std::vector<uint8_t> img(size_t(n) * 16 * 16 * 3);
  std::vector<int8_t> lbl(size_t(n) * 16 * 16);
  std::vector<int> sizes(2 * n);
  std::vector<const char*> labels(n, nullptr);
  int rc = zss_load_batch_compact(paths.data(), labels.data(), n, img.data(),
                                  lbl.data(), sizes.data(), 16, 16, 0, 1, 4);
  if (rc != 0) { printf("batch on device %d: rc=%d\n", want, rc); stub::fail("batch rc"); return; }
  for (int i = 0; i < n; ++i)
    for (int y = 0; y < 6; ++y)
      for (int x = 0; x < 8 * 3; ++x)
        if (img[size_t(i) * 16 * 16 * 3 + y * 16 * 3 + x] != 10 * want + 1) {
          printf("image %d of the batch on device %d decoded elsewhere\n", i, want);
          stub::fail("pixel");
          return;
        }
  printf("batch of %d on device %d: ok\n", n, want);
}

int main(int argc, char** argv) {
  std::vector<const char*> paths(argv + 1, argv + argc);
  if (paths.empty()) { printf("usage: device_path <any non-empty files>\n"); return 2; }
  // two ordinals, each twice: the second batch reuses that device's contexts
  for (int d : {1, 2, 1, 2}) {
    if (zss_set_device(d) != 0) stub::fail("zss_set_device");
    batch(paths, d);
  }
  // -1: the calling thread's current device when the batch starts
  stub::current = 3;
  if (zss_set_device(-1) != 0) stub::fail("zss_set_device(-1)");
  batch(paths, 3);
  // one image: decoded on a pool thread bound to the feed device, the
  // caller's device untouched
  if (zss_set_device(2) != 0) stub::fail("zss_set_device(2)");
  std::vector<float> one(16 * 16 * 3);
  int size[2];
  stub::current = 0;
  if (zss_decode_image(paths[0], one.data(), 16, 16, size) != 0) stub::fail("decode_image rc");
  if (stub::current != 0 || stub::bound) stub::fail("the caller's device changed");
  char info[1024];
  if (zss_build_info(info, sizeof info) != 0 || !std::strstr(info, "\"device\": 2"))
    stub::fail("build_info names the last decode's device");
  printf("%s\n", info);
  // an ordinal the machine does not have is refused, and the thread's
  // feed device stays
  if (zss_set_device(stub::kDevices) != -8) stub::fail("zss_set_device(4) != -8");
  if (zss_set_device(-2) != -8) stub::fail("zss_set_device(-2) != -8");
  batch(paths, 2);
  if (stub::handle_devices != std::set<int>{1, 2, 3})
    stub::fail("one handle a device");
  if (stub::state_devices != std::set<int>{1, 2, 3})
    stub::fail("contexts on each device");
  printf("violations=%d\n", stub::violations);
  return stub::violations != 0;
}
