// zss_loader: the port's native data path (host C++, not a kernel).
//
// JPEG/PNG/MAT decode, the BGR mean-subtraction transform (reference
// pascal_dataset.py:39,138-145), the label remaps (255 -> -1 pascal,
// value-1 context) and pad-to-bucket assembly, fused so a batch is written
// straight into the buffers the device feed copies from (pinned host memory
// when the loader feeds a card), decoded on a thread pool without the
// Python GIL. The C ABI, results and error codes are the JAX package's
// native loader's; data/native.py builds this file with g++ at first use and
// binds it with ctypes.
//
// Backends, chosen by the build from what the machine has:
//   JPEG  libjpeg (ZSS_JPEG_LIBJPEG) where jpeglib.h exists, else nvJPEG
//         from the CUDA toolkit (ZSS_JPEG_NVJPEG): the planes decoded on
//         the card and copied back, libjpeg's fancy chroma upsampling and
//         fixed-point YCbCr -> RGB done here (4:4:4, 4:2:2, 4:2:0, 4:4:0
//         and gray; other layouts take nvJPEG's own RGB), so its pixels
//         differ from libjpeg's by its IDCT's rounding alone; labels never
//         go through it.
//   PNG   this file's own reader over zlib (chunks, CRCs, inflate, the five
//         filters, Adam7, 1/2/4/8-bit gray and palette), on every machine:
//         the result libpng gives with the JAX loader's transformations
//         (palette indices as values, gray 1/2/4-bit scaled to 8 bits).
//   MAT   the MAT5 reader for SBD GTcls, miCOMPRESSED through zlib.
//
// C ABI:
//   zss_decode_image       : one JPEG -> transformed float32 HWC in a bucket
//   zss_decode_label       : one PNG/MAT -> remapped int32 HW in a bucket
//   zss_load_batch         : N pairs, float32/int32, decoded in parallel
//   zss_load_batch_compact : N pairs, uint8 RGB/int8, decoded in parallel
//   zss_build_info         : the toolchain this library was built with
// All functions return 0 on success, negative error codes otherwise:
// -1 unreadable or undecodable file, -2 larger than the bucket (a label's
// size is reported all the same, so a caller can retry), -3 MAT
// without a Segmentation matrix, -4 unknown label format, -5 label value
// outside int8, -6 out of memory, -7 any other exception.

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#if defined(ZSS_JPEG_NVJPEG)
#include <cuda_runtime.h>
#include <mutex>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif

namespace {

constexpr double kMeanBGR[3] = {104.00698793, 116.66876762, 122.67891434};
// dimension sanity bound for decoded rasters: hostile/corrupt headers can
// claim exabyte-scale dims; anything past ~134 M pixels is not a dataset
// image and must fail with an error code, not an allocation attempt
constexpr size_t kMaxPixels = size_t(1) << 27;

// Exceptions must never cross the extern "C" / thread boundary (they would
// std::terminate the host process mid-epoch). bad_alloc from a corrupt
// header's resize maps to -6, anything else to -7.
template <typename F>
int guarded(F&& f) noexcept {
  try {
    return f();
  } catch (const std::bad_alloc&) {
    return -6;
  } catch (...) {
    return -7;
  }
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long size = ok ? ftell(f) : -1;
  ok = size >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(size_t(size));
    ok = fread(buf->data(), 1, size_t(size), f) == size_t(size);
  }
  fclose(f);
  return ok;
}

#if defined(ZSS_JPEG_NVJPEG)

// nvJPEG: one library handle; decoder contexts (a JPEG state, a
// non-blocking stream, so a decode never waits on the training stream, and
// a device buffer) are kept on a free list and reused by whichever pool
// thread takes one, for the life of the process.
struct NvContext {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dbuf = nullptr;
  size_t cap = 0;
};

std::once_flag g_nv_once;
nvjpegHandle_t g_nv_handle = nullptr;
std::mutex g_nv_mu;
std::vector<NvContext*> g_nv_free;

NvContext* acquire_context() {
  std::call_once(g_nv_once, [] {
    if (nvjpegCreateSimple(&g_nv_handle) != NVJPEG_STATUS_SUCCESS)
      g_nv_handle = nullptr;
  });
  if (!g_nv_handle) return nullptr;
  {
    std::lock_guard<std::mutex> lock(g_nv_mu);
    if (!g_nv_free.empty()) {
      NvContext* ctx = g_nv_free.back();
      g_nv_free.pop_back();
      return ctx;
    }
  }
  auto* ctx = new NvContext;
  if (nvjpegJpegStateCreate(g_nv_handle, &ctx->state) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&ctx->stream, cudaStreamNonBlocking) !=
          cudaSuccess) {
    if (ctx->state) nvjpegJpegStateDestroy(ctx->state);
    delete ctx;
    return nullptr;
  }
  return ctx;
}

void release_context(NvContext* ctx) {
  std::lock_guard<std::mutex> lock(g_nv_mu);
  g_nv_free.push_back(ctx);
}

// libjpeg's colour space for a three-component image (jdapimin.c's
// default_decompress_parms): a JFIF marker means YCbCr, an Adobe marker its
// transform flag (0: RGB), else component ids 'R','G','B' mean RGB.
bool jpeg_is_ycbcr(const std::vector<uint8_t>& d) {
  bool jfif = false;
  int adobe = -1, ids[3] = {1, 2, 3};
  size_t i = 2;
  while (i + 4 <= d.size() && d[i] == 0xff) {
    uint8_t m = d[i + 1];
    if (m == 0xff) { ++i; continue; }  // fill byte
    size_t len = (size_t(d[i + 2]) << 8) | d[i + 3];
    if (len < 2 || i + 2 + len > d.size()) break;
    const uint8_t* p = &d[i + 4];
    if (m == 0xe0 && len >= 7 && std::memcmp(p, "JFIF", 5) == 0) jfif = true;
    if (m == 0xee && len >= 14 && std::memcmp(p, "Adobe", 5) == 0)
      adobe = p[11];
    if ((m >= 0xc0 && m <= 0xcf && m != 0xc4 && m != 0xc8 && m != 0xcc) &&
        len >= 8 + 3 * 3 && p[5] == 3)
      for (int c = 0; c < 3; ++c) ids[c] = p[6 + 3 * c];
    if (m == 0xda) break;  // start of scan: the headers are done
    i += 2 + len;
  }
  if (jfif) return true;
  if (adobe >= 0) return adobe != 0;
  return !(ids[0] == 'R' && ids[1] == 'G' && ids[2] == 'B');
}

// libjpeg-turbo's chroma upsampling (jdsample.c) of one plane, (ch, cw)
// with row pitch `pitch`, by (hs, vs) in {1, 2}, into (h, w): "fancy"
// (triangular), edge rows and columns replicated as libjpeg's context rows
// are, except that a plane at most 2 samples wide is doubled in width by
// replication (box), as jinit_upsampler picks.
void fancy_upsample(const uint8_t* in, size_t pitch, int ch, int cw, int hs,
                    int vs, int h, int w, std::vector<uint8_t>* out) {
  std::vector<uint8_t> full(size_t(ch * vs) * cw * hs);
  std::vector<int> sums(cw);
  bool box = hs == 2 && cw <= 2;
  for (int r = 0; r < ch; ++r) {
    const uint8_t* row = in + size_t(r) * pitch;
    for (int v = 0; v < vs; ++v) {
      uint8_t* o = full.data() + size_t(r * vs + v) * cw * hs;
      if (box) {  // h2v1_upsample, h2v2_upsample
        for (int c = 0; c < cw; ++c) o[2 * c] = o[2 * c + 1] = row[c];
        continue;
      }
      if (vs == 1) {
        if (hs == 1) {
          std::memcpy(o, row, cw);
        } else {  // h2v1_fancy_upsample
          o[0] = row[0];
          o[1] = uint8_t((row[0] * 3 + row[1] + 2) >> 2);
          for (int c = 1; c < cw - 1; ++c) {
            int x = row[c] * 3;
            o[2 * c] = uint8_t((x + row[c - 1] + 1) >> 2);
            o[2 * c + 1] = uint8_t((x + row[c + 1] + 2) >> 2);
          }
          o[2 * cw - 2] = uint8_t((row[cw - 1] * 3 + row[cw - 2] + 1) >> 2);
          o[2 * cw - 1] = row[cw - 1];
        }
        continue;
      }
      // vs == 2: the far row is the one above (v = 0) or below (v = 1)
      int far = v == 0 ? std::max(r - 1, 0) : std::min(r + 1, ch - 1);
      const uint8_t* row1 = in + size_t(far) * pitch;
      for (int c = 0; c < cw; ++c) sums[c] = row[c] * 3 + row1[c];
      if (hs == 1) {  // h1v2_fancy_upsample
        for (int c = 0; c < cw; ++c)
          o[c] = uint8_t((sums[c] + (v == 0 ? 1 : 2)) >> 2);
      } else {  // h2v2_fancy_upsample
        o[0] = uint8_t((sums[0] * 4 + 8) >> 4);
        o[1] = uint8_t((sums[0] * 3 + sums[1] + 7) >> 4);
        for (int c = 1; c < cw - 1; ++c) {
          o[2 * c] = uint8_t((sums[c] * 3 + sums[c - 1] + 8) >> 4);
          o[2 * c + 1] = uint8_t((sums[c] * 3 + sums[c + 1] + 7) >> 4);
        }
        o[2 * cw - 2] = uint8_t((sums[cw - 1] * 3 + sums[cw - 2] + 8) >> 4);
        o[2 * cw - 1] = uint8_t((sums[cw - 1] * 4 + 7) >> 4);
      }
    }
  }
  out->resize(size_t(h) * w);
  for (int y = 0; y < h; ++y)
    std::memcpy(out->data() + size_t(y) * w,
                full.data() + size_t(y) * cw * hs, w);
}

// libjpeg's YCbCr -> RGB (jdcolor.c: 16-bit fixed-point tables, rounded
// once, clamped).
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    auto fix = [](double x) { return int32_t(x * 65536 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};

uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

bool nv_decode(NvContext* ctx, const std::vector<uint8_t>& data,
               std::vector<uint8_t>* out, int* h, int* w) {
  static const YccTables ycc;
  int comps = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_nv_handle, data.data(), data.size(), &comps,
                         &subsampling, widths, heights) !=
      NVJPEG_STATUS_SUCCESS)
    return false;
  // libjpeg's JCS_RGB output takes gray and three-component images only
  if (comps != 1 && comps != 3) return false;
  *w = widths[0];
  *h = heights[0];
  if (*h <= 0 || *w <= 0 || size_t(*h) * *w > kMaxPixels) return false;
  // planar Y (and Cb, Cr at their own sizes) where this file upsamples
  // and converts as libjpeg does; nvJPEG's own RGB for the rest
  int hs = 0, vs = 0;
  switch (subsampling) {
    case NVJPEG_CSS_444: hs = 1; vs = 1; break;
    case NVJPEG_CSS_422: hs = 2; vs = 1; break;
    case NVJPEG_CSS_420: hs = 2; vs = 2; break;
    case NVJPEG_CSS_440: hs = 1; vs = 2; break;
    default: break;
  }
  bool gray = comps == 1;
  bool planar = gray || (hs && jpeg_is_ycbcr(data));
  int cw = planar && !gray ? (*w + hs - 1) / hs : 0;
  int ch = planar && !gray ? (*h + vs - 1) / vs : 0;
  if (cw && (widths[1] < cw || heights[1] < ch || widths[2] < cw ||
             heights[2] < ch))
    return false;
  size_t y_bytes = size_t(*h) * *w;
  size_t c_bytes = cw ? size_t(heights[1]) * widths[1] : 0;
  size_t need = planar ? y_bytes + 2 * c_bytes : y_bytes * 3;
  if (need > ctx->cap) {
    if (ctx->dbuf) cudaFree(ctx->dbuf);
    ctx->dbuf = nullptr;
    ctx->cap = 0;
    if (cudaMalloc(&ctx->dbuf, need) != cudaSuccess) return false;
    ctx->cap = need;
  }
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof image);
  nvjpegOutputFormat_t format;
  if (!planar) {
    format = NVJPEG_OUTPUT_RGBI;
    image.channel[0] = ctx->dbuf;
    image.pitch[0] = size_t(*w) * 3;
  } else if (gray) {
    format = NVJPEG_OUTPUT_Y;
    image.channel[0] = ctx->dbuf;
    image.pitch[0] = size_t(*w);
  } else {
    format = NVJPEG_OUTPUT_YUV;
    image.channel[0] = ctx->dbuf;
    image.pitch[0] = size_t(*w);
    for (int c = 1; c < 3; ++c) {
      image.channel[c] = ctx->dbuf + y_bytes + (c - 1) * c_bytes;
      image.pitch[c] = size_t(widths[1]);
    }
  }
  if (nvjpegDecode(g_nv_handle, ctx->state, data.data(), data.size(),
                   format, &image, ctx->stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  std::vector<uint8_t> host(need);
  if (cudaMemcpyAsync(host.data(), ctx->dbuf, need, cudaMemcpyDeviceToHost,
                      ctx->stream) != cudaSuccess ||
      cudaStreamSynchronize(ctx->stream) != cudaSuccess)
    return false;
  out->resize(y_bytes * 3);
  uint8_t* o = out->data();
  if (!planar) {
    std::memcpy(o, host.data(), y_bytes * 3);
  } else if (gray) {
    for (size_t i = 0; i < y_bytes; ++i) o[3 * i] = o[3 * i + 1] =
        o[3 * i + 2] = host[i];
  } else {
    std::vector<uint8_t> cb, cr;
    fancy_upsample(host.data() + y_bytes, size_t(widths[1]), ch, cw, hs, vs,
                   *h, *w, &cb);
    fancy_upsample(host.data() + y_bytes + c_bytes, size_t(widths[1]), ch,
                   cw, hs, vs, *h, *w, &cr);
    for (size_t i = 0; i < y_bytes; ++i) {
      int y = host[i], b = cb[i], r = cr[i];
      o[3 * i] = clamp255(y + ycc.cr_r[r]);
      o[3 * i + 1] = clamp255(y + int((ycc.cb_g[b] + ycc.cr_g[r]) >> 16));
      o[3 * i + 2] = clamp255(y + ycc.cb_b[b]);
    }
  }
  return true;
}

// Decode a JPEG into RGB8; returns false on failure.
bool decode_jpeg_rgb(const char* path, std::vector<uint8_t>* out,
                     int* h, int* w) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data) || data.empty()) return false;
  NvContext* ctx = acquire_context();
  if (!ctx) return false;
  bool ok;
  try {
    ok = nv_decode(ctx, data, out, h, w);
  } catch (...) {
    release_context(ctx);
    throw;
  }
  release_context(ctx);
  return ok;
}

#else  // libjpeg

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG into RGB8; returns false on failure.
bool decode_jpeg_rgb(const char* path, std::vector<uint8_t>* out,
                     int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  if (*h <= 0 || *w <= 0 || size_t(*h) * *w > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  out->resize(size_t(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

#endif

// ---------------------------------------------------------------------------
// PNG reader for label maps: 8-bit or packed 1/2/4-bit gray and palette
// images, any filter, Adam7 or not. It fails where libpng (as the JAX loader
// drives it) fails: a bad signature, IHDR not first or invalid, a CRC error
// in a critical chunk, an unknown critical chunk, a palette image without a
// PLTE before its IDAT, a corrupt or short zlib stream, a bad filter byte,
// more than 16-bit depth or a color type other than gray and palette, and
// libpng's default 1,000,000-pixel limit on either side.
// ---------------------------------------------------------------------------

constexpr uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
constexpr uint32_t kPngUserMax = 1000000;  // PNG_USER_{WIDTH,HEIGHT}_MAX

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool chunk_name_valid(const uint8_t* t) {
  for (int i = 0; i < 4; ++i) {
    uint8_t c = t[i];
    if (!((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z'))) return false;
  }
  return true;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Reverses one row's filter in place (bpp = 1: at most 8 bits a pixel).
bool unfilter_row(uint8_t filter, uint8_t* row, const uint8_t* prev,
                  size_t n) {
  switch (filter) {
    case 0:
      return true;
    case 1:
      for (size_t i = 1; i < n; ++i) row[i] = uint8_t(row[i] + row[i - 1]);
      return true;
    case 2:
      if (prev)
        for (size_t i = 0; i < n; ++i) row[i] = uint8_t(row[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        int left = i ? row[i - 1] : 0, up = prev ? prev[i] : 0;
        row[i] = uint8_t(row[i] + ((left + up) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        int left = i ? row[i - 1] : 0, up = prev ? prev[i] : 0;
        int ul = (i && prev) ? prev[i - 1] : 0;
        row[i] = uint8_t(row[i] + paeth(left, up, ul));
      }
      return true;
    default:
      return false;  // libpng: "bad adaptive filter value"
  }
}

// One packed sample of a row: palette indices stay as they are, gray is
// scaled to 8 bits as png_set_expand_gray_1_2_4_to_8 does.
uint16_t sample(const uint8_t* row, size_t x, int depth, bool gray) {
  if (depth == 8) return row[x];
  int per_byte = 8 / depth;
  int shift = 8 - depth * int(x % per_byte + 1);
  int v = (row[x / per_byte] >> shift) & ((1 << depth) - 1);
  if (gray) v = v * (255 / ((1 << depth) - 1));
  return uint16_t(v);
}

bool decode_png_gray(const char* path, std::vector<uint16_t>* out,
                     int* h, int* w) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return false;
  if (buf.size() < 8 || std::memcmp(buf.data(), kPngSig, 8) != 0)
    return false;
  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int depth = 0, color = -1, interlace = 0;
  bool have_ihdr = false, have_plte = false;
  std::vector<uint8_t> idat;
  bool in_idat = false;
  for (;;) {
    // libpng reads nothing after the image data it needs: whatever follows
    // the last IDAT (IEND, a torn tail) is not looked at
    bool more = buf.size() - pos >= 12;
    if (in_idat && (!more || std::memcmp(&buf[pos + 4], "IDAT", 4) != 0))
      break;
    if (!more) return false;  // truncated
    uint32_t len = be32(&buf[pos]);
    const uint8_t* type = &buf[pos + 4];
    if (len > 0x7fffffffu || !chunk_name_valid(type)) return false;
    if (buf.size() - pos - 12 < len) return false;
    const uint8_t* data = &buf[pos + 8];
    bool critical = (type[0] & 0x20) == 0;
    if (critical) {
      uint32_t crc = uint32_t(crc32(0L, type, 4 + len));
      if (crc != be32(data + len)) return false;
    }
    bool is_idat = std::memcmp(type, "IDAT", 4) == 0;
    if (!have_ihdr && std::memcmp(type, "IHDR", 4) != 0) return false;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_ihdr || len != 13) return false;
      width = be32(data);
      height = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
      if (width == 0 || height == 0 || width > kPngUserMax ||
          height > kPngUserMax || data[10] != 0 || data[11] != 0 ||
          interlace > 1)
        return false;
      bool valid;
      switch (color) {
        case 0: valid = depth == 1 || depth == 2 || depth == 4 ||
                        depth == 8 || depth == 16; break;
        case 3: valid = depth == 1 || depth == 2 || depth == 4 ||
                        depth == 8; break;
        case 2: case 4: case 6: valid = depth == 8 || depth == 16; break;
        default: valid = false;
      }
      if (!valid) return false;
      // the JAX loader reads gray and palette indices of at most 8 bits
      if (depth > 8 || (color != 0 && color != 3)) return false;
      have_ihdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (have_plte) return false;
      if (color == 3 && (len > 3 * 256 || len % 3 != 0)) return false;
      have_plte = true;
    } else if (is_idat) {
      if (color == 3 && !have_plte) return false;
      in_idat = true;
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      return false;  // no image data
    } else if (critical) {
      return false;  // unknown critical chunk
    }
    pos += 12 + size_t(len);
  }
  *w = int(width);
  *h = int(height);
  if (size_t(*h) * *w > kMaxPixels) return false;

  // the seven Adam7 passes, or one pass over the whole image
  static const int kStartX[7] = {0, 4, 0, 2, 0, 1, 0};
  static const int kStartY[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int kStepX[7] = {8, 8, 4, 4, 2, 2, 1};
  static const int kStepY[7] = {8, 8, 8, 4, 4, 2, 2};
  int passes = interlace ? 7 : 1;
  size_t pw[7], ph[7], need = 0;
  for (int p = 0; p < passes; ++p) {
    int sx = interlace ? kStartX[p] : 0, sy = interlace ? kStartY[p] : 0;
    int dx = interlace ? kStepX[p] : 1, dy = interlace ? kStepY[p] : 1;
    pw[p] = width > uint32_t(sx) ? (width - sx + dx - 1) / dx : 0;
    ph[p] = height > uint32_t(sy) ? (height - sy + dy - 1) / dy : 0;
    if (pw[p] && ph[p]) need += ph[p] * (1 + (pw[p] * depth + 7) / 8);
  }
  std::vector<uint8_t> raw(need);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(need);
  int rc = Z_OK;
  while (zs.avail_out > 0 && rc == Z_OK) rc = inflate(&zs, Z_NO_FLUSH);
  bool complete = zs.avail_out == 0;  // extra data after the image is fine
  inflateEnd(&zs);
  if (!complete) return false;  // "Not enough image data" or a zlib error

  out->assign(size_t(*h) * *w, 0);
  bool gray = color == 0;
  uint8_t* row = raw.data();
  for (int p = 0; p < passes; ++p) {
    if (!pw[p] || !ph[p]) continue;
    size_t rowbytes = (pw[p] * depth + 7) / 8;
    const uint8_t* prev = nullptr;
    int sx = interlace ? kStartX[p] : 0, sy = interlace ? kStartY[p] : 0;
    int dx = interlace ? kStepX[p] : 1, dy = interlace ? kStepY[p] : 1;
    for (size_t y = 0; y < ph[p]; ++y) {
      uint8_t* px = row + 1;
      if (!unfilter_row(row[0], px, prev, rowbytes)) return false;
      size_t oy = sy + y * dy;
      for (size_t x = 0; x < pw[p]; ++x)
        (*out)[oy * *w + sx + x * dx] = sample(px, x, depth, gray);
      prev = px;
      row += 1 + rowbytes;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// MATLAB v5 .mat reader — just enough for SBD GTcls segmentation labels
// (reference pascal_dataset.py:70-71: mat['GTcls'][0]['Segmentation'][0]).
// Supports little-endian files, miCOMPRESSED top elements (zlib), struct
// arrays, and uint8/int8/uint16/int16/int32/double numeric matrices stored
// column-major.
// ---------------------------------------------------------------------------

constexpr uint32_t miINT32 = 5, miUINT32 = 6, miMATRIX = 14, miCOMPRESSED = 15;

struct Cursor {
  const uint8_t* p;
  size_t n;
};

uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Reads one data element (handles the small-element format); advances cur.
bool next_element(Cursor* cur, uint32_t* type, uint32_t* bytes,
                  const uint8_t** data) {
  if (cur->n < 8) return false;
  uint32_t t = rd32(cur->p);
  if (t >> 16) {  // small element: size in upper 16 bits, data inline
    *type = t & 0xffff;
    *bytes = t >> 16;
    *data = cur->p + 4;
    cur->p += 8;
    cur->n -= 8;
    return *bytes <= 4;
  }
  *type = t;
  *bytes = rd32(cur->p + 4);
  *data = cur->p + 8;
  if (cur->n < 8 + size_t(*bytes)) return false;
  // the final element may omit its 8-byte alignment padding at EOF
  size_t padded = (*bytes + 7) & ~size_t(7);
  size_t adv = 8 + padded < cur->n ? 8 + padded : cur->n;
  cur->p += adv;
  cur->n -= adv;
  return true;
}

// Parse a numeric miMATRIX payload into int32 row-major; returns false if not
// a 2-D numeric matrix.
bool parse_numeric_matrix(Cursor body, std::vector<int32_t>* out,
                          int* h, int* w) {
  uint32_t type, bytes;
  const uint8_t* data;
  if (!next_element(&body, &type, &bytes, &data) || type != miUINT32)
    return false;  // array flags
  if (!next_element(&body, &type, &bytes, &data) || type != miINT32 ||
      bytes != 8)
    return false;  // dims (2-D only)
  int rows = int(rd32(data)), cols = int(rd32(data + 4));
  // corrupt dims must fail here, not as an exabyte resize
  if (rows <= 0 || cols <= 0 || size_t(rows) * size_t(cols) > kMaxPixels)
    return false;
  if (!next_element(&body, &type, &bytes, &data)) return false;  // name
  if (!next_element(&body, &type, &bytes, &data)) return false;  // real part
  size_t count = size_t(rows) * cols;
  out->resize(count);
  auto fill = [&](auto get, size_t elem) {
    if (bytes < count * elem) return false;
    for (int c = 0; c < cols; ++c)
      for (int r = 0; r < rows; ++r)  // column-major -> row-major
        (*out)[size_t(r) * cols + c] = get(data + (size_t(c) * rows + r) * elem);
    return true;
  };
  bool ok;
  switch (type) {
    case 1:  // miINT8
      ok = fill([](const uint8_t* p) { return int32_t(int8_t(*p)); }, 1);
      break;
    case 2:  // miUINT8
      ok = fill([](const uint8_t* p) { return int32_t(*p); }, 1);
      break;
    case 3:  // miINT16
      ok = fill([](const uint8_t* p) { int16_t v; std::memcpy(&v, p, 2);
                                       return int32_t(v); }, 2);
      break;
    case 4:  // miUINT16
      ok = fill([](const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2);
                                       return int32_t(v); }, 2);
      break;
    case miINT32:
      ok = fill([](const uint8_t* p) { int32_t v; std::memcpy(&v, p, 4);
                                       return v; }, 4);
      break;
    case 9:  // miDOUBLE
      ok = fill([](const uint8_t* p) { double v; std::memcpy(&v, p, 8);
                                       return int32_t(v); }, 8);
      break;
    default:
      return false;
  }
  if (!ok) return false;
  *h = rows;
  *w = cols;
  return true;
}

// Walk a struct miMATRIX payload and extract the named field's numeric matrix.
bool parse_struct_field(Cursor body, const char* want_field,
                        std::vector<int32_t>* out, int* h, int* w) {
  uint32_t type, bytes;
  const uint8_t* data;
  if (!next_element(&body, &type, &bytes, &data) || type != miUINT32 ||
      bytes < 8)
    return false;
  uint32_t array_class = rd32(data) & 0xff;
  if (array_class != 2) return false;  // mxSTRUCT_CLASS
  if (!next_element(&body, &type, &bytes, &data)) return false;  // dims
  if (!next_element(&body, &type, &bytes, &data)) return false;  // name
  if (!next_element(&body, &type, &bytes, &data) || bytes < 4)
    return false;  // field name length
  int fnlen = int(rd32(data));
  if (fnlen <= 0 || fnlen > 256) return false;
  if (!next_element(&body, &type, &bytes, &data)) return false;  // field names
  int n_fields = int(bytes) / fnlen;
  int want = -1;
  for (int i = 0; i < n_fields; ++i) {
    const char* name = reinterpret_cast<const char*>(data) + size_t(i) * fnlen;
    if (std::strncmp(name, want_field, fnlen) == 0) want = i;
  }
  if (want < 0) return false;
  for (int i = 0; i <= want; ++i) {  // fields follow in declaration order
    if (!next_element(&body, &type, &bytes, &data) || type != miMATRIX)
      return false;
    if (i == want)
      return parse_numeric_matrix(Cursor{data, bytes}, out, h, w);
  }
  return false;
}

bool decode_mat_label(const char* path, std::vector<int32_t>* out,
                      int* h, int* w) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf) || buf.size() < 136) return false;
  // 128-byte header; bytes 126-127 are the endian indicator "IM" (LE)
  if (!(buf[126] == 'I' && buf[127] == 'M')) return false;

  Cursor cur{buf.data() + 128, buf.size() - 128};
  uint32_t type, bytes;
  const uint8_t* data;
  std::vector<uint8_t> inflated;
  while (next_element(&cur, &type, &bytes, &data)) {
    Cursor body{data, bytes};
    if (type == miCOMPRESSED) {
      // inflate; SBD GTcls elements are a few hundred KB uncompressed
      inflated.resize(size_t(bytes) * 8 + (1 << 16));
      uLongf dst_len = uLongf(inflated.size());
      for (int attempt = 0; attempt < 4; ++attempt) {
        int rc = uncompress(inflated.data(), &dst_len, data, bytes);
        if (rc == Z_OK) break;
        if (rc != Z_BUF_ERROR) return false;
        inflated.resize(inflated.size() * 4);
        dst_len = uLongf(inflated.size());
      }
      Cursor icur{inflated.data(), size_t(dst_len)};
      uint32_t itype, ibytes;
      const uint8_t* idata;
      if (!next_element(&icur, &itype, &ibytes, &idata) || itype != miMATRIX)
        continue;
      body = Cursor{idata, ibytes};
    } else if (type != miMATRIX) {
      continue;
    }
    if (parse_struct_field(body, "Segmentation", out, h, w)) return true;
  }
  return false;
}

int decode_image_impl(const char* path, float* out, int bucket_h,
                      int bucket_w, int* size_hw) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_jpeg_rgb(path, &rgb, &h, &w)) return -1;
  if (h > bucket_h || w > bucket_w) return -2;
  // zero-fill bucket, then RGB->BGR + mean-subtract into the top-left corner
  std::memset(out, 0, sizeof(float) * size_t(bucket_h) * bucket_w * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgb.data() + size_t(y) * w * 3;
    float* dst = out + size_t(y) * bucket_w * 3;
    for (int x = 0; x < w; ++x) {
      dst[x * 3 + 0] = float(src[x * 3 + 2] - kMeanBGR[0]);  // B
      dst[x * 3 + 1] = float(src[x * 3 + 1] - kMeanBGR[1]);  // G
      dst[x * 3 + 2] = float(src[x * 3 + 0] - kMeanBGR[2]);  // R
    }
  }
  if (size_hw) { size_hw[0] = h; size_hw[1] = w; }
  return 0;
}

int decode_label_impl(const char* path, int32_t* out, int bucket_h,
                      int bucket_w, int value_offset, int map255_to_ignore,
                      int* size_hw) {
  // dispatch by magic bytes: PNG label maps or MATLAB v5 (SBD GTcls)
  uint8_t magic[8] = {0};
  {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    size_t got = fread(magic, 1, sizeof magic, f);
    fclose(f);
    if (got < sizeof magic) return -1;
  }
  std::vector<int32_t> vals;
  int h = 0, w = 0;
  if (magic[0] == 0x89 && magic[1] == 'P') {
    std::vector<uint16_t> gray;
    if (!decode_png_gray(path, &gray, &h, &w)) return -1;
    vals.assign(gray.begin(), gray.end());
  } else if (std::memcmp(magic, "MATLAB", 6) == 0) {
    if (!decode_mat_label(path, &vals, &h, &w)) return -3;
  } else {
    return -4;  // unsupported label format
  }
  if (size_hw) { size_hw[0] = h; size_hw[1] = w; }
  if (h > bucket_h || w > bucket_w) return -2;
  for (int i = 0; i < bucket_h * bucket_w; ++i) out[i] = -1;  // pad = ignore
  for (int y = 0; y < h; ++y) {
    int32_t* dst = out + size_t(y) * bucket_w;
    const int32_t* src = vals.data() + size_t(y) * w;
    for (int x = 0; x < w; ++x) {
      int32_t v = src[x];
      if (map255_to_ignore && v == 255) v = -1;    // pascal 255 -> -1
      else v += value_offset;                      // context 1-indexed -> -1
      dst[x] = v;
    }
  }
  return 0;
}

int decode_image_u8_impl(const char* path, uint8_t* out, int bucket_h,
                         int bucket_w, int* size_hw) {
  // compact feed: raw RGB uint8 into the bucket (device-side normalization)
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_jpeg_rgb(path, &rgb, &h, &w)) return -1;
  if (h > bucket_h || w > bucket_w) return -2;
  std::memset(out, 0, size_t(bucket_h) * bucket_w * 3);
  for (int y = 0; y < h; ++y) {
    std::memcpy(out + size_t(y) * bucket_w * 3,
                rgb.data() + size_t(y) * w * 3, size_t(w) * 3);
  }
  if (size_hw) { size_hw[0] = h; size_hw[1] = w; }
  return 0;
}

int decode_label_i8_impl(const char* path, int8_t* out, int bucket_h,
                         int bucket_w, int value_offset, int map255_to_ignore,
                         int* size_hw) {
  // compact feed: int8 labels (class ids < 128 for every dataset; -1=ignore)
  std::vector<int32_t> wide(size_t(bucket_h) * bucket_w);
  int rc = decode_label_impl(path, wide.data(), bucket_h, bucket_w,
                             value_offset, map255_to_ignore, size_hw);
  if (rc != 0) return rc;
  for (size_t i = 0; i < wide.size(); ++i) {
    int32_t v = wide[i];
    if (v < -128 || v > 127) return -5;  // would not survive narrowing
    out[i] = int8_t(v);
  }
  return 0;
}

// Runs decode(i) for i in [0, n) on up to num_threads threads; the first
// failing sample's code, in sample order, or 0.
template <typename F>
int run_pool(int n, int num_threads, F decode) {
  if (num_threads < 1) num_threads = 1;
  std::vector<int> status(n, 0);
  std::atomic_int next_idx{0};
  auto worker = [&]() {
    for (int i = next_idx.fetch_add(1); i < n; i = next_idx.fetch_add(1)) {
      // guarded: an exception escaping a std::thread terminates the process
      status[i] = guarded([&] { return decode(i); });
    }
  };
  int threads = std::min(num_threads, n);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  for (int rc : status) if (rc != 0) return rc;
  return 0;
}

#define ZSS_STR2(x) #x
#define ZSS_STR(x) ZSS_STR2(x)

}  // namespace

extern "C" {

int zss_decode_image(const char* path, float* out, int bucket_h, int bucket_w,
                     int* size_hw) {
  return guarded([&] {
    return decode_image_impl(path, out, bucket_h, bucket_w, size_hw);
  });
}

int zss_decode_label(const char* path, int32_t* out, int bucket_h,
                     int bucket_w, int value_offset, int map255_to_ignore,
                     int* size_hw) {
  return guarded([&] {
    return decode_label_impl(path, out, bucket_h, bucket_w, value_offset,
                             map255_to_ignore, size_hw);
  });
}

// Decode a whole batch in parallel. images/labels are contiguous
// (n, bucket_h, bucket_w, 3) float32 / (n, bucket_h, bucket_w) int32 buffers;
// sizes is (n, 2) int32. A null label path skips the label slot.
int zss_load_batch(const char** image_paths, const char** label_paths, int n,
                   float* images, int32_t* labels, int* sizes, int bucket_h,
                   int bucket_w, int value_offset, int map255_to_ignore,
                   int num_threads) {
  return run_pool(n, num_threads, [&](int i) {
    int rc = decode_image_impl(
        image_paths[i], images + size_t(i) * bucket_h * bucket_w * 3,
        bucket_h, bucket_w, sizes + 2 * i);
    if (rc == 0 && label_paths && label_paths[i]) {
      rc = decode_label_impl(
          label_paths[i], labels + size_t(i) * bucket_h * bucket_w,
          bucket_h, bucket_w, value_offset, map255_to_ignore, nullptr);
    }
    return rc;
  });
}

// Compact-feed batch: (n, bh, bw, 3) uint8 RGB + (n, bh, bw) int8 labels —
// 4x fewer bytes than the float32/int32 batch; normalization happens on
// the device (transforms.prepare_images).
int zss_load_batch_compact(const char** image_paths, const char** label_paths,
                           int n, uint8_t* images, int8_t* labels, int* sizes,
                           int bucket_h, int bucket_w, int value_offset,
                           int map255_to_ignore, int num_threads) {
  return run_pool(n, num_threads, [&](int i) {
    int rc = decode_image_u8_impl(
        image_paths[i], images + size_t(i) * bucket_h * bucket_w * 3,
        bucket_h, bucket_w, sizes + 2 * i);
    if (rc == 0 && label_paths && label_paths[i]) {
      rc = decode_label_i8_impl(
          label_paths[i], labels + size_t(i) * bucket_h * bucket_w,
          bucket_h, bucket_w, value_offset, map255_to_ignore, nullptr);
    }
    return rc;
  });
}

// The toolchain as one JSON object: the compiler, the JPEG backend and its
// version, the PNG reader, zlib's version at build and at run time.
int zss_build_info(char* buf, int n) {
  return guarded([&] {
    std::string s = "{\"compiler\": \""
#if defined(__clang__)
        "clang "
#else
        "g++ "
#endif
        __VERSION__ "\", ";
#if defined(ZSS_JPEG_NVJPEG)
    int major = 0, minor = 0, patch = 0;
    nvjpegGetProperty(MAJOR_VERSION, &major);
    nvjpegGetProperty(MINOR_VERSION, &minor);
    nvjpegGetProperty(PATCH_LEVEL, &patch);
    s += "\"jpeg\": \"nvjpeg\", \"jpeg_version\": \"" +
         std::to_string(major) + "." + std::to_string(minor) + "." +
         std::to_string(patch) + "\", \"jpeg_lib_version\": null, " +
         "\"libjpeg_turbo\": null, ";
#else
    s += "\"jpeg\": \"libjpeg\", \"jpeg_version\": null, "
         "\"jpeg_lib_version\": " + std::to_string(JPEG_LIB_VERSION) + ", ";
#if defined(LIBJPEG_TURBO_VERSION)
    s += "\"libjpeg_turbo\": \"" ZSS_STR(LIBJPEG_TURBO_VERSION) "\", ";
#else
    s += "\"libjpeg_turbo\": null, ";
#endif
#endif
    s += "\"png\": \"zss_loader's own reader over zlib (no libpng)\", "
         "\"zlib_header\": \"" ZLIB_VERSION "\", \"zlib_runtime\": \"" +
         std::string(zlibVersion()) + "\"}";
    if (n <= 0 || size_t(n) <= s.size()) return -2;
    std::memcpy(buf, s.c_str(), s.size() + 1);
    return 0;
  });
}

}  // extern "C"
