// The host half of zss_loader.cc's nvJPEG branch (libjpeg's fancy chroma
// upsampling and YCbCr -> RGB over the decoded planes) against libjpeg
// itself: each JPEG named on the command line is decoded by libjpeg twice,
// to RGB and to its raw planes, and the planes go through the branch's
// `fancy_upsample` and `YccTables`; the two RGB images must be equal (the
// IDCT is libjpeg's in both). Exit code 1 when any pixel differs.
//
//   g++ -std=c++17 -DZSS_JPEG_NVJPEG -I<this dir> -include <zss_loader.cc>
//       host_path.cc -ljpeg -lz -lpthread
#include <jpeglib.h>
// the nvJPEG and CUDA entry points are never called: stubs so it links
nvjpegStatus_t nvjpegCreateSimple(nvjpegHandle_t*) { return NVJPEG_STATUS_ERR; }
nvjpegStatus_t nvjpegJpegStateCreate(nvjpegHandle_t, nvjpegJpegState_t*) { return NVJPEG_STATUS_ERR; }
nvjpegStatus_t nvjpegJpegStateDestroy(nvjpegJpegState_t) { return NVJPEG_STATUS_ERR; }
nvjpegStatus_t nvjpegGetImageInfo(nvjpegHandle_t, const unsigned char*, size_t, int*, nvjpegChromaSubsampling_t*, int*, int*) { return NVJPEG_STATUS_ERR; }
nvjpegStatus_t nvjpegDecode(nvjpegHandle_t, nvjpegJpegState_t, const unsigned char*, size_t, nvjpegOutputFormat_t, nvjpegImage_t*, cudaStream_t) { return NVJPEG_STATUS_ERR; }
nvjpegStatus_t nvjpegGetProperty(libraryPropertyType, int*) { return NVJPEG_STATUS_ERR; }
cudaError_t cudaMalloc(void**, size_t) { return cudaSuccess; }
cudaError_t cudaFree(void*) { return cudaSuccess; }
cudaError_t cudaMemcpyAsync(void*, const void*, size_t, cudaMemcpyKind, cudaStream_t) { return cudaSuccess; }
cudaError_t cudaStreamSynchronize(cudaStream_t) { return cudaSuccess; }
cudaError_t cudaStreamCreateWithFlags(cudaStream_t*, unsigned int) { return cudaSuccess; }

int main(int argc, char** argv) {
  static const YccTables ycc;
  int bad_total = 0;
  for (int a = 1; a < argc; ++a) {
    std::vector<uint8_t> data; read_file(argv[a], &data);
    // reference RGB
    jpeg_decompress_struct ci; jpeg_error_mgr em; ci.err = jpeg_std_error(&em);
    jpeg_create_decompress(&ci); jpeg_mem_src(&ci, data.data(), data.size());
    jpeg_read_header(&ci, TRUE); ci.out_color_space = JCS_RGB; jpeg_start_decompress(&ci);
    int w = ci.output_width, h = ci.output_height;
    std::vector<uint8_t> rgb(size_t(w) * h * 3);
    while (ci.output_scanline < ci.output_height) { JSAMPROW r = rgb.data() + size_t(ci.output_scanline) * w * 3; jpeg_read_scanlines(&ci, &r, 1); }
    jpeg_finish_decompress(&ci); jpeg_destroy_decompress(&ci);
    // raw planes
    jpeg_create_decompress(&ci); jpeg_mem_src(&ci, data.data(), data.size());
    jpeg_read_header(&ci, TRUE); ci.raw_data_out = TRUE; ci.out_color_space = JCS_YCbCr;
    jpeg_start_decompress(&ci);
    int nc = ci.num_components, maxv = ci.max_v_samp_factor, maxh = ci.max_h_samp_factor;
    if (nc != 3) { printf("%s: %d components, skipped\n", argv[a], nc); jpeg_abort_decompress(&ci); jpeg_destroy_decompress(&ci); continue; }
    std::vector<std::vector<uint8_t>> planes(nc); std::vector<int> pitch(nc), rows(nc);
    for (int c = 0; c < nc; ++c) { auto* cp = &ci.comp_info[c]; pitch[c] = ci.MCUs_per_row * cp->h_samp_factor * DCTSIZE; rows[c] = (ci.total_iMCU_rows + 1) * cp->v_samp_factor * DCTSIZE; planes[c].resize(size_t(pitch[c]) * rows[c]); }
    int done = 0;
    while (ci.output_scanline < ci.output_height) {
      std::vector<std::vector<JSAMPROW>> rp(nc); JSAMPARRAY arr[4];
      for (int c = 0; c < nc; ++c) { int n = ci.comp_info[c].v_samp_factor * DCTSIZE; int r0 = done / maxv * ci.comp_info[c].v_samp_factor; rp[c].resize(n); for (int i = 0; i < n; ++i) rp[c][i] = planes[c].data() + size_t(std::min(r0 + i, rows[c]-1)) * pitch[c]; arr[c] = rp[c].data(); }
      int got = jpeg_read_raw_data(&ci, arr, maxv * DCTSIZE); done += got;
    }
    int hs = maxh / ci.comp_info[1].h_samp_factor, vs = maxv / ci.comp_info[1].v_samp_factor;
    int cw = (w + hs - 1) / hs, ch = (h + vs - 1) / vs;
    jpeg_finish_decompress(&ci); jpeg_destroy_decompress(&ci);
    std::vector<uint8_t> cb, cr;
    fancy_upsample(planes[1].data(), pitch[1], ch, cw, hs, vs, h, w, &cb);
    fancy_upsample(planes[2].data(), pitch[2], ch, cw, hs, vs, h, w, &cr);
    int bad = 0, maxd = 0;
    for (int y = 0; y < h; ++y) for (int x = 0; x < w; ++x) {
      size_t i = size_t(y) * w + x; int Y = planes[0][size_t(y) * pitch[0] + x], b = cb[i], r = cr[i];
      uint8_t o[3] = {clamp255(Y + ycc.cr_r[r]), clamp255(Y + int((ycc.cb_g[b] + ycc.cr_g[r]) >> 16)), clamp255(Y + ycc.cb_b[b])};
      for (int k = 0; k < 3; ++k) { int d = std::abs(int(o[k]) - rgb[3*i+k]); if (d) { ++bad; maxd = std::max(maxd, d);} }
    }
    printf("%s %dx%d hs=%d vs=%d differ=%d max=%d\n", argv[a], h, w, hs, vs, bad, maxd);
    bad_total += bad;
  }
  return bad_total != 0;
}
