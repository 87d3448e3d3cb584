// JPEG decode for the LOST driver's uint8 feed (the port's own copy of the
// two entry points of csrc/decode.cc that the LOST path uses).
//
// API (ctypes, see vipers_torch/data/native.py):
//   int vipers_jpeg_dims(data, len, &w, &h)
//   int vipers_decode_pad(data, len, out, out_h, out_w, &w, &h)
//       -- full-resolution RGB decode straight into a zero-padded
//          (out_h, out_w, 3) row-major uint8 buffer
// Each returns 0 on success and nonzero on a decode error. The calls hold
// no Python state, so ctypes releases the GIL around them and a thread pool
// decodes on every core.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

}  // namespace

extern "C" {

int vipers_jpeg_dims(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Scanlines land directly in the destination (row stride out_w * 3), the
// right and bottom pad are zeroed: no intermediate buffer and no float
// math. Writes the decoded dims to (*w, *h); fails (2) if the image exceeds
// the destination extent.
int vipers_decode_pad(const uint8_t* data, size_t len, uint8_t* out,
                      int out_h, int out_w, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int iw = cinfo.output_width, ih = cinfo.output_height;
  if (iw > out_w || ih > out_h) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *w = iw;
  *h = ih;
  const size_t dst_stride = static_cast<size_t>(out_w) * 3;
  const size_t pad_right = dst_stride - static_cast<size_t>(iw) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * dst_stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
    if (pad_right) std::memset(row + static_cast<size_t>(iw) * 3, 0, pad_right);
  }
  if (ih < out_h)
    std::memset(out + static_cast<size_t>(ih) * dst_stride, 0,
                static_cast<size_t>(out_h - ih) * dst_stride);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
