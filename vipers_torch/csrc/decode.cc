// JPEG decode for the LOST driver's uint8 feed and the train driver's
// --native-decode path (the port's own copy of csrc/decode.cc).
//
// API (ctypes, see vipers_torch/data/native.py):
//   int vipers_jpeg_dims(data, len, &w, &h)
//   int vipers_decode_pad(data, len, out, out_h, out_w, &w, &h)
//       -- full-resolution RGB decode straight into a zero-padded
//          (out_h, out_w, 3) row-major uint8 buffer
//   int vipers_decode_eval(data, len, resize, crop, out /*crop*crop*3*/)
//       -- shorter side resized (bilinear, the long side truncated), then
//          the center crop: the eval preset
//   int vipers_decode_rrc(data, len, cx, cy, cw, ch, out_size, flip,
//                         out /*out_size*out_size*3*/)
//       -- the box (sampled in Python) cropped, resized bilinearly to
//          out_size x out_size, flipped horizontally when flip is set:
//          RandomResizedCrop's pixels
// Each returns 0 on success and nonzero on a decode error. The calls hold
// no Python state, so ctypes releases the GIL around them and a thread pool
// decodes on every core.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Decode a JPEG into an RGB buffer. With min_short > 0, libjpeg's DCT
// scaling brings the shorter side to within 2x of min_short before the
// exact bilinear pass.
bool decode_rgb(const uint8_t* data, size_t len, int min_short,
                std::vector<uint8_t>* out, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (min_short > 0) {
    // the smallest scale_num/8 that keeps the shorter side >= min_short
    int short_side = cinfo.image_width < cinfo.image_height
                         ? cinfo.image_width
                         : cinfo.image_height;
    int num = 8;
    while (num > 1 && (short_side * (num - 1)) / 8 >= min_short) num--;
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize (half-pixel centers) from (h, w) RGB to (oh, ow) RGB.
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
                     int ow) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > h - 1) y0 = h - 1;
    int y1 = y0 + 1 > h - 1 ? h - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > w - 1) x0 = w - 1;
      int x1 = x0 + 1 > w - 1 ? w - 1 : x0 + 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(static_cast<size_t>(y0) * w + x0) * 3 + c];
        float v01 = src[(static_cast<size_t>(y0) * w + x1) * 3 + c];
        float v10 = src[(static_cast<size_t>(y1) * w + x0) * 3 + c];
        float v11 = src[(static_cast<size_t>(y1) * w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(static_cast<size_t>(y) * ow + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
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

int vipers_decode_eval(const uint8_t* data, size_t len, int resize, int crop,
                       uint8_t* out) {
  std::vector<uint8_t> img;
  int w = 0, h = 0;
  if (!decode_rgb(data, len, resize, &img, &w, &h)) return 1;
  // the long side truncates (int(size * long / short)); double matches
  // Python's float division before the truncation
  int ow, oh;
  if (w <= h) {
    ow = resize;
    oh = static_cast<int>(resize * static_cast<double>(h) / w);
  } else {
    oh = resize;
    ow = static_cast<int>(resize * static_cast<double>(w) / h);
  }
  std::vector<uint8_t> resized(static_cast<size_t>(ow) * oh * 3);
  resize_bilinear(img.data(), h, w, resized.data(), oh, ow);
  if (oh < crop || ow < crop) return 2;
  // the center crop's origin int(round(d / 2.0)), Python's round half to
  // even: for odd d, d/2 bumped up only when the floor is odd
  auto crop_origin = [](int d) {
    int k = d / 2;
    return (d % 2) ? k + (k & 1) : k;
  };
  int top = crop_origin(oh - crop);
  int left = crop_origin(ow - crop);
  for (int y = 0; y < crop; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * crop * 3,
                resized.data() + ((static_cast<size_t>(top) + y) * ow + left) * 3,
                static_cast<size_t>(crop) * 3);
  }
  return 0;
}

int vipers_decode_rrc(const uint8_t* data, size_t len, int cx, int cy, int cw,
                      int ch, int out_size, int flip, uint8_t* out) {
  std::vector<uint8_t> img;
  int w = 0, h = 0;
  if (!decode_rgb(data, len, 0, &img, &w, &h)) return 1;
  if (cx < 0 || cy < 0 || cx + cw > w || cy + ch > h || cw <= 0 || ch <= 0)
    return 2;
  std::vector<uint8_t> cropped(static_cast<size_t>(cw) * ch * 3);
  for (int y = 0; y < ch; ++y) {
    std::memcpy(cropped.data() + static_cast<size_t>(y) * cw * 3,
                img.data() + ((static_cast<size_t>(cy) + y) * w + cx) * 3,
                static_cast<size_t>(cw) * 3);
  }
  resize_bilinear(cropped.data(), ch, cw, out, out_size, out_size);
  if (flip) {
    for (int y = 0; y < out_size; ++y) {
      uint8_t* row = out + static_cast<size_t>(y) * out_size * 3;
      for (int x = 0; x < out_size / 2; ++x) {
        for (int c = 0; c < 3; ++c) {
          uint8_t t = row[x * 3 + c];
          row[x * 3 + c] = row[(out_size - 1 - x) * 3 + c];
          row[(out_size - 1 - x) * 3 + c] = t;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
