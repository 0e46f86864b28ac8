// Native batched JPEG clip decoder for the TPU video-similarity framework.
//
// The host data path — decode T JPEG frames, resize to the fixed square
// buffer that feeds the on-device augmentation kernel — is the framework's
// per-step host bottleneck (the reference delegates it to PIL inside torch
// DataLoader workers, datasets/loader.py:10-21 + spatial_transforms).
// This module does the whole clip in one GIL-free C call:
//
//   * libjpeg DCT-scaled decode (scale_denom in {1,2,4,8}) so a 320x240
//     source headed for a 64px buffer is decoded at 1/4 resolution;
//   * bilinear resize to (out, out), or short-edge resize + center crop
//     in eval mode (reference Resize+CenterCrop, datasets/data_loader.py:
//     107-115);
//   * a std::thread pool over frames (atomic work counter).
//
// C ABI (ctypes-friendly, see ../data/native_loader.py):
//   int vss_decode_frames(const char** paths, int n_frames, int out_size,
//                         int eval_mode, unsigned char* out, int n_threads)
// 'out' is (n_frames, out_size, out_size, 3) uint8, caller-allocated.
// Returns 0 on success, -(i+1) if frame i failed to decode.

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear sampling of the window {y = oy + row*sy, x = ox + col*sx} of an
// RGB (h, w) image into an (out, out) dst.
//
// Separable fixed-point implementation: the horizontal pass is computed
// once per SOURCE row into a 2-slot cache (output rows re-blend cached
// rows vertically), and all interpolation weights are precomputed 8-bit
// fixed point — ~4x over the naive per-pixel float version, which was the
// measured gap to cv2's SIMD resize on the PIL fallback path.
void resize_window(const uint8_t* src, int h, int w, float sy, float sx,
                   float oy, float ox, int out, uint8_t* dst) {
  // precomputed horizontal taps for the output columns
  std::vector<int> xi0(out), xi1(out);
  std::vector<uint16_t> xw(out);  // weight of x1 in 0..256
  for (int x = 0; x < out; ++x) {
    float fx = ox + x * sx;
    if (fx < 0.f) fx = 0.f;
    // defensive upper clamp: callers guarantee the window stays inside
    // the frame, but the float box->frame rescale + DCT ceil-rounding
    // make that invariant delicate — if fx ever exceeded w, fx - x0
    // would pass 1 and iwx = 256 - xw would underflow uint16 into
    // garbage edge pixels
    if (fx > static_cast<float>(w - 1)) fx = static_cast<float>(w - 1);
    int x0 = static_cast<int>(fx);
    if (x0 > w - 1) x0 = w - 1;
    xi0[x] = x0 * 3;
    xi1[x] = (x0 + 1 < w ? x0 + 1 : w - 1) * 3;
    xw[x] = static_cast<uint16_t>((fx - x0) * 256.f + 0.5f);
  }

  // 2-slot cache of horizontally resized source rows (u16, x256 scale)
  std::vector<uint16_t> rowbuf(2 * static_cast<size_t>(out) * 3);
  int cached[2] = {-1, -1};
  auto hrow = [&](int ysrc, int slot) -> const uint16_t* {
    uint16_t* r = rowbuf.data() + static_cast<size_t>(slot) * out * 3;
    if (cached[slot] == ysrc) return r;
    const uint8_t* s = src + static_cast<size_t>(ysrc) * w * 3;
    for (int x = 0; x < out; ++x) {
      const uint16_t wx = xw[x];
      const uint16_t iwx = 256 - wx;
      const uint8_t* p0 = s + xi0[x];
      const uint8_t* p1 = s + xi1[x];
      r[x * 3 + 0] = static_cast<uint16_t>(p0[0] * iwx + p1[0] * wx);
      r[x * 3 + 1] = static_cast<uint16_t>(p0[1] * iwx + p1[1] * wx);
      r[x * 3 + 2] = static_cast<uint16_t>(p0[2] * iwx + p1[2] * wx);
    }
    cached[slot] = ysrc;
    return r;
  };

  const int n = out * 3;
  for (int y = 0; y < out; ++y) {
    float fy = oy + y * sy;
    if (fy < 0.f) fy = 0.f;
    if (fy > static_cast<float>(h - 1)) fy = static_cast<float>(h - 1);
    int y0 = static_cast<int>(fy);
    if (y0 > h - 1) y0 = h - 1;
    const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const uint32_t wy = static_cast<uint32_t>((fy - y0) * 256.f + 0.5f);
    const uint32_t iwy = 256 - wy;
    // keep slot assignment monotone so successive rows reuse the cache
    const uint16_t* r0 = hrow(y0, y0 & 1);
    const uint16_t* r1 = y1 == y0 ? r0 : hrow(y1, y1 & 1);
    uint8_t* d = dst + static_cast<size_t>(y) * n;
    if (wy == 0) {
      for (int i = 0; i < n; ++i)
        d[i] = static_cast<uint8_t>((r0[i] + 128u) >> 8);
    } else {
      for (int i = 0; i < n; ++i)
        d[i] = static_cast<uint8_t>(
            (r0[i] * iwy + r1[i] * wy + 32768u) >> 16);
    }
  }
}

// Decode one JPEG into RGB pixels, DCT-downscaling so that the source
// extent that will be resampled to `out_size` stays >= out_size, and —
// when a sampling window is known up front — decoding ONLY the region
// the resampler will touch (round-5): columns are restricted with
// jpeg_crop_scanline (iMCU-aligned), rows above the window are skipped
// with jpeg_skip_scanlines (their IDCT/color conversion never runs) and
// decoding aborts after the window's last row. For a typical
// RandomResizedCrop window this saves most of the post-entropy work of
// the frame; numerics of the decoded region are identical to a full
// decode (block IDCT is independent; crop/skip keep upsampling context).
//
// (crop_top, crop_left, crop_h, crop_w) is the window in (box_h, box_w)-
// frame coordinates (crop_h <= 0: no window). eval_center: no explicit
// window, but the caller will short-edge-resize + center-crop to
// out_size^2, so the needed region is computed from that protocol.
// On success fills pixels (region of (*h rows, *w cols) whose origin in
// full DCT-scaled output coordinates is (*y_off, *x_off)), the DCT
// scale factor applied (output = original / *denom), the full scaled
// dims (*full_h, *full_w), and the per-axis box->frame rescale factors
// ry/rx (frames stored at a different resolution than the frame the box
// was sampled from get the SAME relative window).
bool decode_pixels(const char* path, float crop_top, float crop_left,
                   float crop_h, float crop_w, float box_h, float box_w,
                   int out_size, int eval_center,
                   std::vector<uint8_t>& pixels, int* h, int* w,
                   int* y_off, int* x_off, int* full_h, int* full_w,
                   int* denom_out, float* ry_out, float* rx_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  const float ry = box_h > 0.f ? cinfo.image_height / box_h : 1.f;
  const float rx = box_w > 0.f ? cinfo.image_width / box_w : 1.f;
  float base;
  if (crop_h > 0.f) {
    const float eh = crop_h * ry;
    const float ew = crop_w * rx;
    base = eh < ew ? eh : ew;
  } else {
    base = static_cast<float>(cinfo.image_height < cinfo.image_width
                                  ? cinfo.image_height
                                  : cinfo.image_width);
  }
  if (ry_out) *ry_out = ry;
  if (rx_out) *rx_out = rx;
  int denom = 1;
  while (denom < 8 && base / (denom * 2) >= out_size) denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;

  jpeg_start_decompress(&cinfo);
  const int oh = cinfo.output_height;
  const int ow = cinfo.output_width;
  *full_h = oh;
  *full_w = ow;
  *denom_out = denom;

  // The sampling window in DCT-scaled output coordinates: [wy0f, wy1f] x
  // [wx0f, wx1f] are the float extremes the bilinear resampler reads
  // (its x1/y1 neighbors add +1; margin +2 absorbs the float box->frame
  // rescale and DCT ceil-rounding slack).
  float wy0f = 0.f, wx0f = 0.f;
  float wy1f = static_cast<float>(oh - 1), wx1f = static_cast<float>(ow - 1);
  bool windowed = false;
  const float inv = 1.0f / denom;
  if (crop_h > 0.f) {
    const float ch = crop_h * ry * inv;
    const float cw = crop_w * rx * inv;
    wy0f = crop_top * ry * inv;
    wx0f = crop_left * rx * inv;
    wy1f = wy0f + (ch > 1.f ? ch - 1.f : 0.f);
    wx1f = wx0f + (cw > 1.f ? cw - 1.f : 0.f);
    windowed = true;
  } else if (eval_center) {
    // mirror decode_one's eval protocol: short-edge resize to out_size,
    // center crop out_size^2 — sampled rows are top*sy .. (top+out-1)*sy
    const int mn = oh < ow ? oh : ow;
    const float s = static_cast<float>(out_size) / mn;
    const int rh = static_cast<int>(std::lround(oh * s));
    const int rw = static_cast<int>(std::lround(ow * s));
    const float sy = rh > 1 ? static_cast<float>(oh - 1) / (rh - 1) : 0.f;
    const float sx = rw > 1 ? static_cast<float>(ow - 1) / (rw - 1) : 0.f;
    const int top = (rh - out_size) / 2 > 0 ? (rh - out_size) / 2 : 0;
    const int left = (rw - out_size) / 2 > 0 ? (rw - out_size) / 2 : 0;
    wy0f = top * sy;
    wx0f = left * sx;
    wy1f = wy0f + (out_size - 1) * sy;
    wx1f = wx0f + (out_size - 1) * sx;
    windowed = true;
  }

  int y0 = 0, y1 = oh, x0 = 0, x1 = ow;
  if (windowed) {
    y0 = static_cast<int>(wy0f) - 2;
    x0 = static_cast<int>(wx0f) - 2;
    y1 = static_cast<int>(wy1f) + 4;  // +1 bilinear neighbor, +margin
    x1 = static_cast<int>(wx1f) + 4;
    if (y0 < 0) y0 = 0;
    if (x0 < 0) x0 = 0;
    if (y1 > oh) y1 = oh;
    if (x1 > ow) x1 = ow;
    // Only pay the crop/skip machinery when it saves real work: a
    // near-full window (e.g. eval center-crop of a landscape frame, or
    // an RRC crop that DCT scaling already shrank to most of the scaled
    // frame) measured ~2-3% SLOWER through jpeg_crop_scanline than a
    // straight full decode (decode_bench_r5.py round-5 A/B).
    const double frac = static_cast<double>(y1 - y0) * (x1 - x0) /
                        (static_cast<double>(oh) * ow);
    if (frac > 0.75) {
      y0 = 0;
      x0 = 0;
      y1 = oh;
      x1 = ow;
      windowed = false;
    }
  }

  // column restriction (iMCU-aligned; the library widens the request)
  JDIMENSION cx = static_cast<JDIMENSION>(x0);
  JDIMENSION cw_req = static_cast<JDIMENSION>(x1 - x0);
  if (windowed && (x0 > 0 || x1 < ow)) {
    jpeg_crop_scanline(&cinfo, &cx, &cw_req);
    *x_off = static_cast<int>(cx);
    *w = static_cast<int>(cw_req);
  } else {
    *x_off = 0;
    *w = ow;
  }
  // skip rows above the window (entropy-decoded but no IDCT/color conv)
  if (y0 > 0) {
    jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(y0));
  }
  *y_off = static_cast<int>(cinfo.output_scanline);
  const int rows = y1 - *y_off;
  *h = rows > 0 ? rows : 0;
  pixels.resize(static_cast<size_t>(*h) * *w * 3);
  int r = 0;
  while (r < *h && cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + static_cast<size_t>(r) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
    ++r;
  }
  if (cinfo.output_scanline >= cinfo.output_height) {
    jpeg_finish_decompress(&cinfo);
  } else {
    jpeg_abort_decompress(&cinfo);  // rows below the window never decode
  }
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return r == *h && *h > 0;
}

// Decode one JPEG file into RGB; returns false on failure.
bool decode_one(const char* path, int out_size, int eval_mode,
                uint8_t* dst) {
  std::vector<uint8_t> pixels;
  int h, w, y_off, x_off, full_h, full_w, denom;
  if (!decode_pixels(path, -1.f, -1.f, -1.f, -1.f, -1.f, -1.f, out_size,
                     eval_mode, pixels, &h, &w, &y_off, &x_off, &full_h,
                     &full_w, &denom, nullptr, nullptr))
    return false;

  if (eval_mode) {
    // short-edge resize to out_size, center crop out_size^2 — window
    // computed against the FULL scaled dims, sampled from the decoded
    // region via the (y_off, x_off) origin shift
    const int mn = full_h < full_w ? full_h : full_w;
    const float s = static_cast<float>(out_size) / mn;
    const int oh = static_cast<int>(std::lround(full_h * s));
    const int ow = static_cast<int>(std::lround(full_w * s));
    const int top = (oh - out_size) / 2 > 0 ? (oh - out_size) / 2 : 0;
    const int left = (ow - out_size) / 2 > 0 ? (ow - out_size) / 2 : 0;
    const float sy = oh > 1 ? static_cast<float>(full_h - 1) / (oh - 1) : 0.f;
    const float sx = ow > 1 ? static_cast<float>(full_w - 1) / (ow - 1) : 0.f;
    resize_window(pixels.data(), h, w, sy, sx, top * sy - y_off,
                  left * sx - x_off, out_size, dst);
  } else {
    const float sy = out_size > 1
        ? static_cast<float>(full_h - 1) / (out_size - 1) : 0.f;
    const float sx = out_size > 1
        ? static_cast<float>(full_w - 1) / (out_size - 1) : 0.f;
    resize_window(pixels.data(), h, w, sy, sx, 0.f, 0.f, out_size, dst);
  }
  return true;
}

// RandomResizedCrop path: resample the (top, left, crop_h, crop_w) window
// (coordinates in the (box_h, box_w) frame the box was sampled from —
// rescaled per frame to each frame's own resolution) to out_size^2 —
// the reference's host-side RandomResizedCrop
// (datasets/spatial_transforms.py:171-225) fused into the decode.
bool decode_one_rrc(const char* path, float top, float left, float crop_h,
                    float crop_w, float box_h, float box_w, int out_size,
                    uint8_t* dst) {
  std::vector<uint8_t> pixels;
  int h, w, y_off, x_off, full_h, full_w, denom;
  float ry, rx;
  if (!decode_pixels(path, top, left, crop_h, crop_w, box_h, box_w,
                     out_size, 0, pixels, &h, &w, &y_off, &x_off, &full_h,
                     &full_w, &denom, &ry, &rx))
    return false;
  const float inv = 1.0f / denom;  // crop coords in the decoded scale
  const float ch = crop_h * ry * inv;
  const float cw = crop_w * rx * inv;
  const float sy = out_size > 1 ? (ch - 1.f) / (out_size - 1) : 0.f;
  const float sx = out_size > 1 ? (cw - 1.f) / (out_size - 1) : 0.f;
  // window origin shifted into the decoded region's coordinates
  resize_window(pixels.data(), h, w, sy, sx, top * ry * inv - y_off,
                left * rx * inv - x_off, out_size, dst);
  return true;
}

}  // namespace

extern "C" int vss_decode_frames(const char** paths, int n_frames,
                                 int out_size, int eval_mode,
                                 unsigned char* out, int n_threads) {
  if (n_frames <= 0) return 0;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 0 = ok, else -(index+1) of first failure
  const size_t frame_bytes =
      static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n_frames) return;
      if (!decode_one(paths[i], out_size, eval_mode,
                      out + frame_bytes * i)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, -(i + 1));
      }
    }
  };

  const int nt = n_threads > 0 ? n_threads : 1;
  if (nt == 1 || n_frames == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int spawn = nt < n_frames ? nt : n_frames;
    pool.reserve(spawn);
    for (int t = 0; t < spawn; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

// Clip-consistent RandomResizedCrop decode: every frame of the clip gets
// the SAME (top, left, crop_h, crop_w) window (original-pixel coords),
// resampled to out_size^2 — one GIL-free call per clip.
extern "C" int vss_decode_frames_rrc(const char** paths, int n_frames,
                                     float top, float left, float crop_h,
                                     float crop_w, float box_h,
                                     float box_w, int out_size,
                                     unsigned char* out, int n_threads) {
  if (n_frames <= 0) return 0;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const size_t frame_bytes = static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n_frames) return;
      if (!decode_one_rrc(paths[i], top, left, crop_h, crop_w, box_h,
                          box_w, out_size, out + frame_bytes * i)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, -(i + 1));
      }
    }
  };

  const int nt = n_threads > 0 ? n_threads : 1;
  if (nt == 1 || n_frames == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int spawn = nt < n_frames ? nt : n_frames;
    pool.reserve(spawn);
    for (int t = 0; t < spawn; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

extern "C" int vss_loader_version() { return 4; }
