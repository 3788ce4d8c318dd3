// Native data-loader hot path: threaded JPEG decode straight into the
// fixed uint8 batch canvases of dan_tpu_torch.data.pipeline's batch
// contract (the port's copy of dan_tpu/native/loader.cc).
//
// The host side of training is file I/O + JPEG decode only, and that decode
// runs here, GIL-free, with a std::thread worker pool writing each image
// directly into its slot of the (B, C, C, 3) canvas array: no per-image
// Python objects, no collation copy.
//
// Links a libjpeg-turbo of the 6.2 ABI: the one PIL's wheel ships, or the
// system's (see native/__init__.py), compiled against the headers in
// native/include/.  jpeg_crop_scanline / jpeg_skip_scanlines are exported by
// every libjpeg-turbo even though the 6.2 header does not declare them
// (declared below), so a window decode reads only the rows and iMCU columns
// it needs.  Any per-image failure is reported via a status code; the Python
// caller falls back to its cv2 path for that image only.
//
// One change from the reference: the column crop asks libjpeg for one more
// column on each side of the window than it copies out.  Fancy chroma
// upsampling treats the cropped region's edges as the image's, so a column
// on an iMCU boundary of the crop was not what a whole-image decode (cv2's)
// gives; one column of context on each side makes every copied pixel equal
// to the whole-image decode.

#include <csetjmp>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>

// libjpeg-turbo extensions (present in the shared object; the stock 6.2
// jpeglib.h shipped here omits them).
extern "C" {
JDIMENSION jpeg_skip_scanlines(j_decompress_ptr cinfo, JDIMENSION num_lines);
void jpeg_crop_scanline(j_decompress_ptr cinfo, JDIMENSION* xoffset,
                        JDIMENSION* width);
}

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void emit_nothing(j_common_ptr, int) {}

// Status codes (decode_batch_into's status array in native/__init__.py).
enum {
  kOk = 0,
  kBadHeader = 1,
  kDecodeError = 2,
  kUnsupported = 3,
  kBadWindow = 4,
};

struct Decoder {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;

  Decoder() {
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.emit_message = emit_nothing;  // no stderr spam from bad files
    jpeg_create_decompress(&cinfo);
  }
  ~Decoder() { jpeg_destroy_decompress(&cinfo); }
};

}  // namespace

extern "C" {

// Header-only dimension probe. Returns kOk and fills (*w, *h) on success.
int dan_jpeg_dims(const unsigned char* buf, long long nbytes, int* w,
                  int* h) {
  Decoder d;
  if (setjmp(d.jerr.setjmp_buffer)) return kBadHeader;
  jpeg_mem_src(&d.cinfo, buf, static_cast<unsigned long>(nbytes));
  if (jpeg_read_header(&d.cinfo, TRUE) != JPEG_HEADER_OK) return kBadHeader;
  *w = static_cast<int>(d.cinfo.image_width);
  *h = static_cast<int>(d.cinfo.image_height);
  return kOk;
}

// Decode the window [off_x, off_x+win_w) x [off_y, off_y+win_h) of the
// image as RGB8 into dst rows of stride dst_stride bytes. The window must
// lie inside the image. Grayscale/YCbCr convert to RGB in-library; exotic
// color spaces (CMYK) return kUnsupported for the caller's fallback.
int dan_jpeg_decode_window(const unsigned char* buf, long long nbytes,
                           int off_x, int off_y, int win_w, int win_h,
                           unsigned char* dst, long long dst_stride) {
  Decoder d;
  // The row buffer is raw malloc'd storage freed on BOTH exits: a longjmp
  // from error_exit would skip the destructor of any C++ object
  // constructed after setjmp (heap leak per corrupt image, and formally
  // UB), so no such object may own memory here. volatile: the pointer is
  // written between setjmp and longjmp.
  unsigned char* volatile rowmem = nullptr;
  if (setjmp(d.jerr.setjmp_buffer)) {
    std::free(rowmem);
    return kDecodeError;
  }
  jpeg_mem_src(&d.cinfo, buf, static_cast<unsigned long>(nbytes));
  if (jpeg_read_header(&d.cinfo, TRUE) != JPEG_HEADER_OK) return kBadHeader;
  const int W = static_cast<int>(d.cinfo.image_width);
  const int H = static_cast<int>(d.cinfo.image_height);
  if (off_x < 0 || off_y < 0 || win_w <= 0 || win_h <= 0 ||
      off_x + win_w > W || off_y + win_h > H)
    return kBadWindow;
  if (d.cinfo.jpeg_color_space == JCS_CMYK ||
      d.cinfo.jpeg_color_space == JCS_YCCK)
    return kUnsupported;
  d.cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&d.cinfo);

  // Column crop to iMCU boundaries: the library may widen the region left
  // of the request; copy from the in-row offset afterwards.  The request
  // has one column of context on each side (inside the image), so that no
  // copied column is an edge of the cropped region for the upsampler.
  const int req_x = off_x > 0 ? off_x - 1 : 0;
  const int req_end = off_x + win_w < W ? off_x + win_w + 1 : W;
  JDIMENSION cx = static_cast<JDIMENSION>(req_x);
  JDIMENSION cw = static_cast<JDIMENSION>(req_end - req_x);
  jpeg_crop_scanline(&d.cinfo, &cx, &cw);
  const int row_off = (off_x - static_cast<int>(cx)) * 3;
  rowmem = static_cast<unsigned char*>(
      std::malloc(static_cast<size_t>(cw) * 3));
  if (rowmem == nullptr) return kDecodeError;
  unsigned char* rowbuf = rowmem;

  if (off_y > 0)
    jpeg_skip_scanlines(&d.cinfo, static_cast<JDIMENSION>(off_y));
  for (int y = 0; y < win_h; ++y) {
    if (jpeg_read_scanlines(&d.cinfo, &rowbuf, 1) != 1) {
      jpeg_abort_decompress(&d.cinfo);
      std::free(rowmem);
      return kDecodeError;
    }
    std::memcpy(dst + static_cast<long long>(y) * dst_stride,
                rowbuf + row_off, static_cast<size_t>(win_w) * 3);
  }
  // Skip the tail instead of jpeg_finish_decompress (which requires all
  // scanlines consumed); abort tears the decode state down cleanly.
  jpeg_abort_decompress(&d.cinfo);
  std::free(rowmem);
  return kOk;
}

// Threaded batch decode into one (n, canvas, canvas, 3) uint8 array.
//
// For image i: decode the source window [src_x, src_x+win_w) x
// [src_y, src_y+win_h) and place it at (dst_x[i], dst_y[i]) in slot i;
// every canvas byte outside the placed rectangle is zeroed (and only
// those — the decoded region is written exactly once). A non-positive
// window just zeroes the slot. status[i] receives a per-image code (kOk
// or an error for the caller's Python fallback).
//
// The caller computes windows from the JPEG header dims (dan_jpeg_dims),
// which lets the training pipeline decode ONLY the data-anchor crop
// window it sampled from box metadata — the crop sampler needs no pixels
// — instead of the full image (SURVEY.md §3.1: host does I/O + decode
// only; this makes the decode itself proportional to what the device
// will actually read).
void dan_decode_batch(const unsigned char* const* bufs,
                      const long long* sizes, int n, const int* src_x,
                      const int* src_y, const int* dst_x, const int* dst_y,
                      const int* win_w, const int* win_h, int canvas,
                      unsigned char* out, int nthreads, int* status) {
  const long long row = static_cast<long long>(canvas) * 3;
  const long long slot = row * canvas;
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      unsigned char* dst = out + i * slot;
      const int w = win_w[i], h = win_h[i], dx = dst_x[i], dy = dst_y[i];
      if (w <= 0 || h <= 0 || dx < 0 || dy < 0 || dx + w > canvas ||
          dy + h > canvas) {
        std::memset(dst, 0, static_cast<size_t>(slot));
        status[i] = (w <= 0 || h <= 0) ? kOk : kBadWindow;
        continue;
      }
      // Zero only the padding: rows above/below the rectangle fully,
      // and the left/right margins of the covered rows.
      std::memset(dst, 0, static_cast<size_t>(dy) * row);
      std::memset(dst + (dy + h) * row, 0,
                  static_cast<size_t>(canvas - dy - h) * row);
      for (int y = dy; y < dy + h; ++y) {
        std::memset(dst + y * row, 0, static_cast<size_t>(dx) * 3);
        std::memset(dst + y * row + (dx + w) * 3, 0,
                    static_cast<size_t>(canvas - dx - w) * 3);
      }
      int rc = dan_jpeg_decode_window(bufs[i], sizes[i], src_x[i], src_y[i],
                                      w, h, dst + dy * row + dx * 3, row);
      if (rc != kOk)  // leave a clean slot for the Python fallback
        std::memset(dst, 0, static_cast<size_t>(slot));
      status[i] = rc;
    }
  };
  if (n <= 0) return;  // reserve(t-1) below would wrap to SIZE_MAX
  int t = nthreads < 1 ? 1 : nthreads;
  if (t > n) t = n;
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  for (int k = 1; k < t; ++k) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

}  // extern "C"
