// Native host loader of the port (counterpart of the JAX package's
// cpp/dataloader.cpp): decodes KITTI PNGs straight into the caller's
// padded [N, H, W, 3] uint8 batch buffer, a batch spread over a pool of
// threads, and bulk-reads velodyne .bin files.  Bound with ctypes by
// snvc_tpu_torch/data/native_loader.py, built with the host compiler at
// first use (snvc_tpu_torch/_build.py:build_host) and linked with zlib
// only: the card's machine has no libpng.
//
// It reads what snvc_tpu_torch/data/png.py reads, with the same checks:
// 8-bit RGB or RGBA (alpha dropped), not interlaced, every chunk's CRC
// checked, the image data inflated (zlib) to exactly H * (1 + row bytes)
// and its rows unfiltered with the five filter types of the PNG
// specification (section 9).  png.py keeps its own chunk parser and
// Python zlib inflate as the plain version and shares the row filter
// here (snvc_png_unfilter).  An image is written into the top-left corner
// of its slot and cropped where larger; the rest of the slot is zeroed.
//
// C ABI:
//   int  snvc_png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
//                          int64_t stride, int bpp);
//   int  snvc_decode_png_rgb(const char* path, uint8_t* out, int oh, int ow);
//   int  snvc_decode_batch(const char** paths, int n, uint8_t* out, int oh,
//                          int ow, int n_threads, int* rcs);
//   long snvc_load_velodyne(const char* path, float* out, long max_floats);
// Return codes of the decoders: kOk or one of the Status values below.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

extern "C" int snvc_png_unfilter(const uint8_t* in, uint8_t* out,
                                 int64_t height, int64_t stride, int bpp);

namespace {

enum Status {
  kOk = 0,
  kNoFile = 1,       // the file does not open
  kNotPng = 2,       // no PNG signature
  kBadChunk = 3,     // a chunk's length or CRC is wrong, or no IEND
  kFormat = 4,       // not 8-bit RGB / RGBA, or interlaced / non-standard
  kBadData = 5,      // the image data does not inflate to the image size
  kBadFilter = 6,    // a row's filter type is not 0-4
  kNoImage = 7,      // no IHDR or no IDAT chunk
  kReadError = 8,    // the file does not read to its end
  kNoMemory = 9,     // the image's buffers could not be allocated
};

// libpng's default limit on each side (png_set_user_limits)
const uint32_t kMaxSide = 1000000;
// deflate's largest ratio of output to input bytes is 1032:1 (RFC 1951's
// longest match, 258 bytes, in at most two bits): image data that would
// inflate to more is refused before any buffer is sized to it
const uint64_t kMaxInflateRatio = 1032;

const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return kNoFile;
  int rc = kOk;
  if (std::fseek(fp, 0, SEEK_END) != 0) rc = kReadError;
  const long size = rc == kOk ? std::ftell(fp) : -1;
  if (size < 0 || std::fseek(fp, 0, SEEK_SET) != 0) rc = kReadError;
  if (rc == kOk) {
    data->resize(size_t(size));
    if (std::fread(data->data(), 1, data->size(), fp) != data->size())
      rc = kReadError;
  }
  std::fclose(fp);
  return rc;
}

struct Png {
  uint32_t w = 0, h = 0;
  int bpp = 0;
  std::vector<std::pair<const uint8_t*, uint32_t>> idat;  // payloads
};

// Walks the chunks as png.py's _chunks does: each chunk's CRC checked,
// stopping at IEND, which must come.
int parse(const std::vector<uint8_t>& data, Png* png) {
  if (data.size() < 8 || std::memcmp(data.data(), kSignature, 8) != 0)
    return kNotPng;
  bool ihdr = false, iend = false;
  size_t pos = 8;
  while (pos + 12 <= data.size()) {
    const uint32_t n = be32(&data[pos]);
    const uint8_t* kind = &data[pos + 4];
    if (n > data.size() - pos - 12) return kBadChunk;
    const uint8_t* body = kind + 4;
    uLong crc = crc32(0L, kind, 4);
    crc = crc32(crc, body, n);
    if (crc != be32(body + n)) return kBadChunk;
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (n != 13) return kBadChunk;
      png->w = be32(body);
      png->h = be32(body + 4);
      if (png->w == 0 || png->h == 0 || png->w > kMaxSide ||
          png->h > kMaxSide)
        return kFormat;
      const int depth = body[8], color = body[9];
      if (depth != 8 || (color != 2 && color != 6)) return kFormat;
      if (body[10] != 0 || body[11] != 0 || body[12] != 0) return kFormat;
      png->bpp = color == 2 ? 3 : 4;
      ihdr = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      png->idat.emplace_back(body, n);
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      iend = true;
      break;
    }
    pos += 12 + size_t(n);
  }
  if (!iend) return kBadChunk;
  if (!ihdr || png->idat.empty()) return kNoImage;
  uint64_t idat_bytes = 0;
  for (const auto& part : png->idat) idat_bytes += part.second;
  // h * (1 + w * bpp) <= 1e6 * (1 + 4e6): no overflow in 64 bits
  const uint64_t raw = uint64_t(png->h) * (1 + uint64_t(png->w) * png->bpp);
  if (raw > idat_bytes * kMaxInflateRatio + 64) return kBadData;
  return kOk;
}

// Inflates the IDAT payloads, in order, as one zlib stream, which must
// end and give exactly raw->size() bytes (bytes after its end are
// ignored, as zlib.decompress ignores them).  Once raw is full, output
// goes to a one-byte sink: a byte there means the stream holds more than
// the image.
int inflate_idat(const Png& png, std::vector<uint8_t>* raw) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kBadData;
  zs.next_out = raw->data();
  zs.avail_out = uInt(raw->size());
  uint8_t sink;
  bool in_sink = false, too_long = false;
  int ret = Z_OK;
  for (const auto& part : png.idat) {
    zs.next_in = const_cast<Bytef*>(part.first);
    zs.avail_in = part.second;
    for (;;) {
      if (zs.avail_out == 0) {
        if (in_sink) {
          too_long = true;
          break;
        }
        zs.next_out = &sink;
        zs.avail_out = 1;
        in_sink = true;
      }
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK) break;  // the end, an error, or input wanted
      if (zs.avail_in == 0 && zs.avail_out > 0) break;
    }
    if (too_long || (ret != Z_OK && ret != Z_BUF_ERROR)) break;
  }
  const bool whole = !too_long && ret == Z_STREAM_END &&
                     zs.total_out == raw->size();
  inflateEnd(&zs);
  return whole ? kOk : kBadData;
}

// Decodes one PNG into the zeroed out[oh, ow, 3]: the image in the
// top-left corner, cropped where larger.  out is written only once the
// image has decoded.  May throw std::bad_alloc.
int decode_png_rgb(const char* path, uint8_t* out, int oh, int ow) {
  const size_t row_out = size_t(ow) * 3;
  std::vector<uint8_t> data;
  int rc = read_file(path, &data);
  if (rc != kOk) return rc;
  Png png;
  rc = parse(data, &png);
  if (rc != kOk) return rc;
  const size_t stride = size_t(png.w) * png.bpp;
  std::vector<uint8_t> raw(size_t(png.h) * (stride + 1));
  rc = inflate_idat(png, &raw);
  if (rc != kOk) return rc;
  std::vector<uint8_t> img(size_t(png.h) * stride);
  if (snvc_png_unfilter(raw.data(), img.data(), png.h, stride, png.bpp))
    return kBadFilter;
  const size_t copy_h = std::min<size_t>(png.h, size_t(oh));
  const size_t copy_w = std::min<size_t>(png.w, size_t(ow));
  for (size_t y = 0; y < copy_h; ++y) {
    const uint8_t* src = img.data() + y * stride;
    uint8_t* dst = out + y * row_out;
    if (png.bpp == 3) {
      std::memcpy(dst, src, copy_w * 3);
    } else {
      for (size_t x = 0; x < copy_w; ++x) {
        dst[3 * x] = src[4 * x];
        dst[3 * x + 1] = src[4 * x + 1];
        dst[3 * x + 2] = src[4 * x + 2];
      }
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// in:  height rows of (1 filter byte + stride bytes)
// out: height rows of stride bytes
// Returns 0, or 1 + the index of the first row whose filter byte is not
// one of 0-4.  Sub, Average and Paeth depend on the reconstructed left
// neighbour, so a row is a sequential loop.
int snvc_png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
                      int64_t stride, int bpp) {
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t ft = in[r * (stride + 1)];
    const uint8_t* x = in + r * (stride + 1) + 1;
    uint8_t* d = out + r * stride;
    const uint8_t* up = r > 0 ? d - stride : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(d, x, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          d[i] = uint8_t(x[i] + (i >= bpp ? d[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          d[i] = uint8_t(x[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? d[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          d[i] = uint8_t(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? d[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          d[i] = uint8_t(x[i] + pred);
        }
        break;
      default:
        return int(r + 1);
    }
  }
  return 0;
}

// Decodes one PNG into out[oh, ow, 3]: the image in the top-left corner,
// cropped where larger, zeros elsewhere.  On an error out is left zeroed;
// a buffer that cannot be allocated returns kNoMemory (no exception
// leaves the C interface or a worker thread).
int snvc_decode_png_rgb(const char* path, uint8_t* out, int oh, int ow) {
  std::memset(out, 0, size_t(oh) * size_t(ow) * 3);
  try {
    return decode_png_rgb(path, out, oh, ow);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

// Decodes paths[i] into slot i of out[n, oh, ow, 3] on n_threads threads,
// each taking the next image not yet taken; a null path leaves its slot
// as the caller made it.  rcs[i] receives image i's return code; returns
// the first non-zero one, or 0.
int snvc_decode_batch(const char** paths, int n, uint8_t* out, int oh, int ow,
                      int n_threads, int* rcs) {
  const size_t slot = size_t(oh) * ow * 3;
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next++; i < n; i = next++)
      rcs[i] = paths[i] ? snvc_decode_png_rgb(paths[i], out + slot * i, oh, ow)
                        : kOk;
  };
  const int extra = std::min(std::max(n_threads, 1), std::max(n, 1)) - 1;
  std::vector<std::thread> workers;
  for (int t = 0; t < extra; ++t) workers.emplace_back(work);
  work();
  for (auto& w : workers) w.join();
  for (int i = 0; i < n; ++i)
    if (rcs[i]) return rcs[i];
  return kOk;
}

// Reads up to max_floats float32 values of a velodyne .bin; returns the
// count read, or -1 if the file does not open.
long snvc_load_velodyne(const char* path, float* out, long max_floats) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  const long got = long(std::fread(out, sizeof(float), size_t(max_floats), fp));
  std::fclose(fp);
  return got;
}

}  // extern "C"
