// Native host loader of the port (counterpart of the JAX package's
// cpp/dataloader.cpp): decodes KITTI PNGs straight into the caller's
// padded [N, H, W, 3] uint8 batch buffer, a batch spread over a pool of
// threads, and bulk-reads velodyne .bin files.  Bound with ctypes by
// snvc_tpu_torch/data/native_loader.py, built with the host compiler at
// first use (snvc_tpu_torch/_build.py:build_host) and linked with zlib
// only: the card's machine has no libpng.
//
// It decodes every PNG of the specification (section 11.2.2) into 8-bit
// RGB as cv2.imread(IMREAD_COLOR) + BGR->RGB does, which is what the JAX
// package's image paths read (snvc_tpu/data/kitti.py:89-146): colour
// types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) at
// the bit depths the specification allows them (1, 2, 4, 8, 16), with or
// without Adam7 interlacing.  Grey is replicated, 16-bit samples keep
// their high byte (libpng's png_set_strip_16), grey below 8 bits is
// scaled to 0-255, palette indices are looked up in PLTE (an index past
// its entries is black, as libpng pads the palette), and alpha and tRNS
// are dropped.  Every chunk's CRC is checked, the image data is inflated
// (zlib) to exactly the bytes of its scanlines (of each interlace pass at
// its own width, empty passes holding none), and each row is unfiltered
// with the five filter types of section 9, the filter's byte distance
// being the pixel's bytes (1 below 8 bits).  data/png.py keeps its own
// chunk parser and Python zlib inflate as the plain version and shares
// the pixel reconstruction here (snvc_png_pixels), so the two readers
// give the same pixels.  An image is written into the top-left corner of
// its slot and cropped where larger; the rest of the slot is zeroed.
//
// C ABI:
//   int64_t snvc_png_raw_bytes(uint32_t w, uint32_t h, int depth, int color,
//                              int interlace);
//   int  snvc_png_pixels(const uint8_t* raw, int64_t raw_len, uint32_t w,
//                        uint32_t h, int depth, int color, int interlace,
//                        const uint8_t* plte, int plte_len, uint8_t* rgb,
//                        int64_t* bad_filter);
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

extern "C" int snvc_png_pixels(const uint8_t* raw, int64_t raw_len,
                               uint32_t w, uint32_t h, int depth, int color,
                               int interlace, const uint8_t* plte,
                               int plte_len, uint8_t* rgb,
                               int64_t* bad_filter);

namespace {

enum Status {
  kOk = 0,
  kNoFile = 1,       // the file does not open
  kNotPng = 2,       // no PNG signature
  kBadChunk = 3,     // a chunk's length or CRC is wrong, or no IEND
  kFormat = 4,       // a colour type / bit depth the specification does not
                     // allow, a palette image without a valid PLTE, an
                     // unknown compression, filter or interlace method, or a
                     // side of 0 or over kMaxSide
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

// Samples a pixel of colour type 0, 2, 3, 4 or 6 holds, or 0 for a colour
// type the specification does not define.
int channels(int color) {
  switch (color) {
    case 0: case 3: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// Whether the specification allows bit depth `depth` with colour type
// `color` (table 11.1).
bool depth_allowed(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

// The seven passes of Adam7: first column, first row, column step, row
// step (section 8.2).
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

uint64_t row_bytes(uint64_t width, int depth, int color) {
  return (width * channels(color) * depth + 7) / 8;
}

uint64_t pass_extent(uint32_t size, int first, int step) {
  return size > uint32_t(first) ? (size - first + step - 1) / step : 0;
}

// The bytes of the image data's scanlines (filter bytes included): of
// each pass with pixels at its own width when interlaced.
uint64_t raw_bytes(uint32_t w, uint32_t h, int depth, int color,
                   int interlace) {
  if (!interlace) return uint64_t(h) * (1 + row_bytes(w, depth, color));
  uint64_t total = 0;
  for (const auto& p : kAdam7) {
    const uint64_t pw = pass_extent(w, p[0], p[2]);
    const uint64_t ph = pass_extent(h, p[1], p[3]);
    if (pw && ph) total += ph * (1 + row_bytes(pw, depth, color));
  }
  return total;
}

struct Png {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  const uint8_t* plte = nullptr;  // the PLTE payload, if any
  uint32_t plte_len = 0;
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
      png->depth = body[8];
      png->color = body[9];
      png->interlace = body[12];
      if (png->w == 0 || png->h == 0 || png->w > kMaxSide ||
          png->h > kMaxSide)
        return kFormat;
      if (!depth_allowed(png->color, png->depth)) return kFormat;
      if (body[10] != 0 || body[11] != 0 || body[12] > 1) return kFormat;
      ihdr = true;
    } else if (std::memcmp(kind, "PLTE", 4) == 0) {
      png->plte = body;
      png->plte_len = n;
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
  // at most 1e6 rows of 1 + 8e6 bytes: no overflow in 64 bits
  const uint64_t raw =
      raw_bytes(png->w, png->h, png->depth, png->color, png->interlace);
  if (raw > idat_bytes * kMaxInflateRatio + 64) return kBadData;
  return kOk;
}

// Unfilters `height` rows of (1 filter byte + stride bytes) from `in`
// into `out` (height rows of stride bytes), `bpp` the filter's byte
// distance.  Returns 0, or 1 + the index of the first row whose filter
// byte is not one of 0-4.  Sub, Average and Paeth depend on the
// reconstructed left neighbour, so a row is a sequential loop.
int64_t unfilter(const uint8_t* in, uint8_t* out, int64_t height,
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
        return r + 1;
    }
  }
  return 0;
}

// Sample `i` of an unfiltered row of `depth`-bit samples, reduced to 8
// bits: a 16-bit sample's high byte, a sub-byte one as it is (the
// caller scales grey and looks palette indices up).
inline int sample(const uint8_t* row, uint64_t i, int depth) {
  switch (depth) {
    case 8: return row[i];
    case 16: return row[2 * i];
    default: {
      const uint64_t bit = i * depth;
      return (row[bit >> 3] >> (8 - depth - int(bit & 7))) &
             ((1 << depth) - 1);
    }
  }
}

// Writes the pixels of an unfiltered row of `width` pixels as 8-bit RGB
// at dst, dst + step * 3, ...
void row_to_rgb(const uint8_t* row, uint64_t width, int depth, int color,
                const uint8_t* palette, uint8_t* dst, uint64_t step) {
  const int ch = channels(color);
  // grey below 8 bits scaled to 0-255 (1 bit x255, 2 bits x85, 4 x17)
  const int scale = depth < 8 && color == 0 ? 255 / ((1 << depth) - 1) : 1;
  for (uint64_t x = 0; x < width; ++x, dst += 3 * step) {
    const uint64_t s = x * ch;
    if (color == 3) {
      std::memcpy(dst, palette + 3 * sample(row, s, depth), 3);
    } else if (color == 0 || color == 4) {
      dst[0] = dst[1] = dst[2] = uint8_t(scale * sample(row, s, depth));
    } else {  // 2, 6: alpha dropped
      dst[0] = uint8_t(sample(row, s, depth));
      dst[1] = uint8_t(sample(row, s + 1, depth));
      dst[2] = uint8_t(sample(row, s + 2, depth));
    }
  }
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
  std::vector<uint8_t> raw(
      raw_bytes(png.w, png.h, png.depth, png.color, png.interlace));
  rc = inflate_idat(png, &raw);
  if (rc != kOk) return rc;
  std::vector<uint8_t> img(size_t(png.h) * png.w * 3);
  rc = snvc_png_pixels(raw.data(), int64_t(raw.size()), png.w, png.h,
                       png.depth, png.color, png.interlace, png.plte,
                       int(png.plte_len), img.data(), nullptr);
  if (rc != kOk) return rc;
  const size_t copy_h = std::min<size_t>(png.h, size_t(oh));
  const size_t copy_w = std::min<size_t>(png.w, size_t(ow));
  for (size_t y = 0; y < copy_h; ++y)
    std::memcpy(out + y * row_out, img.data() + y * png.w * 3, copy_w * 3);
  return kOk;
}

}  // namespace

extern "C" {

// The bytes of the inflated image data of a w x h PNG of that bit depth,
// colour type and interlace method, or -1 for a header the decoder does
// not take (a side of 0 or over kMaxSide, a depth the colour type does
// not allow, an interlace method other than 0 and 1).
int64_t snvc_png_raw_bytes(uint32_t w, uint32_t h, int depth, int color,
                           int interlace) {
  if (w == 0 || h == 0 || w > kMaxSide || h > kMaxSide ||
      !depth_allowed(color, depth) || interlace < 0 || interlace > 1)
    return -1;
  return int64_t(raw_bytes(w, h, depth, color, interlace));
}

// The pixels of a PNG's inflated image data `raw` (raw_len bytes: every
// scanline with its filter byte, pass by pass when `interlace` is 1)
// as 8-bit RGB in rgb[h, w, 3]; `plte` holds the PLTE payload (plte_len
// bytes, or none), which a palette image must have (1 to 256 entries).
// Returns kOk, kFormat for a header or palette it does not take,
// kBadData when raw_len is not the scanlines' size, kBadFilter for a
// filter byte that is not 0-4 (its offset in raw to *bad_filter, unless
// null), or kNoMemory.
int snvc_png_pixels(const uint8_t* raw, int64_t raw_len, uint32_t w,
                    uint32_t h, int depth, int color, int interlace,
                    const uint8_t* plte, int plte_len, uint8_t* rgb,
                    int64_t* bad_filter) {
  const int64_t want = snvc_png_raw_bytes(w, h, depth, color, interlace);
  if (want < 0) return kFormat;
  if (color == 3 && (!plte || plte_len <= 0 || plte_len % 3 ||
                     plte_len > 3 * 256))
    return kFormat;
  if (raw_len != want) return kBadData;
  const uint8_t* const start = raw;
  try {
    // the palette padded to 256 black entries: an index past PLTE's
    // entries reads black, as libpng's expanded palette does
    uint8_t palette[3 * 256] = {0};
    if (color == 3) std::memcpy(palette, plte, size_t(plte_len));
    const int bpp = std::max(1, channels(color) * depth / 8);
    const int passes = interlace ? 7 : 1;
    const int whole[4] = {0, 0, 1, 1};
    std::vector<uint8_t> rows;
    for (int p = 0; p < passes; ++p) {
      const int* a = interlace ? kAdam7[p] : whole;
      const uint64_t pw = pass_extent(w, a[0], a[2]);
      const uint64_t ph = pass_extent(h, a[1], a[3]);
      if (!pw || !ph) continue;  // an empty pass holds no scanline
      const uint64_t stride = row_bytes(pw, depth, color);
      rows.resize(ph * stride);
      if (const int64_t bad = unfilter(raw, rows.data(), int64_t(ph),
                                       int64_t(stride), bpp)) {
        if (bad_filter)
          *bad_filter = (raw - start) + (bad - 1) * int64_t(1 + stride);
        return kBadFilter;
      }
      for (uint64_t y = 0; y < ph; ++y)
        row_to_rgb(rows.data() + y * stride, pw, depth, color, palette,
                   rgb + ((a[1] + y * a[3]) * uint64_t(w) + a[0]) * 3,
                   uint64_t(a[2]));
      raw += ph * (1 + stride);
    }
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return kOk;
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
