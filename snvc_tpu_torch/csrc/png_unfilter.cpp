// PNG row reconstruction (the five filter types of the PNG specification,
// section 9) for snvc_tpu_torch/data/png.py, which inflates the image data
// with zlib and hands the filtered rows here.  Host code, built with the
// host compiler at first use (snvc_tpu_torch/_build.py:build_host); no
// CUDA, no libpng.  Sub, Average and Paeth depend on the reconstructed
// left neighbour, so a row is a sequential loop: in Python it would cost
// about a second for one 375x1242 frame.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// in:  height rows of (1 filter byte + stride bytes)
// out: height rows of stride bytes
// Returns 0, or 1 + the index of the first row whose filter byte is not
// one of 0-4.
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

}  // extern "C"
