// PNG row unfiltering (PNG specification, section 9: filter method 0).
//
// data: n_rows rows of (1 + stride) bytes, a filter-type byte then the
// filtered row; out: n_rows * stride bytes of reconstructed samples; bpp:
// bytes per complete pixel (at least 1). Returns 0, or 1 + the index of
// the first row whose filter type is not 0-4.
#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* data, uint8_t* out,
                            int64_t n_rows, int64_t stride, int64_t bpp) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* in = data + r * (stride + 1);
    const uint8_t ftype = in[0];
    ++in;
    uint8_t* cur = out + r * stride;
    const uint8_t* up = r ? cur - stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return static_cast<int>(r + 1);
      }
      cur[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  return 0;
}
