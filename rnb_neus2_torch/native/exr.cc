// The OpenEXR codecs that are not zlib: PIZ (a bitmap of the used 16-bit
// values, OpenEXR's Huffman code, the 2-D Haar wavelet), B44 / B44A
// (4x4 blocks of HALF samples in 14 or 3 bytes) and the lossy DCT part
// of DWAA / DWAB (run-length AC, the inverse 8x8 DCT in the order of
// operations libOpenEXR 3.1's AVX code uses, the BT.709 inverse colour
// transform and the nonlinear-to-linear table). zlib, the DWA header and
// its channel rules are Python's (`io/exr.py`). Each entry point returns
// a byte count or 0 on success, or a negative code:
//   -1 input ends early, -2 corrupt data, -3 output buffer too small.
// Built with g++ into `build/` at first use (`io/native.py`).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr int64_t kShort = -1, kCorrupt = -2, kSmall = -3;

// ------------------------------------------------------------ half <-> float

float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f, man = h & 0x3ff, bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: normalise
      int e = -1;
      do { ++e; man <<= 1; } while (!(man & 0x400));
      bits = sign | ((uint32_t)(112 - e) << 23) | ((man & 0x3ff) << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000 | (man << 13);
  } else {
    bits = sign | ((exp + 112) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// Round to nearest, ties to even (Imath's half(float) and F16C's
// vcvtps2ph with rounding mode 0).
uint16_t float_to_half(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint16_t sign = (x >> 16) & 0x8000;
  uint32_t ax = x & 0x7fffffff;
  if (ax >= 0x7f800000) {  // inf or NaN
    if (ax == 0x7f800000) return sign | 0x7c00;
    uint16_t m = (ax >> 13) & 0x3ff;
    return sign | 0x7c00 | (m ? m : 1);
  }
  if (ax >= 0x477ff000) return sign | 0x7c00;  // rounds past HALF_MAX
  if (ax < 0x38800000) {  // below the smallest normal half
    if (ax < 0x33000000) return sign;  // at most half the smallest subnormal
    uint32_t e = ax >> 23;
    uint32_t m = (ax & 0x7fffff) | 0x800000;
    // the value is m 2^(e - 150), in units of the smallest subnormal half
    // (2^-24) m 2^(e - 126)
    int shift = 126 - (int)e;
    uint32_t q = m >> shift, rem = m & ((1u << shift) - 1),
             halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (q & 1))) ++q;
    return sign | (uint16_t)q;
  }
  uint32_t e = (ax >> 23) - 112, m = ax & 0x7fffff;
  uint32_t q = (e << 10) | (m >> 13), rem = m & 0x1fff;
  if (rem > 0x1000 || (rem == 0x1000 && (q & 1))) ++q;
  return sign | (uint16_t)q;
}

// ------------------------------------------------------------------ tables

uint16_t g_to_linear[65536];  // DWA: nonlinear half -> linear half
uint16_t g_log[65536];        // B44 pLinear: 8 log(h)
std::once_flag g_tables_once;

void build_tables() {
  const float log_base = (float)std::pow(2.7182818, 2.2);
  for (uint32_t i = 0; i < 65536; ++i) {
    float h = half_to_float((uint16_t)i);
    // dwaLookups: 0, NaN and inf map to 0; gamma 2.2 below 1, a log
    // curve above
    if (i == 0 || (i & 0x7c00) == 0x7c00) {
      g_to_linear[i] = 0;
    } else {
      float sign = h < 0 ? -1.f : 1.f;
      float a = std::fabs(h), v;
      if (a <= 1.0f)
        v = (float)std::pow((double)a, (double)2.2f);
      else
        v = (float)std::pow((double)log_base, (double)(a - 1.0f));
      g_to_linear[i] = float_to_half(sign * v);
    }
    // b44ExpLogTable's logTable: 8 log(h), 0 for NaN, inf and negative
    // h. B44's decoder applies it to pLinear channels (its
    // convertToLinear reads logTable; the encoder's convertFromLinear
    // reads expTable)
    if ((i & 0x7c00) == 0x7c00 || h < 0)
      g_log[i] = 0;
    else
      g_log[i] = float_to_half((float)(8 * std::log((double)h)));
  }
}

void tables() { std::call_once(g_tables_once, build_tables); }

// ----------------------------------------------------------------- Huffman
// OpenEXR's Huffman code (ImfHuf.cpp): 2^16 + 1 symbols, the last index
// of the table (iM) is the run-length symbol; code lengths packed in 6
// bits with zero runs; canonical codes; decoded with a 14-bit table.

constexpr int kEncBits = 16, kDecBits = 14;
constexpr int kEncSize = (1 << kEncBits) + 1, kDecSize = 1 << kDecBits;
constexpr int kShortZeroRun = 59, kLongZeroRun = 63;
constexpr int kShortestLongRun = 2 + kLongZeroRun - kShortZeroRun;

struct HufDec {
  int len = 0;               // short code length, 0 for long codes
  uint32_t lit = 0;          // short: the symbol; long: count in `p`
  std::vector<uint32_t> p;   // long codes' symbols
};

int64_t unpack_table(const uint8_t *&p, const uint8_t *end, int im, int iM,
                     std::vector<uint64_t> &hcode) {
  hcode.assign(kEncSize, 0);
  const uint8_t *start = p;
  uint64_t c = 0;
  int lc = 0;
  int64_t ni = end - start;
  auto get = [&](int n) -> int64_t {
    while (lc < n) {
      if (p >= end) return -1;
      c = (c << 8) | *p++;
      lc += 8;
    }
    lc -= n;
    return (int64_t)((c >> lc) & ((1u << n) - 1));
  };
  for (; im <= iM; im++) {
    if (p - start >= ni) return kShort;
    int64_t l = get(6);
    if (l < 0) return kShort;
    hcode[im] = (uint64_t)l;
    if (l == kLongZeroRun) {
      int64_t z = get(8);
      if (z < 0) return kShort;
      int zerun = (int)z + kShortestLongRun;
      if (im + zerun > iM + 1) return kCorrupt;
      while (zerun--) hcode[im++] = 0;
      im--;
    } else if (l >= kShortZeroRun) {
      int zerun = (int)l - kShortZeroRun + 2;
      if (im + zerun > iM + 1) return kCorrupt;
      while (zerun--) hcode[im++] = 0;
      im--;
    }
  }
  // canonical codes
  uint64_t n[59] = {0};
  for (int i = 0; i < kEncSize; ++i) n[hcode[i]] += 1;
  uint64_t cc = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (cc + n[i]) >> 1;
    n[i] = cc;
    cc = nc;
  }
  for (int i = 0; i < kEncSize; ++i) {
    int l = (int)hcode[i];
    if (l > 0) hcode[i] = (uint64_t)l | (n[l]++ << 6);
  }
  return 0;
}

int64_t build_dec_table(const std::vector<uint64_t> &hcode, int im, int iM,
                        std::vector<HufDec> &dec) {
  dec.assign(kDecSize, HufDec());
  for (; im <= iM; im++) {
    uint64_t c = hcode[im] >> 6;
    int l = (int)(hcode[im] & 63);
    if (c >> l) return kCorrupt;
    if (l > kDecBits) {
      HufDec &pl = dec[c >> (l - kDecBits)];
      if (pl.len) return kCorrupt;
      pl.lit++;
      pl.p.push_back((uint32_t)im);
    } else if (l) {
      uint64_t base = c << (kDecBits - l);
      for (uint64_t i = 0; i < (1ull << (kDecBits - l)); ++i) {
        HufDec &pl = dec[base + i];
        if (pl.len || !pl.p.empty()) return kCorrupt;
        pl.len = l;
        pl.lit = (uint32_t)im;
      }
    }
  }
  return 0;
}

// Emit symbol `po` (or, for the run-length symbol, the 8-bit count that
// follows it as copies of the previous output).
inline int64_t get_code(uint32_t po, int rlc, uint64_t &c, int &lc,
                        const uint8_t *&in, const uint8_t *ie,
                        uint16_t *&out, uint16_t *ob, uint16_t *oe) {
  if ((int)po == rlc) {
    if (lc < 8) {
      if (in >= ie) return kShort;
      c = (c << 8) | *in++;
      lc += 8;
    }
    lc -= 8;
    uint8_t cs = (uint8_t)(c >> lc);
    if (out + cs > oe) return kCorrupt;
    if (out - 1 < ob) return kCorrupt;
    uint16_t s = out[-1];
    while (cs-- > 0) *out++ = s;
  } else if (out < oe) {
    *out++ = (uint16_t)po;
  } else {
    return kCorrupt;
  }
  return 0;
}

int64_t huf_decode(const std::vector<uint64_t> &hcode,
                   const std::vector<HufDec> &dec, const uint8_t *in,
                   int64_t ni, int rlc, int64_t no, uint16_t *out) {
  uint64_t c = 0;
  int lc = 0;
  uint16_t *ob = out, *oe = out + no;
  const uint8_t *ie = in + (ni + 7) / 8;
  int64_t r;
  while (in < ie) {
    c = (c << 8) | *in++;
    lc += 8;
    while (lc >= kDecBits) {
      const HufDec &pl = dec[(c >> (lc - kDecBits)) & (kDecSize - 1)];
      if (pl.len) {
        lc -= pl.len;
        if ((r = get_code(pl.lit, rlc, c, lc, in, ie, out, ob, oe))) return r;
      } else {
        if (pl.p.empty()) return kCorrupt;
        uint32_t j;
        for (j = 0; j < pl.lit; j++) {
          int l = (int)(hcode[pl.p[j]] & 63);
          while (lc < l && in < ie) {
            c = (c << 8) | *in++;
            lc += 8;
          }
          if (lc >= l) {
            if ((hcode[pl.p[j]] >> 6) ==
                ((c >> (lc - l)) & ((uint64_t(1) << l) - 1))) {
              lc -= l;
              if ((r = get_code(pl.p[j], rlc, c, lc, in, ie, out, ob, oe)))
                return r;
              break;
            }
          }
        }
        if (j == pl.lit) return kCorrupt;
      }
    }
  }
  int i = (8 - (int)(ni & 7)) & 7;
  c >>= i;
  lc -= i;
  while (lc > 0) {
    const HufDec &pl = dec[(c << (kDecBits - lc)) & (kDecSize - 1)];
    if (!pl.len) return kCorrupt;
    lc -= pl.len;
    if (lc < 0) return kCorrupt;
    if ((r = get_code(pl.lit, rlc, c, lc, in, ie, out, ob, oe))) return r;
  }
  if (out - ob != no) return kShort;
  return 0;
}

uint32_t read_u32(const uint8_t *b) {
  return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
         ((uint32_t)b[3] << 24);
}

int64_t huf_uncompress(const uint8_t *src, int64_t n, uint16_t *raw,
                       int64_t n_raw) {
  if (n < 20) return n_raw ? kShort : 0;
  int64_t im = read_u32(src), iM = read_u32(src + 4);
  uint64_t n_bits = read_u32(src + 12);
  if (im < 0 || im >= kEncSize || iM < 0 || iM >= kEncSize || im > iM)
    return kCorrupt;
  const uint8_t *p = src + 20, *end = src + n;
  std::vector<uint64_t> hcode;
  int64_t r = unpack_table(p, end, (int)im, (int)iM, hcode);
  if (r) return r;
  if ((int64_t)((n_bits + 7) / 8) > end - p) return kShort;
  std::vector<HufDec> dec;
  if ((r = build_dec_table(hcode, (int)im, (int)iM, dec))) return r;
  return huf_decode(hcode, dec, p, (int64_t)n_bits, (int)iM, n_raw, raw);
}

// ----------------------------------------------------------------- wavelet

inline void wdec14(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
  int16_t ls = (int16_t)l, hs = (int16_t)h;
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  a = (uint16_t)(int16_t)ai;
  b = (uint16_t)(int16_t)(ai - hi);
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & 0xffff;
  int aa = (d + bb - 0x8000) & 0xffff;
  b = (uint16_t)bb;
  a = (uint16_t)aa;
}

void wav2_decode(uint16_t *in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = nx > ny ? ny : nx;
  int p = 1, p2;
  while (p <= n) p <<= 1;
  p >>= 1;
  p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t *py = in;
    uint16_t *ey = in + (ptrdiff_t)oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      uint16_t *px = py;
      uint16_t *ex = py + (ptrdiff_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t *p01 = px + ox1, *p10 = px + oy1, *p11 = p10 + ox1;
        if (w14) {
          wdec14(*px, *p10, i00, i10);
          wdec14(*p01, *p11, i01, i11);
          wdec14(i00, i01, *px, *p01);
          wdec14(i10, i11, *p10, *p11);
        } else {
          wdec16(*px, *p10, i00, i10);
          wdec16(*p01, *p11, i01, i11);
          wdec16(i00, i01, *px, *p01);
          wdec16(i10, i11, *p10, *p11);
        }
      }
      if (nx & p) {
        uint16_t *p10 = px + oy1;
        if (w14)
          wdec14(*px, *p10, i00, *p10);
        else
          wdec16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t *px = py;
      uint16_t *ex = py + (ptrdiff_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t *p01 = px + ox1;
        if (w14)
          wdec14(*px, *p01, i00, *p01);
        else
          wdec16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// -------------------------------------------------------------------- B44

void unpack14(const uint8_t b[14], uint16_t s[16]) {
  s[0] = (uint16_t)((b[0] << 8) | b[1]);
  uint16_t shift = b[2] >> 2;
  uint16_t bias = (uint16_t)(0x20u << shift);
  s[4] = s[0] + ((((b[2] << 4) | (b[3] >> 4)) & 0x3fu) << shift) - bias;
  s[8] = s[4] + ((((b[3] << 2) | (b[4] >> 6)) & 0x3fu) << shift) - bias;
  s[12] = s[8] + ((b[4] & 0x3fu) << shift) - bias;
  s[1] = s[0] + ((unsigned)(b[5] >> 2) << shift) - bias;
  s[5] = s[4] + ((((b[5] << 4) | (b[6] >> 4)) & 0x3fu) << shift) - bias;
  s[9] = s[8] + ((((b[6] << 2) | (b[7] >> 6)) & 0x3fu) << shift) - bias;
  s[13] = s[12] + ((b[7] & 0x3fu) << shift) - bias;
  s[2] = s[1] + ((unsigned)(b[8] >> 2) << shift) - bias;
  s[6] = s[5] + ((((b[8] << 4) | (b[9] >> 4)) & 0x3fu) << shift) - bias;
  s[10] = s[9] + ((((b[9] << 2) | (b[10] >> 6)) & 0x3fu) << shift) - bias;
  s[14] = s[13] + ((b[10] & 0x3fu) << shift) - bias;
  s[3] = s[2] + ((unsigned)(b[11] >> 2) << shift) - bias;
  s[7] = s[6] + ((((b[11] << 4) | (b[12] >> 4)) & 0x3fu) << shift) - bias;
  s[11] = s[10] + ((((b[12] << 2) | (b[13] >> 6)) & 0x3fu) << shift) - bias;
  s[15] = s[14] + ((b[13] & 0x3fu) << shift) - bias;
  for (int i = 0; i < 16; ++i) s[i] = (s[i] & 0x8000) ? (s[i] & 0x7fff) : (uint16_t)~s[i];
}

void unpack3(const uint8_t b[3], uint16_t s[16]) {
  s[0] = (uint16_t)((b[0] << 8) | b[1]);
  s[0] = (s[0] & 0x8000) ? (s[0] & 0x7fff) : (uint16_t)~s[0];
  for (int i = 1; i < 16; ++i) s[i] = s[0];
}

// ------------------------------------------------------------- DWA (DCT)

// libOpenEXR 3.1's AVX inverse DCT: its coefficients and, per pass, the
// order of its float operations (rows as two 4x4 matrix products summed
// pairwise, columns as the scalar butterfly), so that every sample
// rounds as there.
constexpr float kA = 3.535536e-01f, kB = 4.903927e-01f, kC = 4.619398e-01f,
                kD = 4.157349e-01f, kE = 2.777855e-01f, kF = 1.913422e-01f,
                kG = 9.754573e-02f;

void idct_rows(float *data) {
  static const float M1[4][4] = {{kA, kA, kA, kA},
                                 {kC, kF, -kF, -kC},
                                 {kA, -kA, -kA, kA},
                                 {kF, -kC, kC, -kF}};
  static const float M2[4][4] = {{kB, kD, kE, kG},
                                 {kD, -kG, -kB, -kE},
                                 {kE, -kB, kG, kD},
                                 {kG, -kE, kD, -kB}};
  for (int r = 0; r < 8; ++r) {
    float *x = data + 8 * r;
    float even[4], odd[4];
    for (int k = 0; k < 4; ++k) {
      float p0 = M1[0][k] * x[0], p1 = M1[1][k] * x[2];
      float p2 = M1[2][k] * x[4], p3 = M1[3][k] * x[6];
      even[k] = (p0 + p1) + (p2 + p3);
      float q0 = M2[0][k] * x[1], q1 = M2[1][k] * x[3];
      float q2 = M2[2][k] * x[5], q3 = M2[3][k] * x[7];
      odd[k] = (q0 + q1) + (q2 + q3);
    }
    for (int k = 0; k < 4; ++k) {
      x[k] = even[k] + odd[k];
      x[7 - k] = even[k] - odd[k];
    }
  }
}

void idct_columns(float *data) {
  for (int col = 0; col < 8; ++col) {
    float r[8];
    for (int i = 0; i < 8; ++i) r[i] = data[8 * i + col];
    float beta0 = (kB * r[1] + kD * r[3]) + (kE * r[5] + kG * r[7]);
    float beta1 = (kD * r[1] - (kG * r[3] + kB * r[5])) - kE * r[7];
    float beta2 = ((kE * r[1] - kB * r[3]) + kG * r[5]) + kD * r[7];
    float beta3 = (kG * r[1] + kD * r[5]) - (kE * r[3] + kB * r[7]);
    float a0 = kA * r[0], a4 = kA * r[4];
    float theta0 = a0 + a4, theta3 = a0 - a4;
    float theta1 = kC * r[2] + kF * r[6];
    float theta2 = kF * r[2] - kC * r[6];
    float gamma0 = theta0 + theta1, gamma3 = theta0 - theta1;
    float gamma1 = theta3 + theta2, gamma2 = theta3 - theta2;
    data[col] = gamma0 + beta0;
    data[8 + col] = gamma1 + beta1;
    data[16 + col] = gamma2 + beta2;
    data[24 + col] = gamma3 + beta3;
    data[32 + col] = gamma3 - beta3;
    data[40 + col] = gamma2 - beta2;
    data[48 + col] = gamma1 - beta1;
    data[56 + col] = gamma0 - beta0;
  }
}

// the zig-zag index of each position of an 8x8 block, row by row
constexpr int kZigZag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

}  // namespace

extern "C" {

// OpenEXR's Huffman decode of `n` bytes into `n_raw` 16-bit symbols.
int64_t exr_huf_decode(const uint8_t *src, int64_t n, uint16_t *raw,
                       int64_t n_raw) {
  return huf_uncompress(src, n, raw, n_raw);
}

// The inverse 2-D wavelet of one plane in place (PIZ's wav2Decode): nx
// samples `ox` apart, ny rows `oy` apart, `mx` the largest value.
int64_t exr_wav_decode(uint16_t *data, int32_t nx, int32_t ox, int32_t ny,
                       int32_t oy, int32_t mx) {
  if (nx > 0 && ny > 0) wav2_decode(data, nx, ox, ny, oy, (uint16_t)mx);
  return 0;
}

// One PIZ chunk of `n_ch` channels (types: 0 UINT, 1 HALF, 2 FLOAT) of nx
// x ny samples → the uncompressed chunk (per row, per channel, nx
// little-endian samples) in dst; returns its size.
int64_t exr_piz_decode(const uint8_t *src, int64_t n, int32_t n_ch,
                       const int32_t *types, int32_t nx, int32_t ny,
                       uint8_t *dst, int64_t cap) {
  int64_t words = 0;
  for (int c = 0; c < n_ch; ++c) words += (int64_t)nx * ny * (types[c] == 1 ? 1 : 2);
  if (words * 2 > cap) return kSmall;
  if (n == 0) return 0;
  const uint8_t *p = src, *end = src + n;
  if (end - p < 4) return kShort;
  uint16_t min_nz = p[0] | (p[1] << 8), max_nz = p[2] | (p[3] << 8);
  p += 4;
  if (max_nz >= 8192) return kCorrupt;
  std::vector<uint8_t> bitmap(8192, 0);
  if (min_nz <= max_nz) {
    if (end - p < max_nz - min_nz + 1) return kShort;
    std::memcpy(&bitmap[min_nz], p, max_nz - min_nz + 1);
    p += max_nz - min_nz + 1;
  }
  std::vector<uint16_t> lut(65536, 0);
  int k = 0;
  for (int i = 0; i < 65536; ++i)
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = (uint16_t)i;
  uint16_t max_value = (uint16_t)(k - 1);
  if (end - p < 4) return kShort;
  int32_t length = (int32_t)read_u32(p);
  p += 4;
  if (length < 0 || length > end - p) return kShort;
  std::vector<uint16_t> tmp(words);
  int64_t r = huf_uncompress(p, length, tmp.data(), words);
  if (r) return r;
  int64_t at = 0;
  std::vector<int64_t> start(n_ch);
  for (int c = 0; c < n_ch; ++c) {
    int size = types[c] == 1 ? 1 : 2;
    start[c] = at;
    for (int j = 0; j < size; ++j)
      wav2_decode(tmp.data() + at + j, nx, size, ny, nx * size, max_value);
    at += (int64_t)nx * ny * size;
  }
  for (auto &v : tmp) v = lut[v];
  uint8_t *o = dst;
  for (int y = 0; y < ny; ++y) {
    for (int c = 0; c < n_ch; ++c) {
      int size = types[c] == 1 ? 1 : 2;
      const uint16_t *row = tmp.data() + start[c] + (int64_t)y * nx * size;
      for (int i = 0; i < nx * size; ++i) {
        *o++ = row[i] & 0xff;
        *o++ = row[i] >> 8;
      }
    }
  }
  return o - dst;
}

// One B44 / B44A chunk (as exr_piz_decode; `plinear` a flag a channel).
int64_t exr_b44_decode(const uint8_t *src, int64_t n, int32_t n_ch,
                       const int32_t *types, const int32_t *plinear,
                       int32_t nx, int32_t ny, uint8_t *dst, int64_t cap) {
  tables();
  int64_t words = 0;
  for (int c = 0; c < n_ch; ++c) words += (int64_t)nx * ny * (types[c] == 1 ? 1 : 2);
  if (words * 2 > cap) return kSmall;
  std::vector<uint16_t> tmp(words);
  std::vector<int64_t> start(n_ch);
  const uint8_t *p = src, *end = src + n;
  int64_t at = 0;
  for (int c = 0; c < n_ch; ++c) {
    start[c] = at;
    if (types[c] != 1) {
      int64_t bytes = (int64_t)nx * ny * 4;
      if (end - p < bytes) return kShort;
      for (int64_t i = 0; i < bytes / 2; ++i) tmp[at + i] = p[2 * i] | (p[2 * i + 1] << 8);
      p += bytes;
      at += bytes / 2;
      continue;
    }
    uint16_t *plane = tmp.data() + at;
    for (int y = 0; y < ny; y += 4) {
      for (int x = 0; x < nx; x += 4) {
        uint16_t s[16];
        if (end - p < 3) return kShort;
        if (p[2] == 0xfc) {
          unpack3(p, s);
          p += 3;
        } else {
          if (end - p < 14) return kShort;
          unpack14(p, s);
          p += 14;
        }
        if (plinear[c])
          for (int i = 0; i < 16; ++i) s[i] = g_log[s[i]];
        for (int dy = 0; dy < 4 && y + dy < ny; ++dy)
          for (int dx = 0; dx < 4 && x + dx < nx; ++dx)
            plane[(int64_t)(y + dy) * nx + x + dx] = s[4 * dy + dx];
      }
    }
    at += (int64_t)nx * ny;
  }
  if (p != end) return kCorrupt;
  uint8_t *o = dst;
  for (int y = 0; y < ny; ++y) {
    for (int c = 0; c < n_ch; ++c) {
      int size = types[c] == 1 ? 1 : 2;
      const uint16_t *row = tmp.data() + start[c] + (int64_t)y * nx * size;
      for (int i = 0; i < nx * size; ++i) {
        *o++ = row[i] & 0xff;
        *o++ = row[i] >> 8;
      }
    }
  }
  return o - dst;
}

// One DWA lossy-DCT set of `n_comp` (1, or 3 with the BT.709 inverse
// colour transform) width x height planes from the run-length AC values
// `ac` (n_ac of them) and the DC values `dc` (one a block a component,
// component after component) → half samples in `out` (n_comp planes),
// through the nonlinear-to-linear table when `to_linear`. used[0], used[1]
// get the AC and DC values consumed. Returns 0 or a negative code.
int64_t exr_dwa_lossy(const uint16_t *ac, int64_t n_ac, const uint16_t *dc,
                      int64_t n_dc, int32_t n_comp, int32_t width,
                      int32_t height, int32_t to_linear, uint16_t *out,
                      int64_t *used) {
  tables();
  if (n_comp != 1 && n_comp != 3) return kCorrupt;
  int bx = (width + 7) / 8, by = (height + 7) / 8;
  int64_t blocks = (int64_t)bx * by;
  if (n_dc < blocks * n_comp) return kShort;
  const uint16_t *ac_end = ac + n_ac, *acp = ac;
  std::vector<uint16_t> row_blocks((size_t)n_comp * bx * 64);
  float dct[3][64];
  for (int y = 0; y < by; ++y) {
    for (int x = 0; x < bx; ++x) {
      bool constant = true;
      for (int c = 0; c < n_comp; ++c) {
        uint16_t zig[64] = {0};
        zig[0] = dc[(int64_t)c * blocks + (int64_t)y * bx + x];
        int last = 0, k = 1;
        while (k < 64) {
          if (acp >= ac_end) return kShort;
          uint16_t v = *acp++;
          if (v == 0xff00) {
            k = 64;
          } else if ((v >> 8) == 0xff) {
            k += v & 0xff;
          } else {
            last = k;
            zig[k++] = v;
          }
        }
        if (last == 0) {
          float val = half_to_float(zig[0]) * kA * kA;
          for (int i = 0; i < 64; ++i) dct[c][i] = val;
        } else {
          constant = false;
          for (int i = 0; i < 64; ++i) dct[c][i] = half_to_float(zig[kZigZag[i]]);
          idct_rows(dct[c]);
          idct_columns(dct[c]);
        }
      }
      int n = constant ? 1 : 64;
      if (n_comp == 3) {
        for (int i = 0; i < n; ++i) {
          float s0 = dct[0][i], s1 = dct[1][i], s2 = dct[2][i];
          dct[0][i] = s0 + 1.5747f * s2;
          dct[1][i] = (s0 - 0.1873f * s1) - 0.4682f * s2;
          dct[2][i] = s0 + 1.8556f * s1;
        }
      }
      for (int c = 0; c < n_comp; ++c) {
        uint16_t *blk = &row_blocks[((size_t)c * bx + x) * 64];
        if (constant) {
          uint16_t h = float_to_half(dct[c][0]);
          for (int i = 0; i < 64; ++i) blk[i] = h;
        } else {
          for (int i = 0; i < 64; ++i) blk[i] = float_to_half(dct[c][i]);
        }
      }
    }
    int rows = y == by - 1 ? height - 8 * y : 8;
    for (int c = 0; c < n_comp; ++c) {
      for (int r = 0; r < rows; ++r) {
        uint16_t *dst = out + (int64_t)c * width * height +
                        (int64_t)(8 * y + r) * width;
        for (int x = 0; x < width; ++x) {
          uint16_t v = row_blocks[((size_t)c * bx + x / 8) * 64 + r * 8 + (x & 7)];
          dst[x] = to_linear ? g_to_linear[v] : v;
        }
      }
    }
  }
  used[0] = acp - ac;
  used[1] = blocks * n_comp;
  return 0;
}

}  // extern "C"
