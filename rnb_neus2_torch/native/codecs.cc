// Byte- and bit-serial parts of the image codecs of `rnb_neus2_torch/io/`:
// what numpy cannot vectorize because each step depends on the one before.
//
//   lzw_decode / lzw_encode       TIFF LZW (TIFF 6.0 section 13; MSB-first
//                                  codes of 9-12 bits, "early change")
//   packbits_decode / _encode     TIFF PackBits (section 9), row by row
//   exr_rle_decode                OpenEXR RLE (signed run counts)
//   jpeg_decode_scan              one sequential Huffman scan (ITU T.81
//                                  F.2) into dequantizable coefficients
//   jpeg_decode_progressive       one progressive Huffman scan (G.2):
//                                  DC/AC first and refine, EOB runs
//   jpeg_decode_arith             one arithmetic-coded scan, sequential or
//                                  progressive (Annex D, F.2.4, G.2), as
//                                  libjpeg-turbo's jdarith.c decodes it
//   jpeg_decode_lossless          one lossless Huffman scan (Annex H)
//   jpeg_encode_scan              one interleaved baseline scan (F.1)
//   bmp_rle_decode                BMP RLE8 / RLE4 as OpenCV's grfmt_bmp
//   pnm_read_numbers              PNM ASCII numbers as OpenCV's ReadNumber
//   hdr_decode / hdr_encode_rle   Radiance scanlines (Greg Ward's rgbe.c)
//   gif_lzw_decode / _encode      GIF LZW, codes of 3-12 bits
//   gif_dither                    OpenCV 5's GIF palette and dithering
//   vp8l_decode / vp8l_unpredict  WebP lossless: prefix codes, colour
//                                  cache, LZ77, the transforms' sub-images;
//                                  the predictor transform's inverse
//   vp8l_encode                   WebP lossless, a simple VP8L stream
//   vp8l_analyze                  libwebp's lossless analysis: transform
//                                  set, predictor modes, and the colour
//                                  it leaves under alpha 0
//   alpha_ungradient              WebP ALPH's gradient filter, undone
//   sgilog_decode                 TIFF SGILog / SGILog24 (libtiff's
//                                  tif_luv.c), to XYZ and to 8-bit RGB
//   vp8_parse / vp8_reconstruct   VP8 key frames: headers, modes and
//                                  tokens; intra prediction and the loop
//                                  filters (libwebp's dec.c / frame_dec.c)
//
// Every function returns a byte count or position, or a negative error
// code the Python side turns into a ValueError naming the file.
#include <cstdint>
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstring>
#include <vector>

#include "sgilog_uv.h"

namespace {

// ---------------------------------------------------------------- LZW
constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;

struct BitWriterMsb {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;
  int bits = 0;
  bool overflow = false;
  void put(uint32_t code, int width) {
    acc = (acc << width) | code;
    bits += width;
    while (bits >= 8) {
      bits -= 8;
      byte(static_cast<uint8_t>(acc >> bits));
    }
  }
  void byte(uint8_t b) {
    if (n < cap) out[n] = b; else overflow = true;
    ++n;
  }
  void flush() {
    if (bits) byte(static_cast<uint8_t>(acc << (8 - bits)));
    bits = 0;
  }
};

}  // namespace

extern "C" int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
  // prefix[c], suffix byte and length of each table entry
  static thread_local int32_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local int32_t length[4096];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1; suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -2;  // old-style LZW
  int64_t bitpos = 0, out = 0;
  const int64_t nbits = n * 8;
  int width = 9, next = kFirst, old = -1;
  while (bitpos + width <= nbits) {
    uint32_t code = 0;
    for (int i = 0; i < width; ++i, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9; next = kFirst; old = -1;
      continue;
    }
    int32_t entry;
    if (old < 0) {
      if (code > 255) return -1;
      entry = code;
    } else if (static_cast<int>(code) < next) {
      entry = code;
    } else if (static_cast<int>(code) == next) {
      entry = -1;  // KwKwK: old's string + its first byte
    } else {
      return -1;
    }
    // write the string of `entry` (or old + first(old)) backwards
    const int32_t src_entry = entry >= 0 ? entry : old;
    const int32_t len = length[src_entry] + (entry >= 0 ? 0 : 1);
    if (out + len > cap) return -3;
    int64_t p = out + length[src_entry] - 1;
    for (int32_t e = src_entry; e >= 0; e = prefix[e]) dst[p--] = suffix[e];
    if (entry < 0) dst[out + len - 1] = first[old];
    const uint8_t head = first[src_entry];
    out += len;
    if (old >= 0 && next < 4096) {
      prefix[next] = old; suffix[next] = head; first[next] = first[old];
      length[next] = length[old] + 1;
      ++next;
    }
    old = code;
    if (next + 1 >= (1 << width) && width < kMaxBits) ++width;
  }
  return out;
}

extern "C" int64_t lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
  // child table: (code, byte) -> code, open addressing
  constexpr int kHash = 1 << 14;
  std::vector<int32_t> key(kHash), val(kHash);
  BitWriterMsb w{dst, cap};
  int width = 9, next = kFirst;
  auto reset = [&] {
    std::fill(key.begin(), key.end(), -1);
    width = 9; next = kFirst;
  };
  reset();
  w.put(kClear, width);
  if (n == 0) { w.put(kEoi, width); w.flush(); return w.overflow ? -3 : w.n; }
  int32_t cur = src[0];
  auto grow = [&] {  // the decoder adds an entry per code, one code behind
    ++next;
    if (next == 4094) {
      w.put(kClear, width);
      reset();
    } else if (next == (1 << width)) {
      ++width;
    }
  };
  for (int64_t i = 1; i < n; ++i) {
    const int32_t k = (cur << 8) | src[i];
    uint32_t h = (static_cast<uint32_t>(k) * 2654435761u) >> 18;
    while (key[h] != -1 && key[h] != k) h = (h + 1) & (kHash - 1);
    if (key[h] == k) { cur = val[h]; continue; }
    w.put(cur, width);
    key[h] = k; val[h] = next;
    grow();
    cur = src[i];
  }
  w.put(cur, width);
  grow();
  w.put(kEoi, width);
  w.flush();
  return w.overflow ? -3 : w.n;
}

// ----------------------------------------------------------- PackBits
extern "C" int64_t packbits_decode(const uint8_t* src, int64_t n,
                                   uint8_t* dst, int64_t cap) {
  int64_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int h = static_cast<int8_t>(src[i++]);
    if (h >= 0) {
      const int64_t len = h + 1;
      if (i + len > n || out + len > cap) return -1;
      std::memcpy(dst + out, src + i, len);
      i += len; out += len;
    } else if (h != -128) {
      const int64_t len = 1 - h;
      if (i >= n || out + len > cap) return -1;
      std::memset(dst + out, src[i++], len);
      out += len;
    }
  }
  return out;
}

extern "C" int64_t packbits_encode(const uint8_t* src, int64_t n_rows,
                                   int64_t row_bytes, uint8_t* dst,
                                   int64_t cap) {
  int64_t out = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* s = src + r * row_bytes;
    int64_t i = 0;
    while (i < row_bytes) {
      int64_t run = 1;
      while (i + run < row_bytes && run < 128 && s[i + run] == s[i]) ++run;
      if (run >= 3) {
        if (out + 2 > cap) return -3;
        dst[out++] = static_cast<uint8_t>(1 - run);
        dst[out++] = s[i];
        i += run;
        continue;
      }
      int64_t lit = 1;  // up to the next run of 3 or the 128-byte limit
      while (i + lit < row_bytes && lit < 128 &&
             !(i + lit + 2 < row_bytes && s[i + lit] == s[i + lit + 1] &&
               s[i + lit] == s[i + lit + 2]))
        ++lit;
      if (out + 1 + lit > cap) return -3;
      dst[out++] = static_cast<uint8_t>(lit - 1);
      std::memcpy(dst + out, s + i, lit);
      out += lit; i += lit;
    }
  }
  return out;
}

// ------------------------------------------------------------ EXR RLE
extern "C" int64_t exr_rle_decode(const uint8_t* src, int64_t n,
                                  uint8_t* dst, int64_t cap) {
  int64_t i = 0, out = 0;
  while (i < n) {
    const int c = static_cast<int8_t>(src[i++]);
    if (c < 0) {
      const int64_t len = -c;
      if (i + len > n || out + len > cap) return -1;
      std::memcpy(dst + out, src + i, len);
      i += len; out += len;
    } else {
      const int64_t len = c + 1;
      if (i >= n || out + len > cap) return -1;
      std::memset(dst + out, src[i++], len);
      out += len;
    }
  }
  return out;
}

// --------------------------------------------------------------- JPEG
namespace {

// natural (row-major) index of the k-th coefficient in zig-zag order
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

// A decoding table built from BITS (counts of codes of length 1-16) and
// HUFFVAL, as in T.81 Annex C and F.2.2.3, with a 9-bit lookahead.
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0 = slow path
  bool build(const uint8_t* bits, const uint8_t* huffval) {
    int32_t code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    std::memcpy(vals, huffval, 256);
    for (int len = 1; len <= 16; ++len) {
      const int cnt = bits[len - 1];
      // as jdhuff.c: at most 256 values, and no code of all ones (which
      // also keeps every code inside its length before look[] is filled)
      if (k + cnt > 256 || code + cnt >= (1 << len)) return false;
      valoffset[len] = k - code;
      for (int i = 0; i < cnt; ++i, ++code, ++k) {
        if (len <= kLookBits) {
          const int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] =
                static_cast<uint16_t>((len << 8) | huffval[k]);
        }
      }
      maxcode[len] = cnt ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    return true;
  }
};

// The entropy-coded segment's bits; a marker stops the reader, which then
// supplies zeros as libjpeg does (and counts them, so a scan that ran out
// of data is reported).
struct BitReader {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;
  int64_t fake = 0;  // zero bits supplied past the data
  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0) {
            pos = q + 1;
          } else {
            at_marker = true;
            pos = q - 1;
            b = 0;
            fake += 8;
          }
        } else {
          ++pos;
        }
      } else {
        at_marker = true;
        fake += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  void skip(int k) { buf <<= k; cnt -= k; }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffTable& t) {
    const uint32_t look = peek(16);
    const uint16_t e = t.look[look >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      const int32_t code = static_cast<int32_t>(look >> (16 - len));
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.vals[code + t.valoffset[len]];
      }
    }
    return -1;
  }
  void restart(int64_t p) {
    pos = p; buf = 0; cnt = 0; at_marker = false; fake = 0;
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                             : static_cast<int>(v);
}

}  // namespace

namespace {

// The position of the next marker (its 0xFF) at or after p: fill bytes
// and stuffed zeros skipped; n if there is none.
int64_t next_marker(const uint8_t* data, int64_t n, int64_t p) {
  while (p + 1 < n) {
    if (data[p] == 0xFF && data[p + 1] != 0 && data[p + 1] != 0xFF &&
        !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7))
      return p;
    ++p;
  }
  return n;
}

// The position after the restart marker RST<want> that follows p; n if
// the data ends first (the end of the file, or a marker other than a
// restart marker: libjpeg then goes on with zero bits); -1 for another
// restart marker than RST<want>.
int64_t after_restart(const uint8_t* data, int64_t n, int64_t p, int want) {
  while (p < n && data[p] != 0xFF) ++p;
  while (p + 1 < n && data[p + 1] == 0xFF) ++p;
  if (p + 1 >= n) return n;
  if (data[p + 1] == 0xD0 + want) return p + 2;
  return (data[p + 1] & 0xF8) == 0xD0 ? -1 : n;
}

bool build_tables(std::vector<HuffTable>& tables, const uint8_t* bits,
                  const uint8_t* vals) {
  for (size_t t = 0; t < tables.size(); ++t)
    if (!tables[t].build(bits + 16 * t, vals + 256 * t)) return false;
  return true;
}

}  // namespace

// Decode one scan. bits: n_tables x 16, vals: n_tables x 256; comp_dc /
// comp_ac: the table of each scan component; block_comp[b]: the scan
// component of block b of an MCU; block_row[m * blocks_per_mcu + b]: the
// row of coefs (n x 64, natural order) that block goes to. Returns the
// position of the marker that ends the scan; -1 bad table, -2 bad code,
// -3 a restart marker other than the one due. Where the data ends (a
// marker or the end of the file) inside the scan, the MCU decodes on zero
// bits and the later ones are left as they are, as libjpeg does;
// *stopped is then that MCU's index (else -1).
extern "C" int64_t jpeg_decode_scan(
    const uint8_t* data, int64_t n, int64_t pos, int64_t n_mcus,
    int32_t blocks_per_mcu, const int32_t* block_comp,
    const int64_t* block_row, const int32_t* comp_dc,
    const int32_t* comp_ac, int32_t n_tables, const uint8_t* bits,
    const uint8_t* vals, int32_t restart_interval, int16_t* coefs,
    int64_t* stopped) {
  *stopped = -1;
  std::vector<HuffTable> tables(n_tables);
  for (int t = 0; t < n_tables; ++t)
    if (!tables[t].build(bits + 16 * t, vals + 256 * t)) return -1;
  BitReader br{data, n, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      const int64_t p = after_restart(data, n, br.pos, next_rst);
      if (p < 0) return -3;
      next_rst = (next_rst + 1) & 7;
      br.restart(p);
      for (int c = 0; c < 4; ++c) pred[c] = 0;
    }
    for (int b = 0; b < blocks_per_mcu; ++b) {
      const int c = block_comp[b];
      int16_t* blk = coefs + 64 * block_row[m * blocks_per_mcu + b];
      std::memset(blk, 0, 64 * sizeof(int16_t));
      int s = br.decode(tables[comp_dc[c]]);
      if (s < 0 || s > 16) return -2;
      if (s) pred[c] += extend(br.get(s), s);
      blk[0] = static_cast<int16_t>(pred[c]);
      const HuffTable& ac = tables[comp_ac[c]];
      for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(ac);
        if (rs < 0) return -2;
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) return -2;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (br.fake > br.cnt) {  // zeros past the data were decoded
      *stopped = m;
      break;
    }
  }
  // the next marker: skip the rest of the data (padding bits, fill bytes)
  return next_marker(data, n, br.pos);
}


// One progressive Huffman scan (T.81 G.2, libjpeg-turbo's jdphuff.c):
// spectral band ss..se at successive-approximation bits ah/al, into
// coefs as they accumulate over the scans. Arguments and returns as
// jpeg_decode_scan.
extern "C" int64_t jpeg_decode_progressive(
    const uint8_t* data, int64_t n, int64_t pos, int64_t n_mcus,
    int32_t blocks_per_mcu, const int32_t* block_comp,
    const int64_t* block_row, const int32_t* comp_dc,
    const int32_t* comp_ac, int32_t n_tables, const uint8_t* bits,
    const uint8_t* vals, int32_t restart_interval, int32_t ss, int32_t se,
    int32_t ah, int32_t al, int16_t* coefs, int64_t* stopped) {
  *stopped = -1;
  std::vector<HuffTable> tables(n_tables);
  if (!build_tables(tables, bits, vals)) return -1;
  BitReader br{data, n, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  int next_rst = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      const int64_t p = after_restart(data, n, br.pos, next_rst);
      if (p < 0) return -3;
      next_rst = (next_rst + 1) & 7;
      br.restart(p);
      for (int c = 0; c < 4; ++c) pred[c] = 0;
      eobrun = 0;
    }
    for (int b = 0; b < blocks_per_mcu; ++b) {
      const int c = block_comp[b];
      int16_t* blk = coefs + 64 * block_row[m * blocks_per_mcu + b];
      if (ss == 0 && ah == 0) {                  // DC first
        const int s = br.decode(tables[comp_dc[c]]);
        if (s < 0 || s > 16) return -2;
        if (s) pred[c] += extend(br.get(s), s);
        blk[0] = static_cast<int16_t>(pred[c] * p1);
      } else if (ss == 0) {                      // DC refine
        if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
      } else if (ah == 0) {                      // AC first
        if (eobrun > 0) { --eobrun; continue; }
        const HuffTable& t = tables[comp_ac[c]];
        for (int k = ss; k <= se; ++k) {
          const int rs = br.decode(t);
          if (rs < 0) return -2;
          const int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            if (k > 63) return -2;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s) * p1);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) - 1;
            if (r) eobrun += br.get(r);
            break;
          }
        }
      } else {                                   // AC refine
        const HuffTable& t = tables[comp_ac[c]];
        // a correction bit for each coefficient already nonzero
        auto correct = [&](int16_t* coef) {
          if (br.get(1) && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
        };
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            const int rs = br.decode(t);
            if (rs < 0) return -2;
            int r = rs >> 4, s = rs & 15;
            if (s) {
              s = br.get(1) ? p1 : m1;  // a new coefficient has size 1
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += br.get(r);
              break;
            }
            do {  // skip r zero coefficients, correcting nonzero ones
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) {
                correct(coef);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (s) blk[kNatural[std::min(k, 63)]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k)
            if (blk[kNatural[k]] != 0) correct(blk + kNatural[k]);
          --eobrun;
        }
      }
    }
    if (br.fake > br.cnt) {
      *stopped = m;
      break;
    }
  }
  return next_marker(data, n, br.pos);
}

// ------------------------------------------------- arithmetic decoding
namespace {

// ITU T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS for
// the 113 states of the QM coder, and libjpeg's state 113 (a fixed
// probability of 1/2: the sign and refinement bins).
constexpr uint16_t kQe[114][4] = {
    {0x5a1d,   1,   1, 1}, {0x2586,  14,   2, 0}, {0x1114,  16,   3, 0},
    {0x080b,  18,   4, 0}, {0x03d8,  20,   5, 0}, {0x01da,  23,   6, 0},
    {0x00e5,  25,   7, 0}, {0x006f,  28,   8, 0}, {0x0036,  30,   9, 0},
    {0x001a,  33,  10, 0}, {0x000d,  35,  11, 0}, {0x0006,   9,  12, 0},
    {0x0003,  10,  13, 0}, {0x0001,  12,  13, 0}, {0x5a7f,  15,  15, 1},
    {0x3f25,  36,  16, 0}, {0x2cf2,  38,  17, 0}, {0x207c,  39,  18, 0},
    {0x17b9,  40,  19, 0}, {0x1182,  42,  20, 0}, {0x0cef,  43,  21, 0},
    {0x09a1,  45,  22, 0}, {0x072f,  46,  23, 0}, {0x055c,  48,  24, 0},
    {0x0406,  49,  25, 0}, {0x0303,  51,  26, 0}, {0x0240,  52,  27, 0},
    {0x01b1,  54,  28, 0}, {0x0144,  56,  29, 0}, {0x00f5,  57,  30, 0},
    {0x00b7,  59,  31, 0}, {0x008a,  60,  32, 0}, {0x0068,  62,  33, 0},
    {0x004e,  63,  34, 0}, {0x003b,  32,  35, 0}, {0x002c,  33,   9, 0},
    {0x5ae1,  37,  37, 1}, {0x484c,  64,  38, 0}, {0x3a0d,  65,  39, 0},
    {0x2ef1,  67,  40, 0}, {0x261f,  68,  41, 0}, {0x1f33,  69,  42, 0},
    {0x19a8,  70,  43, 0}, {0x1518,  72,  44, 0}, {0x1177,  73,  45, 0},
    {0x0e74,  74,  46, 0}, {0x0bfb,  75,  47, 0}, {0x09f8,  77,  48, 0},
    {0x0861,  78,  49, 0}, {0x0706,  79,  50, 0}, {0x05cd,  48,  51, 0},
    {0x04de,  50,  52, 0}, {0x040f,  50,  53, 0}, {0x0363,  51,  54, 0},
    {0x02d4,  52,  55, 0}, {0x025c,  53,  56, 0}, {0x01f8,  54,  57, 0},
    {0x01a4,  55,  58, 0}, {0x0160,  56,  59, 0}, {0x0125,  57,  60, 0},
    {0x00f6,  58,  61, 0}, {0x00cb,  59,  62, 0}, {0x00ab,  61,  63, 0},
    {0x008f,  61,  32, 0}, {0x5b12,  65,  65, 1}, {0x4d04,  80,  66, 0},
    {0x412c,  81,  67, 0}, {0x37d8,  82,  68, 0}, {0x2fe8,  83,  69, 0},
    {0x293c,  84,  70, 0}, {0x2379,  86,  71, 0}, {0x1edf,  87,  72, 0},
    {0x1aa9,  87,  73, 0}, {0x174e,  72,  74, 0}, {0x1424,  72,  75, 0},
    {0x119c,  74,  76, 0}, {0x0f6b,  74,  77, 0}, {0x0d51,  75,  78, 0},
    {0x0bb6,  77,  79, 0}, {0x0a40,  77,  48, 0}, {0x5832,  80,  81, 1},
    {0x4d1c,  88,  82, 0}, {0x438e,  89,  83, 0}, {0x3bdd,  90,  84, 0},
    {0x34ee,  91,  85, 0}, {0x2eae,  92,  86, 0}, {0x299a,  93,  87, 0},
    {0x2516,  86,  71, 0}, {0x5570,  88,  89, 1}, {0x4ca9,  95,  90, 0},
    {0x44d9,  96,  91, 0}, {0x3e22,  97,  92, 0}, {0x3824,  99,  93, 0},
    {0x32b4,  99,  94, 0}, {0x2e17,  93,  86, 0}, {0x56a8,  95,  96, 1},
    {0x4f46, 101,  97, 0}, {0x47e5, 102,  98, 0}, {0x41cf, 103,  99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e,  99,  93, 0}, {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103,  99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0},
};

// The decoder of T.81 D.2 as libjpeg-turbo's arith_decode runs it: a
// marker inside the data supplies zero bytes from there on (which is
// legal in arithmetic coding), as does the end of the data.
struct ArithDecoder {
  const uint8_t* d;
  int64_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  int64_t marker = -1;  // position of the marker that stopped the data
  int byte() {
    if (marker >= 0) return 0;
    if (pos >= n) { marker = n; return 0; }
    int data = d[pos++];
    if (data == 0xFF) {
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos < n && d[pos] == 0) { ++pos; return 0xFF; }
      marker = pos - 1;
      return 0;
    }
    return data;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const uint16_t* row = kQe[sv & 0x7F];
    const int64_t qe = row[0];
    const int nl = row[1] | (row[3] << 7), nm = row[2];
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void restart(int64_t p) {
    pos = p; c = 0; a = 0; ct = -16; marker = -1;
  }
};

// F.1.4.4.2: the magnitude category and bits of a nonzero AC value from
// bin `st` (S0 + 2) on, X1 at `x1`, with its sign; false on overflow.
bool arith_ac_value(ArithDecoder& ad, uint8_t* st, uint8_t* x1, int sign,
                    int* out) {
  int m = ad.decode(st);
  if (m && ad.decode(st)) {
    m <<= 1;
    st = x1;
    while (ad.decode(st)) {
      if ((m <<= 1) == 0x8000) return false;
      ++st;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (ad.decode(st)) v |= m;
  v += 1;
  *out = sign ? -v : v;
  return true;
}

}  // namespace

// One arithmetic-coded scan (SOF9 sequential when progressive == 0, else
// SOF10 with band ss..se at bits ah/al), as jdarith.c decodes it. dc_tbl /
// ac_tbl: the conditioning table (0-15) of each scan component; dc_l,
// dc_u, ac_k: the DAC conditioning of tables 0-15. Layout arguments as
// jpeg_decode_scan. Returns the position of the marker that ends the scan
// (-3 a restart marker other than the one due); a coding error leaves the
// rest of the restart interval as it is, as libjpeg does.
extern "C" int64_t jpeg_decode_arith(
    const uint8_t* data, int64_t n, int64_t pos, int64_t n_mcus,
    int32_t blocks_per_mcu, const int32_t* block_comp,
    const int64_t* block_row, int32_t n_comps, const int32_t* dc_tbl,
    const int32_t* ac_tbl, const uint8_t* dc_l, const uint8_t* dc_u,
    const uint8_t* ac_k, int32_t restart_interval, int32_t progressive,
    int32_t ss, int32_t se, int32_t ah, int32_t al, int16_t* coefs) {
  static thread_local uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  const bool dc_first = !progressive || (ss == 0 && ah == 0);
  const bool uses_ac = !progressive || ss != 0;
  auto reset_stats = [&] {
    for (int c = 0; c < n_comps; ++c) {
      if (dc_first) {
        std::memset(dc_stats[dc_tbl[c]], 0, 64);
        last_dc[c] = dc_context[c] = 0;
      }
      if (uses_ac) std::memset(ac_stats[ac_tbl[c]], 0, 256);
    }
  };
  reset_stats();
  ArithDecoder ad{data, n, pos};
  bool failed = false;  // libjpeg's ct == -1: skip to the next restart
  int next_rst = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      const int64_t from = ad.marker >= 0 ? ad.marker : ad.pos;
      const int64_t p = after_restart(data, n, from, next_rst);
      if (p < 0) return -3;
      next_rst = (next_rst + 1) & 7;
      ad.restart(p);
      reset_stats();
      failed = false;
    }
    if (failed) continue;
    for (int b = 0; b < blocks_per_mcu && !failed; ++b) {
      const int c = block_comp[b];
      int16_t* blk = coefs + 64 * block_row[m * blocks_per_mcu + b];
      if (progressive && ss == 0 && ah != 0) {   // DC refine
        if (ad.decode(&fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | p1);
        continue;
      }
      if (dc_first && ss == 0) {                 // a DC difference
        const int t = dc_tbl[c];
        uint8_t* st = dc_stats[t] + dc_context[c];
        if (ad.decode(st) == 0) {
          dc_context[c] = 0;
        } else {
          const int sign = ad.decode(st + 1);
          st += 2 + sign;
          int mcat = ad.decode(st);
          if (mcat) {
            st = dc_stats[t] + 20;               // X1
            while (ad.decode(st)) {
              if ((mcat <<= 1) == 0x8000) { failed = true; break; }
              ++st;
            }
            if (failed) break;
          }
          // the category decides the next context (F.1.4.4.1.2)
          if (mcat < ((1 << dc_l[t]) >> 1))
            dc_context[c] = 0;
          else if (mcat > ((1 << dc_u[t]) >> 1))
            dc_context[c] = 12 + sign * 4;
          else
            dc_context[c] = 4 + sign * 4;
          int v = mcat;
          st += 14;
          while (mcat >>= 1)
            if (ad.decode(st)) v |= mcat;
          v += 1;
          if (sign) v = -v;
          last_dc[c] = (last_dc[c] + v) & 0xffff;
        }
        blk[0] = static_cast<int16_t>(
            static_cast<int16_t>(last_dc[c]) * (progressive ? p1 : 1));
        if (progressive) continue;
      }
      const int t = ac_tbl[c];
      const int kmin = progressive ? ss : 1, kmax = progressive ? se : 63;
      if (progressive && ah != 0) {              // AC refine
        int kex = kmax;
        while (kex > 0 && blk[kNatural[kex]] == 0) --kex;
        for (int k = kmin; k <= kmax; ++k) {
          uint8_t* st = ac_stats[t] + 3 * (k - 1);
          if (k > kex && ad.decode(st)) break;   // EOB
          for (;;) {
            int16_t* coef = blk + kNatural[k];
            if (*coef) {
              if (ad.decode(st + 2))
                *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
              break;
            }
            if (ad.decode(st + 1)) {
              *coef = static_cast<int16_t>(ad.decode(&fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > kmax) { failed = true; break; }
          }
          if (failed) break;
        }
        continue;
      }
      for (int k = kmin; k <= kmax; ++k) {       // AC first / sequential
        uint8_t* st = ac_stats[t] + 3 * (k - 1);
        if (ad.decode(st)) break;                // EOB
        while (ad.decode(st + 1) == 0) {
          st += 3;
          if (++k > kmax) { failed = true; break; }
        }
        if (failed) break;
        const int sign = ad.decode(&fixed_bin);
        int v;
        if (!arith_ac_value(ad, st + 2,
                            ac_stats[t] + (k <= ac_k[t] ? 189 : 217), sign,
                            &v)) {
          failed = true;
          break;
        }
        blk[kNatural[k]] = static_cast<int16_t>(v * (progressive ? p1 : 1));
      }
    }
  }
  return next_marker(data, n, ad.marker >= 0 ? ad.marker : ad.pos);
}

// One lossless Huffman scan (T.81 H, libjpeg-turbo's jdlhuff.c and
// jdpred.c): n_comps interleaved components of width x height samples
// (all sampled 1x1), comp_tbl the DC table of each, predictor 1-7,
// point transform pt, precision bits; out: n_comps planes of uint16,
// each sample shifted left by pt. A restart interval must hold whole
// rows, as libjpeg-turbo requires. Returns as jpeg_decode_scan.
extern "C" int64_t jpeg_decode_lossless(
    const uint8_t* data, int64_t n, int64_t pos, int32_t width,
    int32_t height, int32_t n_comps, const int32_t* comp_tbl,
    int32_t n_tables, const uint8_t* bits, const uint8_t* vals,
    int32_t restart_interval, int32_t predictor, int32_t pt,
    int32_t precision, uint16_t* out) {
  std::vector<HuffTable> tables(n_tables);
  if (!build_tables(tables, bits, vals)) return -1;
  if (restart_interval % width) return -5;
  const int64_t rows_per_restart = restart_interval / width;
  BitReader br{data, n, pos};
  std::vector<int32_t> diff(static_cast<size_t>(width) * n_comps);
  std::vector<int32_t> prev(diff.size()), cur(diff.size());
  int next_rst = 0;
  bool first_row = true;
  for (int64_t y = 0; y < height; ++y) {
    if (rows_per_restart && y && y % rows_per_restart == 0) {
      const int64_t p = after_restart(data, n, br.pos, next_rst);
      if (p < 0) return -3;
      next_rst = (next_rst + 1) & 7;
      br.restart(p);
      first_row = true;
    }
    for (int64_t x = 0; x < width; ++x) {
      for (int c = 0; c < n_comps; ++c) {
        int s = br.decode(tables[comp_tbl[c]]);
        if (s < 0 || s > 16) return -2;
        if (s == 16) s = 32768;
        else if (s) s = extend(br.get(s), s);
        diff[x * n_comps + c] = s;
      }
    }
    if (br.fake > br.cnt) return -4;
    for (int c = 0; c < n_comps; ++c) {
      auto at = [&](const std::vector<int32_t>& v, int64_t x) -> int32_t {
        return v[x * n_comps + c];
      };
      for (int64_t x = 0; x < width; ++x) {
        int32_t px;
        if (first_row) {
          px = x ? at(cur, x - 1) : 1 << (precision - pt - 1);
        } else if (x == 0) {
          px = at(prev, 0);
        } else {
          const int32_t ra = at(cur, x - 1), rb = at(prev, x),
                        rc = at(prev, x - 1);
          switch (predictor) {
            case 1: px = ra; break;
            case 2: px = rb; break;
            case 3: px = rc; break;
            case 4: px = ra + rb - rc; break;
            case 5: px = ra + ((rb - rc) >> 1); break;
            case 6: px = rb + ((ra - rc) >> 1); break;
            default: px = (ra + rb) >> 1; break;
          }
        }
        cur[x * n_comps + c] = (at(diff, x) + px) & 0xFFFF;
        out[(c * static_cast<int64_t>(height) + y) * width + x] =
            static_cast<uint16_t>(cur[x * n_comps + c] << pt);
      }
    }
    std::swap(prev, cur);
    first_row = false;
  }
  return next_marker(data, n, br.pos);
}

// Encode blocks (n_blocks x 64 quantized coefficients, natural order, in
// scan order) into one baseline scan with the given code tables (ehufco /
// ehufsi: n_tables x 256 codes and lengths). Returns bytes written, with
// 0xFF stuffed and the last byte padded with ones; -3 if out is too small.
extern "C" int64_t jpeg_encode_scan(
    const int16_t* coefs, int64_t n_blocks, int32_t blocks_per_mcu,
    const int32_t* block_comp, const int32_t* comp_dc, const int32_t* comp_ac,
    const uint16_t* ehufco, const uint8_t* ehufsi, uint8_t* out,
    int64_t cap) {
  int64_t o = 0;
  uint64_t acc = 0;
  int bits = 0;
  bool overflow = false;
  auto emit = [&](uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    bits += size;
    while (bits >= 8) {
      bits -= 8;
      const uint8_t b = static_cast<uint8_t>(acc >> bits);
      if (o + 2 > cap) { overflow = true; return; }
      out[o++] = b;
      if (b == 0xFF) out[o++] = 0;
    }
  };
  auto nbits = [](int v) {
    int a = v < 0 ? -v : v, s = 0;
    while (a) { ++s; a >>= 1; }
    return s;
  };
  int32_t pred[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < n_blocks && !overflow; ++i) {
    const int c = block_comp[i % blocks_per_mcu];
    const int16_t* blk = coefs + 64 * i;
    const uint16_t* dco = ehufco + 256 * comp_dc[c];
    const uint8_t* dcs = ehufsi + 256 * comp_dc[c];
    const uint16_t* aco = ehufco + 256 * comp_ac[c];
    const uint8_t* acs = ehufsi + 256 * comp_ac[c];
    int diff = blk[0] - pred[c];
    pred[c] = blk[0];
    int s = nbits(diff);
    emit(dco[s], dcs[s]);
    if (s) emit(diff < 0 ? diff - 1 : diff, s);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = blk[kNatural[k]];
      if (v == 0) { ++run; continue; }
      while (run > 15) { emit(aco[0xF0], acs[0xF0]); run -= 16; }
      s = nbits(v);
      const int rs = (run << 4) | s;
      emit(aco[rs], acs[rs]);
      emit(v < 0 ? v - 1 : v, s);
      run = 0;
    }
    if (run) emit(aco[0], acs[0]);
  }
  if (bits) emit(0x7F, 8 - bits);
  return overflow ? -3 : o;
}

// ---------------------------------------------------------------- BMP RLE
// OpenCV's BmpDecoder::readData for BI_RLE8 / BI_RLE4, into palette
// indices (h, w) in file row order: pixels that a delta, an end of line or
// the end of the bitmap skip take index 0 (cv2 fills them with palette
// entry 0). Runs are counted in pixels where cv2 counts bytes of its
// output row. → 0, -1 for a run past the end of a row (cv2 gives up), -2
// when the data ends early (cv2's stream throws).
namespace {

struct RleRows {
  uint8_t* out;
  int64_t w, h, x = 0, y = 0;
  // FillUniColor: `count` pixels of `v`, wrapping to the next row
  void fill(int64_t count, uint8_t v) {
    do {
      int64_t end = std::min(x + count, w);
      count -= end - x;
      if (y < h)
        for (; x < end; ++x) out[y * w + x] = v;
      else
        x = end;
      if (x >= w) {
        x = 0;
        if (++y >= h) break;
      }
    } while (count > 0);
  }
};

}  // namespace

extern "C" int64_t bmp_rle_decode(const uint8_t* src, int64_t n, int64_t w,
                                  int64_t h, int32_t bits, uint8_t* out) {
  RleRows r{out, w, h};
  std::memset(out, 0, static_cast<size_t>(w * h));
  int64_t pos = 0;
  int line_end_flag = 0;
#define GET(v)                 \
  do {                         \
    if (pos >= n) return -2;   \
    (v) = src[pos++];          \
  } while (0)
  for (;;) {
    int len, code;
    GET(len);
    GET(code);
    if (len != 0) {  // encoded run
      if (r.x + len > w || r.y >= h) return -1;
      if (bits == 8) {
        int64_t prev_y = r.y;
        r.fill(len, static_cast<uint8_t>(code));
        line_end_flag = static_cast<int>(r.y - prev_y);
        if (r.y >= h) break;
      } else {
        for (int t = 0; t < len; ++t, ++r.x)
          out[r.y * w + r.x] = static_cast<uint8_t>(t & 1 ? code & 15
                                                          : code >> 4);
      }
    } else if (code > 2) {  // absolute run
      if (r.x + code > w || r.y >= h) return -1;
      int64_t sz = bits == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
      if (pos + sz > n) return -2;
      const uint8_t* s = src + pos;
      pos += sz;
      for (int i = 0; i < code; ++i, ++r.x)
        out[r.y * w + r.x] = bits == 8 ? s[i]
            : static_cast<uint8_t>(i & 1 ? s[i >> 1] & 15 : s[i >> 1] >> 4);
      line_end_flag = 0;
    } else {  // escape: 0 end of line, 1 end of bitmap, 2 delta
      int64_t x_shift = w - r.x, y_shift = h - r.y;
      if (bits == 4 || code || !line_end_flag || x_shift < w) {
        if (code == 2) {
          int dx, dy;
          GET(dx);
          GET(dy);
          x_shift = dx;
          y_shift = dy;
        }
        if (code != 0) x_shift += y_shift * w;
        if (bits == 8 && r.y >= h) break;
        r.fill(x_shift, 0);
        if (r.y >= h) break;
      }
      line_end_flag = 0;
      if (r.y >= h) break;
    }
  }
#undef GET
  return 0;
}

// ---------------------------------------------------------------- PNM
// OpenCV's ReadNumber (grfmt_pxm.cpp), `count` times from `pos`: skip
// whitespace and '#' comments (to '\n' or '\r'), then read digits (at most
// `maxdigits` if it is not 0), consuming the byte after them. → the new
// position, -1 for another byte where a number should start or a value
// past INT_MAX, -2 at the end of the data (cv2's stream throws there).
extern "C" int64_t pnm_read_numbers(const uint8_t* src, int64_t n,
                                    int64_t pos, int64_t count,
                                    int32_t maxdigits, int32_t* out) {
  auto space = [](int c) { return c == ' ' || (c >= '\t' && c <= '\r'); };
  for (int64_t k = 0; k < count; ++k) {
    if (pos >= n) return -2;
    int c = src[pos++];
    while (c < '0' || c > '9') {
      if (c == '#') {
        do {
          if (pos >= n) return -2;
          c = src[pos++];
        } while (c != '\n' && c != '\r');
        if (pos >= n) return -2;
        c = src[pos++];
      } else if (space(c)) {
        while (space(c)) {
          if (pos >= n) return -2;
          c = src[pos++];
        }
      } else {
        return -1;
      }
    }
    int64_t val = 0;
    int digits = 0;
    for (;;) {
      val = val * 10 + (c - '0');
      if (val > 2147483647) return -1;
      if (maxdigits != 0 && ++digits >= maxdigits) break;
      if (pos >= n) return -2;
      c = src[pos++];
      if (c < '0' || c > '9') break;
    }
    out[k] = static_cast<int32_t>(val);
  }
  return pos;
}

// ---------------------------------------------------------------- HDR
// Greg Ward's rgbe.c as OpenCV ships it. hdr_decode: RGBE_ReadPixels_RLE
// into (h, w, 4) RGBE bytes: scanlines of new-style RLE while each starts
// with 2, 2 and the width, and from the first one that does not, every
// remaining pixel flat; widths below 8 or above 0x7fff are flat
// throughout. → the bytes consumed, -1 for a bad scanline, -2 when the
// data ends early.
extern "C" int64_t hdr_decode(const uint8_t* src, int64_t n, int64_t w,
                              int64_t h, uint8_t* out) {
  int64_t pos = 0;
  auto flat = [&](int64_t from) -> int64_t {
    int64_t need = (w * h - from) * 4;
    if (pos + need > n) return -2;
    std::memcpy(out + from * 4, src + pos, static_cast<size_t>(need));
    return pos + need;
  };
  if (w < 8 || w > 0x7fff) return flat(0);
  std::vector<uint8_t> line(static_cast<size_t>(4 * w));
  for (int64_t y = 0; y < h; ++y) {
    if (pos + 4 > n) return -2;
    const uint8_t* q = src + pos;
    pos += 4;
    if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) {
      std::memcpy(out + y * w * 4, q, 4);
      return flat(y * w + 1);
    }
    if (((q[2] << 8) | q[3]) != w) return -1;
    uint8_t* p = line.data();
    for (int i = 0; i < 4; ++i) {
      uint8_t* end = line.data() + (i + 1) * w;
      while (p < end) {
        if (pos + 2 > n) return -2;
        int c = src[pos], v = src[pos + 1];
        pos += 2;
        if (c > 128) {
          c -= 128;
          if (c == 0 || c > end - p) return -1;
          std::memset(p, v, static_cast<size_t>(c));
          p += c;
        } else {
          if (c == 0 || c > end - p) return -1;
          *p++ = static_cast<uint8_t>(v);
          if (--c > 0) {
            if (pos + c > n) return -2;
            std::memcpy(p, src + pos, static_cast<size_t>(c));
            pos += c;
            p += c;
          }
        }
      }
    }
    uint8_t* o = out + y * w * 4;
    for (int64_t x = 0; x < w; ++x)
      for (int i = 0; i < 4; ++i) o[x * 4 + i] = line[i * w + x];
  }
  return pos;
}

// RGBE_WriteBytes_RLE for each of the four channels of each scanline of
// (h, w, 4) RGBE bytes, after its 2, 2, w >> 8, w & 255 start (the caller
// writes widths below 8 or above 0x7fff flat). → the bytes written, or -1
// if `cap` is too small.
extern "C" int64_t hdr_encode_rle(const uint8_t* rgbe, int64_t w, int64_t h,
                                  uint8_t* dst, int64_t cap) {
  constexpr int kMinRun = 4;
  int64_t n = 0;
  auto put = [&](uint8_t b) {
    if (n < cap) dst[n] = b;
    ++n;
  };
  std::vector<uint8_t> chan(static_cast<size_t>(w));
  for (int64_t y = 0; y < h; ++y) {
    put(2);
    put(2);
    put(static_cast<uint8_t>(w >> 8));
    put(static_cast<uint8_t>(w & 0xFF));
    for (int i = 0; i < 4; ++i) {
      for (int64_t x = 0; x < w; ++x) chan[x] = rgbe[(y * w + x) * 4 + i];
      const uint8_t* data = chan.data();
      int64_t cur = 0;
      while (cur < w) {
        int64_t beg = cur;
        int run = 0, old_run = 0;
        while (run < kMinRun && beg < w) {
          beg += run;
          old_run = run;
          run = 1;
          while (beg + run < w && run < 127 && data[beg] == data[beg + run])
            ++run;
        }
        if (old_run > 1 && old_run == beg - cur) {
          put(static_cast<uint8_t>(128 + old_run));
          put(data[cur]);
          cur = beg;
        }
        while (cur < beg) {
          int64_t k = std::min<int64_t>(beg - cur, 128);
          put(static_cast<uint8_t>(k));
          for (int64_t j = 0; j < k; ++j) put(data[cur + j]);
          cur += k;
        }
        if (run >= kMinRun) {
          put(static_cast<uint8_t>(128 + run));
          put(data[beg]);
          cur += run;
        }
      }
    }
  }
  return n <= cap ? n : -1;
}

// ---------------------------------------------------------------- GIF
// One image's LZW data (GIF89a appendix F: LSB-first codes from
// min_size + 1 bits up to 12, clear and end codes), given as the
// concatenated payload of its sub-blocks, into `npix` palette indices.
// A full table takes no more entries until a clear code. → the pixels
// decoded, or -1 for a code past the table or more pixels than `npix`
// (cv2 refuses both).
extern "C" int64_t gif_lzw_decode(const uint8_t* src, int64_t n,
                                  int32_t min_size, int64_t npix,
                                  uint8_t* out) {
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  static thread_local uint8_t stack[4096];
  const int clear = 1 << min_size, end = clear + 1;
  for (int c = 0; c < clear; ++c) {
    suffix[c] = first[c] = static_cast<uint8_t>(c);
    length[c] = 1;
  }
  int size = min_size + 1, next = end + 1, prev = -1;
  uint32_t acc = 0;
  int bits = 0;
  int64_t pos = 0, count = 0;
  for (;;) {
    while (bits < size && pos < n) {
      acc |= static_cast<uint32_t>(src[pos++]) << bits;
      bits += 8;
    }
    if (bits < size) break;
    int code = static_cast<int>(acc & ((1u << size) - 1));
    acc >>= size;
    bits -= size;
    if (code == clear) {
      size = min_size + 1;
      next = end + 1;
      prev = -1;
      continue;
    }
    if (code == end) break;
    if (code > next || (prev < 0 && code >= clear)) return -1;
    if (prev >= 0 && next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      first[next] = first[prev];
      suffix[next] = code == next ? first[prev] : first[code];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
    } else if (code == next) {
      return -1;
    }
    int len = length[code];
    if (count + len > npix) return -1;
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      stack[i] = suffix[c];
      c = prefix[c];
    }
    std::memcpy(out + count, stack, static_cast<size_t>(len));
    count += len;
    prev = code;
    if (next == (1 << size) && size < 12) ++size;
  }
  return count;
}

// GIF LZW of `n` indices at `min_size` (2-8) as OpenCV 5's GIF encoder
// codes them: a clear code first, codes widened when the next free code
// needs another bit, a clear code as the table fills (4096 codes), the
// end code last; LSB-first.
extern "C" int64_t gif_lzw_encode(const uint8_t* src, int64_t n,
                                  int32_t min_size, uint8_t* dst,
                                  int64_t cap) {
  const int clear = 1 << min_size, end = clear + 1;
  std::vector<int16_t> child(static_cast<size_t>(4096) << min_size, -1);
  int size = min_size + 1, next = end + 1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t out = 0;
  auto put = [&](int code) {
    acc |= static_cast<uint64_t>(code) << bits;
    bits += size;
    while (bits >= 8) {
      if (out < cap) dst[out] = static_cast<uint8_t>(acc);
      ++out;
      acc >>= 8;
      bits -= 8;
    }
  };
  put(clear);
  if (n == 0) {
    put(end);
  } else {
    int w = src[0];
    for (int64_t k = 1; k < n; ++k) {
      int c = src[k];
      int16_t& to = child[(static_cast<size_t>(w) << min_size) + c];
      if (to >= 0) {
        w = to;
        continue;
      }
      put(w);
      if (next < 4096) {
        to = static_cast<int16_t>(next);
        if (next++ == (1 << size) && size < 12) size++;
      }
      if (next == 4096) {
        put(clear);
        std::fill(child.begin(), child.end(), -1);
        size = min_size + 1;
        next = end + 1;
      }
      w = c;
    }
    put(w);
    put(end);
  }
  if (bits > 0) {
    if (out < cap) dst[out] = static_cast<uint8_t>(acc);
    ++out;
  }
  return out <= cap ? out : -1;
}

// OpenCV 5's GIF encoder at its defaults (grfmt_gif.cpp): a fixed palette
// of 8 levels of R and G (steps of 36) and 4 of B (steps of 85), index
// R << 5 | G << 2 | B, each level the nearest (halves up) to the sample
// plus the error diffused to it so far (summed apart from the sample),
// Floyd-Steinberg weights (7, 3, 5, 1)/16 in float32, rows left to right. `px`: (h, w, nc) RGB or RGBA uint8; a
// pixel of alpha 0 takes the transparent index 146 and diffuses nothing,
// and where one does, an opaque pixel of index 146 takes 142. → 1 if any
// pixel is transparent, else 0; the indices in `out`.
extern "C" int64_t gif_dither(const uint8_t* px, int32_t w, int32_t h,
                              int32_t nc, uint8_t* out) {
  const float kStep[3] = {36.f, 36.f, 85.f};
  const int kTop[3] = {7, 7, 3}, kShift[3] = {5, 2, 0};
  const int64_t npix = static_cast<int64_t>(w) * h;
  std::vector<float> err_sum(npix * 3, 0.f);  // the error diffused so far
  bool any_transparent = false;
  for (int64_t k = 0; k < npix; ++k)
    if (nc == 4 && px[k * 4 + 3] == 0) any_transparent = true;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int64_t k = static_cast<int64_t>(y) * w + x;
      if (nc == 4 && px[k * 4 + 3] == 0) {
        out[k] = 146;
        continue;
      }
      int index = 0;
      for (int c = 0; c < 3; ++c) {
        float v = static_cast<float>(px[k * nc + c]) + err_sum[k * 3 + c];
        int level = static_cast<int>(std::floor(v / kStep[c] + 0.5f));
        level = std::min(std::max(level, 0), kTop[c]);
        index |= level << kShift[c];
        float err = v - static_cast<float>(level) * kStep[c];
        auto spread = [&](int dx, int dy, int weight) {
          int xx = x + dx, yy = y + dy;
          if (xx < 0 || xx >= w || yy >= h) return;
          float& t = err_sum[(static_cast<int64_t>(yy) * w + xx) * 3 + c];
          t = t + err * static_cast<float>(weight) / 16.f;
        };
        spread(1, 0, 7);
        spread(-1, 1, 3);
        spread(0, 1, 5);
        spread(1, 1, 1);
      }
      out[k] = static_cast<uint8_t>(any_transparent && index == 146 ? 142
                                                                    : index);
    }
  return any_transparent ? 1 : 0;
}

// ---------------------------------------------------------------- WebP
// The entropy layers of WebP as libwebp decodes them (what cv2's WebP
// reader calls): VP8L, the lossless format (prefix codes, meta prefix
// codes, the colour cache, LZ77 backward references with the 120-entry
// distance map, and the transforms' sub-images) and VP8 key frames (the
// boolean decoder, frame and segment headers, token probabilities,
// intra modes and coefficients), then VP8's reconstruction (intra
// prediction and the loop filters), which runs block after block. The
// vectorisable steps (inverse transforms of VP8L, VP8's inverse WHT and
// DCT, the alpha filters, YUV to RGB) are numpy in io/webp.py.
namespace {

// ---- VP8L
struct LBits {
  const uint8_t* p;
  int64_t n, pos = 0;
  bool eos = false;
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++pos) {
      int64_t byte = pos >> 3;
      if (byte >= n) {
        eos = true;
        continue;
      }
      v |= static_cast<uint32_t>((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
};

// A canonical prefix code (as deflate's: the first bit read is the code's
// most significant); one used symbol takes no bits, as in libwebp.
struct Prefix {
  int count[16] = {0};
  std::vector<int> symbol;
  int single = -1;
  bool build(const int* len, int n) {
    std::fill(count, count + 16, 0);
    for (int s = 0; s < n; ++s) {
      if (len[s] > 15 || len[s] < 0) return false;
      ++count[len[s]];
    }
    int used = n - count[0];
    if (used == 0) return false;
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
    }
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    symbol.assign(static_cast<size_t>(used), 0);
    for (int s = 0; s < n; ++s)
      if (len[s]) symbol[offs[len[s]]++] = s;
    single = used == 1 ? symbol[0] : -1;
    return used == 1 || left == 0;
  }
  int decode(LBits& br) const {
    if (single >= 0) return single;
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= static_cast<int>(br.read(1));
      int c = count[l];
      if (code - c < first) return symbol[index + code - first];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return -1;
  }
};

const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};

inline int sub_sample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct Lossless {
  LBits br;
  uint32_t seen = 0;
  // transforms in bitstream order: type, bits, xsize before it, offset of
  // its data in `tdata` (predictor / cross-colour sub-image, or the
  // colour map expanded to 1 << (8 >> bits) entries)
  int32_t* tinfo;
  int ntrans = 0;
  std::vector<uint32_t> tdata;

  bool read_code(int alphabet, Prefix& out) {
    std::vector<int> len(static_cast<size_t>(alphabet), 0);
    if (br.read(1)) {
      int nsym = br.read(1) + 1;
      int s = br.read(br.read(1) ? 8 : 1);
      if (s < alphabet) len[s] = 1;
      if (nsym == 2) {
        s = br.read(8);
        if (s < alphabet) len[s] = 1;
      }
    } else {
      int cl[19] = {0};
      int ncodes = br.read(4) + 4;
      for (int i = 0; i < ncodes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
      Prefix lengths;
      if (!lengths.build(cl, 19)) return false;
      int max_symbol = alphabet;
      if (br.read(1)) {
        int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > alphabet) return false;
      }
      int prev = 8, sym = 0;
      while (sym < alphabet) {
        if (max_symbol-- == 0) break;
        int c = lengths.decode(br);
        if (c < 0 || br.eos) return false;
        if (c < 16) {
          len[sym++] = c;
          if (c) prev = c;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          int rep = br.read(extra[c - 16]) + offset[c - 16];
          if (sym + rep > alphabet) return false;
          int v = c == 16 ? prev : 0;
          while (rep-- > 0) len[sym++] = v;
        }
      }
    }
    if (br.eos) return false;
    return out.build(len.data(), alphabet);
  }

  static uint32_t copy_value(int sym, LBits& br) {
    if (sym < 4) return static_cast<uint32_t>(sym + 1);
    int extra = (sym - 2) >> 1;
    uint32_t offset = static_cast<uint32_t>(2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  bool transform(int* xs, int ys) {
    if (ntrans >= 4) return false;
    int type = br.read(2);
    if (seen & (1u << type)) return false;
    seen |= 1u << type;
    int32_t* t = tinfo + 4 * ntrans++;
    t[0] = type;
    t[1] = 0;
    t[2] = *xs;
    t[3] = static_cast<int32_t>(tdata.size());
    std::vector<uint32_t> sub;
    if (type == 0 || type == 1) {
      int bits = br.read(3) + 2;
      t[1] = bits;
      if (!image(sub_sample(*xs, bits), sub_sample(ys, bits), false, sub))
        return false;
    } else if (type == 3) {
      int ncolors = br.read(8) + 1;
      int bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
      t[1] = bits;
      if (!image(ncolors, 1, false, sub)) return false;
      std::vector<uint32_t> map(static_cast<size_t>(1) << (8 >> bits), 0);
      map[0] = sub[0];
      for (int i = 1; i < ncolors; ++i) {
        uint32_t a = sub[i], b = map[i - 1];
        map[i] = (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
                 (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
      }
      sub.swap(map);
      *xs = sub_sample(*xs, bits);
    }
    tdata.insert(tdata.end(), sub.begin(), sub.end());
    return true;
  }

  // DecodeImageStream: a level-0 image reads the transforms and may use
  // meta prefix codes; sub-images do neither.
  bool image(int xs, int ys, bool level0, std::vector<uint32_t>& out) {
    if (level0)
      while (br.read(1))
        if (!transform(&xs, ys)) return false;
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    int hbits = 0, hxs = 0, ngroups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
      hbits = br.read(3) + 2;
      hxs = sub_sample(xs, hbits);
      if (!image(hxs, sub_sample(ys, hbits), false, meta)) return false;
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        ngroups = std::max(ngroups, static_cast<int>(m) + 1);
      }
    }
    if (br.eos) return false;
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Prefix> codes(static_cast<size_t>(5) * ngroups);
    static const int alphabet[5] = {280, 256, 256, 256, 40};
    for (int g = 0; g < ngroups; ++g)
      for (int j = 0; j < 5; ++j)
        if (!read_code(alphabet[j] + (j == 0 ? cache_size : 0),
                       codes[5 * g + j]))
          return false;
    std::vector<uint32_t> cache(static_cast<size_t>(std::max(cache_size, 1)),
                                0);
    out.assign(static_cast<size_t>(xs) * ys, 0);
    const int64_t total = static_cast<int64_t>(xs) * ys;
    int64_t pos = 0;
    auto insert = [&](uint32_t argb) {
      if (cache_bits)
        cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    while (pos < total) {
      int col = static_cast<int>(pos % xs), row = static_cast<int>(pos / xs);
      const Prefix* g = codes.data() +
          5 * (hbits ? meta[(row >> hbits) * hxs + (col >> hbits)] : 0);
      int code = g[0].decode(br);
      if (code < 0 || br.eos) return false;
      if (code < 256) {
        int red = g[1].decode(br), blue = g[2].decode(br),
            alpha = g[3].decode(br);
        if (br.eos || red < 0 || blue < 0 || alpha < 0) return false;
        uint32_t argb = (static_cast<uint32_t>(alpha) << 24) |
                        (static_cast<uint32_t>(red) << 16) |
                        (static_cast<uint32_t>(code) << 8) |
                        static_cast<uint32_t>(blue);
        out[pos++] = argb;
        insert(argb);
      } else if (code < 280) {
        int64_t length = copy_value(code - 256, br);
        int dsym = g[4].decode(br);
        if (dsym < 0) return false;
        int64_t dcode = copy_value(dsym, br), dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          int v = kCodeToPlane[dcode - 1];
          dist = static_cast<int64_t>(v >> 4) * xs + 8 - (v & 0xf);
          if (dist < 1) dist = 1;
        }
        if (br.eos || pos < dist || total - pos < length) return false;
        for (int64_t i = 0; i < length; ++i, ++pos) {
          out[pos] = out[pos - dist];
          insert(out[pos]);
        }
      } else {
        if (code - 280 >= cache_size) return false;
        uint32_t argb = cache[code - 280];
        out[pos++] = argb;
        insert(argb);
      }
    }
    return !br.eos;
  }
};

}  // namespace

// A VP8L image stream (after the 5-byte header of a VP8L chunk, or an ALPH
// chunk's payload) of `xs` x `ys`: → the entropy-coded ARGB pixels of the
// width left after a colour-indexing transform into `out`, the transforms
// into `tinfo` (4 int32 each: type, bits, xsize before it, offset into
// `tdata`) and their data into `tdata` (uint32, capacity `tcap`). Returns
// the number of transforms, or -1 for a bitstream libwebp refuses.
extern "C" int64_t vp8l_decode(const uint8_t* src, int64_t n, int32_t xs,
                               int32_t ys, uint32_t* out, int32_t* tinfo,
                               uint32_t* tdata, int64_t tcap) {
  Lossless d{LBits{src, n}, 0, tinfo, 0, {}};
  std::vector<uint32_t> img;
  if (!d.image(xs, ys, true, img)) return -1;
  if (static_cast<int64_t>(d.tdata.size()) > tcap) return -1;
  std::memcpy(out, img.data(), img.size() * 4);
  std::memcpy(tdata, d.tdata.data(), d.tdata.size() * 4);
  return d.ntrans;
}

namespace {

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline int sub3(int a, int b, int c) {
  return std::abs(b - c) - std::abs(a - c);
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = 0;
  for (int s = 0; s < 32; s += 8)
    d += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t clamp_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(clip255(static_cast<int>((a >> s) & 0xff) +
                                         static_cast<int>((b >> s) & 0xff) -
                                         static_cast<int>((c >> s) & 0xff)))
           << s;
  return out;
}
inline uint32_t clamp_half(uint32_t ave, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (ave >> s) & 0xff, b = (c >> s) & 0xff;
    out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

}  // namespace

// ------------------------------------------------------------- SGILog
// libtiff 4.7.1's tif_luv.c decoders (LogL16Decode, LogLuvDecode32,
// LogLuvDecode24) and conversions (LogL16toY, LogLuv32toXYZ,
// LogLuv24toXYZ through uv_decode, XYZtoRGB24, L16toGry).
namespace sgilog {

constexpr double kUvScale = 410.0, kUNeu = 0.210526316, kVNeu = 0.473684211;
constexpr float kUvSqSiz = 0.003500f, kUvVStart = 0.016940f;
constexpr int kUvNvs = 163, kUvNDivs = 16289;

double logl16_to_y(int p16) {
  const int le = p16 & 0x7fff;
  if (!le) return 0.0;
  const double y = std::exp(M_LN2 / 256. * (le + .5) - M_LN2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

double logl10_to_y(int p10) {
  if (p10 == 0) return 0.0;
  return std::exp(M_LN2 / 64. * (p10 + .5) - M_LN2 * 12.);
}

int uv_decode(double* up, double* vp, int c) {
  if (c < 0 || c >= kUvNDivs) return -1;
  int lower = 0, upper = kUvNvs, ui, vi;
  while (upper - lower > 1) {
    vi = (lower + upper) >> 1;
    ui = c - k_uv_row[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  vi = lower;
  ui = c - k_uv_row[vi].ncum;
  *up = k_uv_row[vi].ustart + (ui + .5) * kUvSqSiz;
  *vp = kUvVStart + (vi + .5) * kUvSqSiz;
  return 0;
}

void uv_to_xyz(double L, double u, double v, float* xyz) {
  const double s = 1. / (6. * u - 16. * v + 12.);
  const double x = 9. * u * s, y = 4. * v * s;
  xyz[0] = static_cast<float>(x / y * L);
  xyz[1] = static_cast<float>(L);
  xyz[2] = static_cast<float>((1. - x - y) / y * L);
}

void luv32_to_xyz(uint32_t p, float* xyz) {
  const double L = logl16_to_y(static_cast<int>(p) >> 16);
  if (L <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  uv_to_xyz(L, 1. / kUvScale * ((p >> 8 & 0xff) + .5),
            1. / kUvScale * ((p & 0xff) + .5), xyz);
}

void luv24_to_xyz(uint32_t p, float* xyz) {
  const double L = logl10_to_y(p >> 14 & 0x3ff);
  if (L <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  double u, v;
  if (uv_decode(&u, &v, p & 0x3fff) < 0) {
    u = kUNeu;
    v = kVNeu;
  }
  uv_to_xyz(L, u, v, xyz);
}

inline uint8_t gamma8(double v) {
  return static_cast<uint8_t>(v <= 0. ? 0 : v >= 1. ? 255
                              : static_cast<int>(256. * std::sqrt(v)));
}

void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
  const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma8(r);
  rgb[1] = gamma8(g);
  rgb[2] = gamma8(b);
}

// one row's byte planes, most significant first, each run-length coded
// (a byte ≥ 128: a run of byte − 126 copies of the next; else a count of
// literal bytes); false where the data ends first
bool planes(const uint8_t*& bp, int64_t& cc, int nplanes, int64_t npix,
            uint32_t* tp) {
  std::fill(tp, tp + npix, 0u);
  for (int shft = 8 * (nplanes - 1); shft >= 0; shft -= 8) {
    int64_t i = 0;
    while (i < npix && cc > 0) {
      if (*bp >= 128) {
        if (cc < 2) break;
        int rc = *bp++ + (2 - 128);
        const uint32_t b = static_cast<uint32_t>(*bp++) << shft;
        cc -= 2;
        while (rc-- && i < npix) tp[i++] |= b;
      } else {
        int rc = *bp++;
        while (--cc && rc-- && i < npix)
          tp[i++] |= static_cast<uint32_t>(*bp++) << shft;
      }
    }
    if (i != npix) return false;
  }
  return true;
}

}  // namespace sgilog

// One SGILog chunk of `rows` rows of `cols` pixels, decoded row by row
// as libtiff does. kind 0: LogL (16 bits, two byte planes) → `y` (Y
// float) and `out8` (L16toGry); kind 1: LogLuv32 (four byte planes) and
// kind 2: LogLuv24 (three bytes a pixel) → `y` (X, Y, Z floats) and
// `out8` (XYZtoRGB24). Returns the bytes read, or −(rows decoded + 1)
// where the data ends inside a row.
extern "C" int64_t sgilog_decode(const uint8_t* src, int64_t n, int32_t kind,
                                 int32_t cols, int32_t rows, float* y,
                                 uint8_t* out8) {
  using namespace sgilog;
  const uint8_t* bp = src;
  int64_t cc = n;
  std::vector<uint32_t> tp(cols);
  const int ch = kind == 0 ? 1 : 3;
  for (int r = 0; r < rows; ++r) {
    if (kind == 2) {
      int64_t i = 0;
      for (; i < cols && cc >= 3; ++i, bp += 3, cc -= 3)
        tp[i] = static_cast<uint32_t>(bp[0]) << 16 | bp[1] << 8 | bp[2];
      if (i != cols) return -(r + 1);
    } else if (!planes(bp, cc, kind == 0 ? 2 : 4, cols, tp.data())) {
      return -(r + 1);
    }
    float* fy = y + static_cast<int64_t>(r) * cols * ch;
    uint8_t* o8 = out8 + static_cast<int64_t>(r) * cols * ch;
    for (int i = 0; i < cols; ++i) {
      if (kind == 0) {
        const double Y = logl16_to_y(static_cast<int16_t>(tp[i]));
        fy[i] = static_cast<float>(Y);
        o8[i] = gamma8(Y);
      } else {
        if (kind == 1)
          luv32_to_xyz(tp[i], fy + 3 * i);
        else
          luv24_to_xyz(tp[i], fy + 3 * i);
        xyz_to_rgb24(fy + 3 * i, o8 + 3 * i);
      }
    }
  }
  return n - cc;
}

// ------------------------------------------------ WebP lossless encoding
// A VP8L stream (RFC 9649) of the simple kind: the subtract-green
// transform, the predictor transform with mode 12 (ClampAddSubtractFull)
// over the whole image, no colour cache, runs of a repeated residual as
// backward references to the pixel on the left, one group of canonical
// prefix codes of at most 15 bits (simple codes where a channel uses one
// or two values).
namespace vp8l_enc {

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int bits) {
    acc |= static_cast<uint64_t>(v) << n;
    n += bits;
    while (n >= 8) {
      out.push_back(static_cast<uint8_t>(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void finish() {
    if (n > 0) out.push_back(static_cast<uint8_t>(acc));
    acc = 0;
    n = 0;
  }
};

// Huffman code lengths of `counts`, at most `limit` bits: the counts are
// halved (rounding up) until the tree fits
std::vector<uint8_t> code_lengths(const std::vector<uint32_t>& counts,
                                  int limit) {
  const int n = static_cast<int>(counts.size());
  std::vector<uint64_t> c(counts.begin(), counts.end());
  std::vector<uint8_t> len(n, 0);
  for (;;) {
    std::vector<std::pair<uint64_t, int>> heap;  // (weight, node)
    std::vector<int> parent;
    for (int i = 0; i < n; ++i)
      if (c[i]) {
        heap.push_back({c[i], static_cast<int>(parent.size())});
        parent.push_back(-1);
      }
    std::vector<int> leaf_node(n, -1);
    for (int i = 0, k = 0; i < n; ++i)
      if (c[i]) leaf_node[i] = k++;
    if (heap.size() == 1) {
      for (int i = 0; i < n; ++i) len[i] = c[i] ? 1 : 0;
      return len;
    }
    auto cmp = [](const std::pair<uint64_t, int>& a,
                  const std::pair<uint64_t, int>& b) { return a > b; };
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto a = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto b = heap.back();
      heap.pop_back();
      int node = static_cast<int>(parent.size());
      parent.push_back(-1);
      parent[a.second] = parent[b.second] = node;
      heap.push_back({a.first + b.first, node});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    int deepest = 0;
    for (int i = 0; i < n; ++i) {
      if (leaf_node[i] < 0) continue;
      int d = 0;
      for (int v = leaf_node[i]; parent[v] >= 0; v = parent[v]) ++d;
      len[i] = static_cast<uint8_t>(d);
      deepest = std::max(deepest, d);
    }
    if (deepest <= limit) return len;
    for (auto& v : c)
      if (v) v = (v + 1) / 2;
  }
}

// canonical codes, bit-reversed for the LSB-first writer
std::vector<uint16_t> canonical(const std::vector<uint8_t>& len) {
  int count[16] = {0}, next[16] = {0};
  for (uint8_t l : len)
    if (l) count[l]++;
  for (int l = 1, code = 0; l < 16; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  std::vector<uint16_t> out(len.size(), 0);
  for (size_t s = 0; s < len.size(); ++s) {
    int l = len[s];
    if (!l) continue;
    uint32_t c = next[l]++, r = 0;
    for (int b = 0; b < l; ++b) r |= ((c >> b) & 1) << (l - 1 - b);
    out[s] = static_cast<uint16_t>(r);
  }
  return out;
}

struct Code {
  std::vector<uint8_t> bits;  // 0 for a symbol of a one-symbol code
  std::vector<uint16_t> code;
  void put(BitWriter& bw, int s) const {
    if (bits[s]) bw.put(code[s], bits[s]);
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8,
                                  9, 10, 11, 12, 13, 14, 15};

// writes the prefix code of `counts` and returns it
Code write_code(BitWriter& bw, const std::vector<uint32_t>& counts) {
  const int n = static_cast<int>(counts.size());
  std::vector<int> used;
  for (int s = 0; s < n; ++s)
    if (counts[s]) used.push_back(s);
  Code code;
  code.bits.assign(n, 0);
  code.code.assign(n, 0);
  if (used.size() <= 2 && (used.empty() || used.back() < 256)) {
    int s0 = used.empty() ? 0 : used[0];
    bw.put(1, 1);
    bw.put(used.size() == 2 ? 1 : 0, 1);
    if (s0 < 2) {
      bw.put(0, 1);
      bw.put(s0, 1);
    } else {
      bw.put(1, 1);
      bw.put(s0, 8);
    }
    if (used.size() == 2) {
      bw.put(used[1], 8);
      code.bits[used[0]] = code.bits[used[1]] = 1;
      code.code[used[1]] = 1;
    }
    return code;
  }
  std::vector<uint8_t> len = code_lengths(counts, 15);
  code.bits = len;
  code.code = canonical(len);
  // the lengths as tokens: 0-15 literally, 17 and 18 for runs of zeros
  std::vector<std::pair<int, int>> tokens;  // (symbol, extra bits' value)
  for (int s = 0; s < n;) {
    int run = 1;
    while (s + run < n && len[s + run] == 0 && len[s] == 0) ++run;
    if (len[s] == 0 && run >= 3) {
      run = std::min(run, 138);
      if (run <= 10) tokens.push_back({17, run - 3});
      else tokens.push_back({18, run - 11});
      s += run;
    } else {
      tokens.push_back({len[s], 0});
      ++s;
    }
  }
  std::vector<uint32_t> tcounts(19, 0);
  for (auto& t : tokens) tcounts[t.first]++;
  std::vector<uint8_t> tlen = code_lengths(tcounts, 7);
  std::vector<uint16_t> tcode = canonical(tlen);
  int ntok = 0;  // one kind of token: read in 0 bits
  for (uint32_t t : tcounts) ntok += t != 0;
  int num = 19;
  while (num > 4 && tlen[kCodeLengthOrder[num - 1]] == 0) --num;
  bw.put(0, 1);
  bw.put(num - 4, 4);
  for (int i = 0; i < num; ++i) bw.put(tlen[kCodeLengthOrder[i]], 3);
  bw.put(0, 1);  // max_symbol: the whole alphabet
  for (auto& t : tokens) {
    if (ntok > 1) bw.put(tcode[t.first], tlen[t.first]);
    if (t.first == 17) bw.put(t.second, 3);
    if (t.first == 18) bw.put(t.second, 7);
  }
  return code;
}

// LZ77 prefix coding of a length or distance value (1-4096)
void prefix_of(int v, int& sym, int& nextra, int& extra) {
  if (v < 5) {
    sym = v - 1;
    nextra = extra = 0;
    return;
  }
  int d = v - 1, hb = 0;
  while ((d >> (hb + 1)) != 0) ++hb;
  nextra = hb - 1;
  extra = d & ((1 << nextra) - 1);
  sym = 2 * hb + ((d >> (hb - 1)) & 1);
}

}  // namespace vp8l_enc

// (h, w) RGBA pixels (uint8, R G B A) → a VP8L bitstream (the VP8L
// chunk's payload) with the alpha hint `alpha_used`; → its bytes, or -1
// where `cap` is short.
extern "C" int64_t vp8l_encode(const uint8_t* rgba, int32_t w, int32_t h,
                               int32_t alpha_used, uint8_t* dst,
                               int64_t cap) {
  using namespace vp8l_enc;
  const int64_t npix = static_cast<int64_t>(w) * h;
  // subtract green, then the residuals of mode 12 (the top-left pixel
  // against opaque black, the top row against L, the left column
  // against T)
  std::vector<uint8_t> px(npix * 4), res(npix * 4);  // A R G B
  for (int64_t k = 0; k < npix; ++k) {
    const uint8_t* p = rgba + 4 * k;
    px[4 * k] = p[3];
    px[4 * k + 1] = static_cast<uint8_t>(p[0] - p[1]);
    px[4 * k + 2] = p[1];
    px[4 * k + 3] = static_cast<uint8_t>(p[2] - p[1]);
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int64_t k = static_cast<int64_t>(y) * w + x;
      for (int c = 0; c < 4; ++c) {
        int pred;
        if (x == 0 && y == 0) {
          pred = c == 0 ? 255 : 0;
        } else if (y == 0) {
          pred = px[4 * (k - 1) + c];
        } else if (x == 0) {
          pred = px[4 * (k - w) + c];
        } else {
          pred = px[4 * (k - 1) + c] + px[4 * (k - w) + c]
              - px[4 * (k - w - 1) + c];
          pred = std::min(std::max(pred, 0), 255);
        }
        res[4 * k + c] = static_cast<uint8_t>(px[4 * k + c] - pred);
      }
    }
  BitWriter bw;
  bw.put(0x2F, 8);
  bw.put(w - 1, 14);
  bw.put(h - 1, 14);
  bw.put(alpha_used ? 1 : 0, 1);
  bw.put(0, 3);
  bw.put(1, 1);  // subtract green
  bw.put(2, 2);
  bw.put(1, 1);  // predictor, blocks of 512: every block mode 12
  bw.put(0, 2);
  bw.put(7, 3);
  bw.put(0, 1);  // its sub-image: no colour cache, one-symbol codes
  std::vector<uint32_t> one(256, 0);
  one[12] = 1;
  write_code(bw, one);
  one[12] = 0;
  one[0] = 1;
  for (int i = 0; i < 3; ++i) write_code(bw, one);
  write_code(bw, std::vector<uint32_t>(40, 0));
  bw.put(0, 1);  // no more transforms
  bw.put(0, 1);  // no colour cache
  bw.put(0, 1);  // one group of prefix codes
  // a literal pixel, or (from the second pixel on) a run of 3 to 4096
  // copies of the pixel on the left: distance code 2, (x, y) = (1, 0)
  auto same = [&](int64_t a, int64_t b) {
    return memcmp(&res[4 * a], &res[4 * b], 4) == 0;
  };
  std::vector<std::pair<int64_t, int>> toks;  // (pixel, run length or 0)
  for (int64_t k = 0; k < npix;) {
    int run = 0;
    if (k > 0)
      while (k + run < npix && run < 4096 && same(k + run, k - 1)) ++run;
    if (run >= 3) {
      toks.push_back({k, run});
      k += run;
    } else {
      toks.push_back({k, 0});
      ++k;
    }
  }
  const int kLeft = 2;
  int dsym, dn, dx;
  prefix_of(kLeft, dsym, dn, dx);
  std::vector<uint32_t> hg(280, 0), hr(256, 0), hb(256, 0), ha(256, 0),
      hd(40, 0);
  for (auto& t : toks) {
    const uint8_t* r = &res[4 * t.first];
    if (t.second) {
      int sym, n, extra;
      prefix_of(t.second, sym, n, extra);
      hg[256 + sym]++;
      hd[dsym]++;
    } else {
      ha[r[0]]++;
      hr[r[1]]++;
      hg[r[2]]++;
      hb[r[3]]++;
    }
  }
  Code cg = write_code(bw, hg), cr = write_code(bw, hr),
       cb = write_code(bw, hb), ca = write_code(bw, ha),
       cd = write_code(bw, hd);
  for (auto& t : toks) {
    const uint8_t* r = &res[4 * t.first];
    if (t.second) {
      int sym, n, extra;
      prefix_of(t.second, sym, n, extra);
      cg.put(bw, 256 + sym);
      if (n) bw.put(extra, n);
      cd.put(bw, dsym);
      if (dn) bw.put(dx, dn);
    } else {
      cg.put(bw, r[2]);
      cr.put(bw, r[1]);
      cb.put(bw, r[3]);
      ca.put(bw, r[0]);
    }
  }
  bw.finish();
  if (static_cast<int64_t>(bw.out.size()) > cap) return -1;
  memcpy(dst, bw.out.data(), bw.out.size());
  return static_cast<int64_t>(bw.out.size());
}

// The predictor transform's inverse, in place on (h, w) ARGB residuals,
// with the modes of `bits`-sized tiles in the green of `modes`.
extern "C" int64_t vp8l_unpredict(uint32_t* px, int32_t w, int32_t h,
                                  const uint32_t* modes, int32_t bits) {
  const int tiles = sub_sample(w, bits);
  for (int y = 0; y < h; ++y) {
    uint32_t* row = px + static_cast<int64_t>(y) * w;
    const uint32_t* up = row - w;
    for (int x = 0; x < w; ++x) {
      uint32_t pred;
      if (y == 0) {
        pred = x == 0 ? 0xff000000u : row[x - 1];
      } else if (x == 0) {
        pred = up[0];
      } else {
        uint32_t L = row[x - 1], T = up[x], TL = up[x - 1], TR = up[x + 1];
        int mode = (modes[(y >> bits) * tiles + (x >> bits)] >> 8) & 0xf;
        switch (mode) {
          case 1: pred = L; break;
          case 2: pred = T; break;
          case 3: pred = TR; break;
          case 4: pred = TL; break;
          case 5: pred = average2(average2(L, TR), T); break;
          case 6: pred = average2(L, TL); break;
          case 7: pred = average2(L, T); break;
          case 8: pred = average2(TL, T); break;
          case 9: pred = average2(T, TR); break;
          case 10: pred = average2(average2(L, TL), average2(T, TR)); break;
          case 11: pred = select_pred(T, L, TL); break;
          case 12: pred = clamp_full(L, T, TL); break;
          case 13: pred = clamp_half(average2(L, T), TL); break;
          default: pred = 0xff000000u; break;
        }
      }
      row[x] = add_pixels(row[x], pred);
    }
  }
  return 0;
}

// ------------------------------------ libwebp's lossless analysis
// What libwebp 1.5 (encoder 0x0210, the one in cv2 5) decides, at the
// settings of cv2's WebPEncodeLossless{BGR,BGRA} (quality 70, method 4,
// exact 0), that changes a decoded pixel: WebPReplaceTransparentPixels
// (alpha 0 → 0x00000000), EncoderAnalyze's choice among direct,
// subtract-green, spatial, spatial + subtract-green and palette from
// AnalyzeEntropy's estimates, the predictor transform's tile bits
// (GetHistoBits, GetTransformBits), GetBestPredictorForTile's mode per
// tile on the accumulated residual histograms, and GetResidual's rule
// for pixels of alpha 0: their RGB becomes the prediction, which later
// predictions read. The costs are libwebp's fixed point (log2 scaled by
// 2^23). The cross-colour transform and the entropy coding change no
// pixel and are not analysed.
namespace webp_analysis {

constexpr int kLogBits = 23;  // LOG_2_PRECISION_BITS
constexpr uint64_t kLog2Reciprocal = 12102203;  // 2^23 / ln 2
constexpr int kMaxHuffImageSize = 2600, kMaxPredictorImageSize = 1 << 14;
enum { kDirect, kSpatial, kSubGreen, kSpatialSubGreen, kPalette };

struct Tables {
  uint32_t log2[256];
  uint64_t slog2[256];
  Tables() {
    for (int v = 0; v < 256; ++v) {
      const double l = v ? std::log2(static_cast<double>(v)) : 0.0;
      log2[v] = static_cast<uint32_t>(std::llround(l * (1 << kLogBits)));
      slog2[v] = static_cast<uint64_t>(std::llround(v * l * (1 << kLogBits)));
    }
  }
};
const Tables& tables() {
  static const Tables t;
  return t;
}

inline int log2_floor(uint32_t v) { return 31 - __builtin_clz(v); }

inline int64_t div_round(int64_t a, int64_t b) {
  return ((a < 0) == (b < 0)) ? ((a + b / 2) / b) : ((a - b / 2) / b);
}

// VP8LFastLog2: log2(v) · 2^23
uint32_t fast_log2(uint32_t v) {
  if (v < 256) return tables().log2[v];
  if (v < 65536) {
    const int log_cnt = log2_floor(v) - 7;
    const uint32_t y = 1u << log_cnt;
    uint32_t log_2 = tables().log2[v >> log_cnt] +
                     (static_cast<uint32_t>(log_cnt) << kLogBits);
    if (v >= 4096) {
      const uint64_t correction = kLog2Reciprocal * (v & (y - 1));
      log_2 += static_cast<uint32_t>(div_round(correction, v));
    }
    return log_2;
  }
  return static_cast<uint32_t>(12102203.161561485 * std::log(v) + .5);
}

// VP8LFastSLog2: v · log2(v) · 2^23
uint64_t fast_slog2(uint32_t v) {
  if (v < 256) return tables().slog2[v];
  if (v < 65536) {
    const int log_cnt = log2_floor(v) - 7;
    const uint32_t y = 1u << log_cnt;
    const uint64_t correction = kLog2Reciprocal * (v & (y - 1));
    return static_cast<uint64_t>(v) *
               (tables().log2[v >> log_cnt] +
                (static_cast<uint64_t>(log_cnt) << kLogBits)) +
           correction;
  }
  return static_cast<uint64_t>(12102203.161561485 * v *
                                   std::log(static_cast<double>(v)) + .5);
}

// VP8LBitsEntropy: BitEntropyUnrefined, then BitsEntropyRefine
uint64_t bits_entropy(const uint32_t* a, int n) {
  uint64_t sum = 0, ent = 0;
  uint32_t max_val = 0;
  int nonzeros = 0;
  for (int i = 0; i < n; ++i) {
    if (!a[i]) continue;
    sum += a[i];
    ++nonzeros;
    ent += fast_slog2(a[i]);
    max_val = std::max(max_val, a[i]);
  }
  ent = fast_slog2(static_cast<uint32_t>(sum)) - ent;
  uint64_t mix;
  if (nonzeros < 5) {
    if (nonzeros <= 1) return 0;
    if (nonzeros == 2)
      return div_round(99 * static_cast<int64_t>(sum << kLogBits) +
                           static_cast<int64_t>(ent), 100);
    mix = nonzeros == 3 ? 950 : 700;
  } else {
    mix = 627;
  }
  int64_t min_limit = static_cast<int64_t>((2 * sum - max_val) << kLogBits);
  min_limit = div_round(static_cast<int64_t>(mix) * min_limit +
                            static_cast<int64_t>(1000 - mix) *
                                static_cast<int64_t>(ent), 1000);
  return ent < static_cast<uint64_t>(min_limit)
             ? static_cast<uint64_t>(min_limit) : ent;
}

// VP8LCombinedShannonEntropy(X, Y): the entropy of X + Y less that of Y's
// share, as libwebp estimates it
uint64_t combined_entropy(const uint32_t* X, const uint32_t* Y) {
  uint64_t ret = 0;
  uint32_t sum_x = 0, sum_xy = 0;
  for (int i = 0; i < 256; ++i) {
    const uint32_t x = X[i];
    if (x) {
      const uint32_t xy = x + Y[i];
      sum_x += x;
      ret += fast_slog2(x);
      sum_xy += xy;
      ret += fast_slog2(xy);
    } else if (Y[i]) {
      sum_xy += Y[i];
      ret += fast_slog2(Y[i]);
    }
  }
  return fast_slog2(sum_x) + fast_slog2(sum_xy) - ret;
}

// PredictionCostBias(counts, 1, 94 / 100): small residuals are cheap
int64_t cost_bias(const uint32_t* counts) {
  uint64_t bits = static_cast<uint64_t>(counts[0]) << kLogBits;
  uint64_t exp_val = static_cast<uint64_t>(94) << kLogBits;
  for (int i = 1; i < 16; ++i) {
    bits += div_round(static_cast<int64_t>(exp_val *
                                            (counts[i] + counts[256 - i])),
                      100);
    exp_val = div_round(static_cast<int64_t>(6 * exp_val), 10);
  }
  return -div_round(static_cast<int64_t>(bits), 10);
}

inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
  return ((0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u)) &
          0xff00ff00u) |
         ((0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu)) &
          0x00ff00ffu);
}

inline uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) {
  const uint32_t L = left[0], T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_full(L, T, TL);
    case 13: return clamp_half(average2(L, T), TL);
    default: return 0xff000000u;
  }
}

// GetResidual at exact = 0 without near-lossless: residuals of
// current[x_start, x_end) under `mode`; a pixel of alpha 0 takes its
// prediction's RGB (and the pixel past the row's end, the next row's
// first, follows a change of current[0])
void residuals(int width, uint32_t* upper, uint32_t* current, int mode,
               int x_start, int x_end, int y, uint32_t* out) {
  for (int x = x_start; x < x_end; ++x) {
    uint32_t pred;
    if (y == 0) {
      pred = x == 0 ? 0xff000000u : current[x - 1];
    } else if (x == 0) {
      pred = upper[x];
    } else {
      pred = predict(mode, &current[x - 1], upper + x);
    }
    uint32_t r = sub_pixels(current[x], pred);
    if ((current[x] & 0xff000000u) == 0) {
      r &= 0xff000000u;
      current[x] = pred & 0x00ffffffu;
      if (x == 0 && y != 0) upper[width] = current[0];
    }
    if (out) out[x - x_start] = r;
  }
}

inline void add_histo(uint32_t* h, uint32_t p) {
  ++h[p >> 24];
  ++h[256 + ((p >> 16) & 0xff)];
  ++h[512 + ((p >> 8) & 0xff)];
  ++h[768 + (p & 0xff)];
}

// GetBestPredictorForTile
int best_mode(int width, int height, int tile_x, int tile_y, int bits,
              uint32_t* accumulated, const uint32_t* argb,
              const uint32_t* modes, std::vector<uint32_t>& scratch) {
  const int start_x = tile_x << bits, start_y = tile_y << bits;
  const int tile = 1 << bits;
  const int max_y = std::min(tile, height - start_y);
  const int max_x = std::min(tile, width - start_x);
  const int have_left = start_x > 0;
  const int cx = start_x - have_left;
  const int tiles_per_row = sub_sample(width, bits);
  const int left_mode =
      tile_x > 0 ? (modes[tile_y * tiles_per_row + tile_x - 1] >> 8) & 0xff
                 : 0xff;
  const int above_mode =
      tile_y > 0 ? (modes[(tile_y - 1) * tiles_per_row + tile_x] >> 8) & 0xff
                 : 0xff;
  std::vector<uint32_t> h1(1024), h2(1024), res(tile);
  uint32_t* histo = h1.data();
  uint32_t* best_histo = h2.data();
  int64_t best_cost = INT64_MAX;
  int best = 0;
  for (int mode = 0; mode < 14; ++mode) {
    uint32_t* upper = scratch.data();
    uint32_t* current = upper + width + 1;
    std::fill(histo, histo + 1024, 0u);
    if (start_y > 0)
      memcpy(current + cx, argb + static_cast<int64_t>(start_y - 1) * width + cx,
             4 * (max_x + have_left + 1));
    for (int ry = 0; ry < max_y; ++ry) {
      const int y = start_y + ry;
      std::swap(upper, current);
      memcpy(current + cx, argb + static_cast<int64_t>(y) * width + cx,
             4 * (max_x + have_left + (y + 1 < height)));
      residuals(width, upper, current, mode, start_x, start_x + max_x, y,
                res.data());
      for (int rx = 0; rx < max_x; ++rx) add_histo(histo, res[rx]);
    }
    int64_t cost = 0;
    for (int c = 0; c < 4; ++c) {
      cost += cost_bias(histo + 256 * c);
      cost += static_cast<int64_t>(
          combined_entropy(histo + 256 * c, accumulated + 256 * c));
    }
    const int64_t bias = static_cast<int64_t>(15) << kLogBits;
    if (mode == left_mode) cost -= bias;
    if (mode == above_mode) cost -= bias;
    if (cost < best_cost) {
      std::swap(histo, best_histo);
      best_cost = cost;
      best = mode;
    }
  }
  for (int i = 0; i < 1024; ++i) accumulated[i] += best_histo[i];
  return best;
}

inline uint32_t hash_pix(uint32_t pix) {
  return static_cast<uint32_t>(
             ((static_cast<uint64_t>(pix) + (pix >> 19)) * 0x39c5fba7ull) &
             0xffffffffu) >> 24;
}

// AnalyzeEntropy: the transform set of least estimated entropy
int analyze_entropy(const uint32_t* argb, int width, int height,
                    bool use_palette, int palette_size, int transform_bits,
                    int* red_and_blue_always_zero) {
  if (use_palette && palette_size <= 16) {
    *red_and_blue_always_zero = 1;
    return kPalette;
  }
  enum { A, AP, G, GP, R, RP, B, BP, RSG, RPSG, BSG, BPSG, PAL, TOTAL };
  std::vector<uint32_t> histo(TOTAL * 256, 0);
  auto add = [&](uint32_t p, int a, int r, int g, int b) {
    ++histo[a * 256 + (p >> 24)];
    ++histo[r * 256 + ((p >> 16) & 0xff)];
    ++histo[g * 256 + ((p >> 8) & 0xff)];
    ++histo[b * 256 + (p & 0xff)];
  };
  auto add_sg = [&](uint32_t p, int r, int b) {
    const int green = static_cast<int>(p >> 8);
    ++histo[r * 256 + ((static_cast<int>(p >> 16) - green) & 0xff)];
    ++histo[b * 256 + ((static_cast<int>(p) - green) & 0xff)];
  };
  const uint32_t* prev_row = nullptr;
  uint32_t pix_prev = argb[0];
  for (int y = 0; y < height; ++y) {
    const uint32_t* row = argb + static_cast<int64_t>(y) * width;
    for (int x = 0; x < width; ++x) {
      const uint32_t pix = row[x];
      const uint32_t diff = sub_pixels(pix, pix_prev);
      pix_prev = pix;
      if (diff == 0 || (prev_row && pix == prev_row[x])) continue;
      add(pix, A, R, G, B);
      add(diff, AP, RP, GP, BP);
      add_sg(pix, RSG, BSG);
      add_sg(diff, RPSG, BPSG);
      ++histo[PAL * 256 + hash_pix(pix)];
    }
    prev_row = row;
  }
  for (int k : {RPSG, BPSG, RP, GP, BP, AP}) ++histo[k * 256];
  uint64_t comp[TOTAL];
  for (int j = 0; j < TOTAL; ++j) comp[j] = bits_entropy(&histo[j * 256], 256);
  uint64_t entropy[5];
  entropy[kDirect] = comp[A] + comp[R] + comp[G] + comp[B];
  entropy[kSpatial] = comp[AP] + comp[RP] + comp[GP] + comp[BP];
  entropy[kSubGreen] = comp[A] + comp[RSG] + comp[G] + comp[BSG];
  entropy[kSpatialSubGreen] = comp[AP] + comp[RPSG] + comp[GP] + comp[BPSG];
  entropy[kPalette] = comp[PAL];
  const uint64_t tiles = static_cast<uint64_t>(sub_sample(width, transform_bits)) *
                         sub_sample(height, transform_bits);
  entropy[kSpatial] += tiles * fast_log2(14);
  entropy[kSpatialSubGreen] += tiles * fast_log2(24);
  entropy[kPalette] += (static_cast<uint64_t>(palette_size) * 8) << kLogBits;
  const int last = use_palette ? kPalette : kSpatialSubGreen;
  int best = kDirect;
  for (int k = kDirect + 1; k <= last; ++k)
    if (entropy[best] > entropy[k]) best = k;
  static const int pairs[5][2] = {{R, B}, {RP, BP}, {RSG, BSG}, {RPSG, BPSG},
                                  {R, B}};
  *red_and_blue_always_zero = 1;
  for (int i = 1; i < 256; ++i)
    if (histo[pairs[best][0] * 256 + i] | histo[pairs[best][1] * 256 + i]) {
      *red_and_blue_always_zero = 0;
      break;
    }
  return best;
}

int clamp_bits(int width, int height, int bits, int min_bits, int max_bits,
               int size_max) {
  bits = std::min(std::max(bits, min_bits), max_bits);
  int size = sub_sample(width, bits) * sub_sample(height, bits);
  while (bits < max_bits && size > size_max) {
    ++bits;
    size = sub_sample(width, bits) * sub_sample(height, bits);
  }
  while (bits > min_bits && size == 1) {
    size = sub_sample(width, bits - 1) * sub_sample(height, bits - 1);
    if (size != 1) break;
    --bits;
  }
  return bits;
}

}  // namespace webp_analysis

// libwebp's lossless analysis of (h, w) RGBA (see webp_analysis): `out`
// gets the RGBA a decoder of libwebp's file returns (alpha-0 pixels as
// libwebp leaves them), `modes` the predictor's mode per tile (raster
// order) where a spatial transform set was chosen, and info = {transform
// set (0 direct, 1 spatial, 2 subtract-green, 3 spatial + subtract-green,
// 4 palette), palette size (257: more than 256 colours), predictor tile
// bits, tiles across, tiles down}. Returns the number of tiles.
extern "C" int64_t vp8l_analyze(const uint8_t* rgba, int32_t w, int32_t h,
                                int32_t* info, uint32_t* modes,
                                uint8_t* out) {
  using namespace webp_analysis;
  const int64_t n = static_cast<int64_t>(w) * h;
  std::vector<uint32_t> argb(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = rgba + 4 * i;
    argb[i] = p[3] ? (static_cast<uint32_t>(p[3]) << 24) |
                         (static_cast<uint32_t>(p[0]) << 16) |
                         (static_cast<uint32_t>(p[1]) << 8) | p[2]
                   : 0u;
  }
  std::vector<uint32_t> colours(argb.begin(), argb.begin() + n);
  std::sort(colours.begin(), colours.end());
  const int palette_size = static_cast<int>(std::min<int64_t>(
      257, std::unique(colours.begin(), colours.end()) - colours.begin()));
  const bool use_palette = palette_size <= 256;
  int histo_bits = (use_palette ? 9 : 7) - 4;
  while (sub_sample(w, histo_bits) * sub_sample(h, histo_bits) >
         kMaxHuffImageSize)
    ++histo_bits;
  histo_bits = std::min(std::max(histo_bits, 2), 9);
  const int transform_bits = std::min(histo_bits, 5);
  int rb_zero = 0;
  const int set = analyze_entropy(argb.data(), w, h, use_palette,
                                  palette_size, transform_bits, &rb_zero);
  const int bits = clamp_bits(w, h, transform_bits, 2, 9,
                              kMaxPredictorImageSize);
  const int tw = sub_sample(w, bits), th = sub_sample(h, bits);
  info[0] = set;
  info[1] = palette_size;
  info[2] = bits;
  info[3] = tw;
  info[4] = th;
  const bool sub_green = set == kSpatialSubGreen;
  if (set == kSpatial || set == kSpatialSubGreen) {
    if (sub_green)
      for (int64_t i = 0; i < n; ++i) {
        const uint32_t g = (argb[i] >> 8) & 0xff;
        const uint32_t r = (((argb[i] >> 16) & 0xff) - g) & 0xff;
        const uint32_t b = ((argb[i] & 0xff) - g) & 0xff;
        argb[i] = (argb[i] & 0xff00ff00u) | (r << 16) | b;
      }
    std::vector<uint32_t> accumulated(1024, 0), scratch(2 * (w + 1) + 2, 0);
    for (int ty = 0; ty < th; ++ty)
      for (int tx = 0; tx < tw; ++tx)
        modes[ty * tw + tx] = 0xff000000u |
            (static_cast<uint32_t>(best_mode(w, h, tx, ty, bits,
                                             accumulated.data(), argb.data(),
                                             modes, scratch)) << 8);
    // CopyImageWithPrediction: the pass that writes the residuals, whose
    // rows of cleaned pixels are what a decoder rebuilds
    std::vector<uint32_t> rows(2 * (w + 1), 0), done(n);
    uint32_t* upper = rows.data();
    uint32_t* current = upper + w + 1;
    for (int y = 0; y < h; ++y) {
      std::swap(upper, current);
      memcpy(current, argb.data() + static_cast<int64_t>(y) * w,
             4 * (w + (y + 1 < h)));
      for (int x = 0; x < w;) {
        const int mode = (modes[(y >> bits) * tw + (x >> bits)] >> 8) & 0xff;
        const int x_end = std::min(x + (1 << bits), static_cast<int>(w));
        residuals(w, upper, current, mode, x, x_end, y, nullptr);
        x = x_end;
      }
      memcpy(done.data() + static_cast<int64_t>(y) * w, current, 4 * w);
    }
    for (int64_t i = 0; i < n; ++i) argb[i] = done[i];
    if (sub_green)
      for (int64_t i = 0; i < n; ++i) {
        const uint32_t g = (argb[i] >> 8) & 0xff;
        const uint32_t r = (((argb[i] >> 16) & 0xff) + g) & 0xff;
        const uint32_t b = ((argb[i] & 0xff) + g) & 0xff;
        argb[i] = (argb[i] & 0xff00ff00u) | (r << 16) | b;
      }
  }
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* p = out + 4 * i;
    p[0] = (argb[i] >> 16) & 0xff;
    p[1] = (argb[i] >> 8) & 0xff;
    p[2] = argb[i] & 0xff;
    p[3] = argb[i] >> 24;
  }
  return static_cast<int64_t>(tw) * th;
}

// The ALPH chunk's gradient filter, undone in place on (h, w) bytes.
extern "C" int64_t alpha_ungradient(uint8_t* a, int32_t w, int32_t h) {
  for (int x = 1; x < w; ++x) a[x] = static_cast<uint8_t>(a[x] + a[x - 1]);
  for (int y = 1; y < h; ++y) {
    uint8_t* row = a + static_cast<int64_t>(y) * w;
    const uint8_t* prev = row - w;
    int left = prev[0], top_left = prev[0];
    for (int x = 0; x < w; ++x) {
      int top = prev[x];
      left = static_cast<uint8_t>(row[x] + clip255(left + top - top_left));
      top_left = top;
      row[x] = static_cast<uint8_t>(left);
    }
  }
  return 0;
}

namespace {

// RFC 6386 tables 13.5 (default token probabilities), 13.4 (their update
// probabilities) and 11.5 (key-frame subblock mode probabilities, indexed
// [above][left] in libwebp's mode order: DC, TM, VE, HE, RD, VR, LD, VL,
// HD, HU)
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148,
    151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146,
    149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254,
    259, 264, 269, 274, 279, 284};
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5,
                                  -4, -5, -6, 7, -7, 8, -8, -9};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
                            0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// RFC 6386's boolean decoder. `eof` is set when a decision needs bits past
// the end of the partition, where libwebp's reader sets its own.
struct BoolDec {
  const uint8_t* p = nullptr;
  int64_t n = 0, pos = 0, shifts = 0;
  uint32_t value = 0;
  uint32_t range = 255;
  int bit_count = 0;
  bool eof = false;
  void init(const uint8_t* data, int64_t size) {
    p = data;
    n = size;
    pos = 0;
    value = (static_cast<uint32_t>(next()) << 8) | next();
  }
  uint8_t next() { return pos < n ? p[pos++] : (++pos, 0); }
  int get(int prob) {
    if (shifts > 8 * (n - 1)) eof = true;
    uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      ++shifts;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  int value_bits(int bits) {
    int v = 0;
    while (bits-- > 0) v |= get(0x80) << bits;
    return v;
  }
  int signed_value(int bits) {
    int v = value_bits(bits);
    return get(0x80) ? -v : v;
  }
};

inline int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

int large_value(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    int bit1 = br.get(p[8]);
    int bit0 = br.get(p[9 + bit1]);
    int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
      v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// GetCoeffs: the tokens of one 4x4 block from coefficient `n`, dequantized
// into `out` (raster order); → the index after the last one read.
int block_coeffs(BoolDec& br, const uint8_t (*prob)[3][11], int ctx,
                 const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = prob[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const uint8_t(*next)[11] = prob[kBands[n + 1]];
    if (!br.get(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    int s = br.get(0x80) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
  }
  return 16;
}

}  // namespace

// A VP8 key frame (the payload of a VP8 chunk): headers, intra modes and
// dequantized coefficients. `info` (int32, 64): [0] width, [1] height,
// [2] macroblock columns, [3] rows, [4] filter type (0 none, 1 simple, 2
// normal), then from [8] per segment s and inner flag i at 8 + 6s + 3i:
// limit, interior limit, hev threshold (libwebp's precomputed filter
// strengths). `mb` (uint8, 20 per macroblock): is_i4x4, uv mode,
// segment, has coefficients, the 16 subblock modes (or the 16x16 mode).
// `coeffs` (int16, 400 per macroblock): 16 Y, 4 U, 4 V blocks and the Y2
// block, 16 each. "has coefficients" leaves out the Y2 block, whose
// inverse WHT decides it for a 16x16 macroblock (libwebp's skip test).
// → 0, or -1 (bad header), -2 (data ends early), -3 (not
// a key frame or not shown).
extern "C" int64_t vp8_parse(const uint8_t* src, int64_t n, int32_t* info,
                             uint8_t* mb, int16_t* coeffs, int64_t max_mb) {
  if (n < 10) return -2;
  uint32_t bits = src[0] | (src[1] << 8) | (src[2] << 16);
  bool key = !(bits & 1);
  int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  int64_t part0 = bits >> 5;
  if (!key || profile > 3 || !show) return -3;
  if (src[3] != 0x9d || src[4] != 0x01 || src[5] != 0x2a) return -1;
  int w = (src[6] | (src[7] << 8)) & 0x3fff;
  int h = (src[8] | (src[9] << 8)) & 0x3fff;
  const int mbw = (w + 15) >> 4, mbh = (h + 15) >> 4;
  if (w == 0 || h == 0 || static_cast<int64_t>(mbw) * mbh > max_mb)
    return -1;
  const uint8_t* buf = src + 10;
  int64_t left = n - 10;
  if (part0 > left) return -2;
  BoolDec br;
  br.init(buf, part0);
  buf += part0;
  left -= part0;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type
  // segment header
  int use_segment = br.value_bits(1), update_map = 0, absolute = 1;
  int quant[4] = {0}, fstrength[4] = {0};
  int seg_proba[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.value_bits(1);
    if (br.value_bits(1)) {
      absolute = br.value_bits(1);
      for (int s = 0; s < 4; ++s)
        quant[s] = br.value_bits(1) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        fstrength[s] = br.value_bits(1) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        seg_proba[s] = br.value_bits(1) ? br.value_bits(8) : 255;
  }
  // filter header
  int simple = br.value_bits(1), level = br.value_bits(6);
  int sharpness = br.value_bits(3), use_lf_delta = br.value_bits(1);
  int ref_lf_delta0 = 0, mode_lf_delta0 = 0;
  if (use_lf_delta && br.value_bits(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) {
        int v = br.signed_value(6);
        if (i == 0) ref_lf_delta0 = v;
      }
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) {
        int v = br.signed_value(6);
        if (i == 0) mode_lf_delta0 = v;
      }
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return -2;
  // partitions
  const int nparts = 1 << br.value_bits(2);
  if (left < 3 * (nparts - 1)) return -2;
  BoolDec parts[8];
  {
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * (nparts - 1);
    int64_t size_left = left - 3 * (nparts - 1);
    for (int p = 0; p < nparts - 1; ++p) {
      int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(start, psize);
      start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[nparts - 1].init(start, size_left);
    if (start >= buf + left) return -2;
  }
  // quantizers
  int dqm[4][6];
  {
    const int base = br.value_bits(7);
    int d[5];
    for (int i = 0; i < 5; ++i)
      d[i] = br.value_bits(1) ? br.signed_value(4) : 0;
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = quant[s] + (absolute ? 0 : base);
      } else {
        if (s > 0) {
          std::memcpy(dqm[s], dqm[0], sizeof(dqm[0]));
          continue;
        }
        q = base;
      }
      int* m = dqm[s];
      m[0] = kDcTable[clip_q(q + d[0], 127)];
      m[1] = kAcTable[clip_q(q, 127)];
      m[2] = kDcTable[clip_q(q + d[1], 127)] * 2;
      m[3] = (kAcTable[clip_q(q + d[2], 127)] * 101581) >> 16;
      if (m[3] < 8) m[3] = 8;
      m[4] = kDcTable[clip_q(q + d[3], 117)];
      m[5] = kAcTable[clip_q(q + d[4], 127)];
    }
  }
  br.value_bits(1);  // update_proba, ignored for key frames
  uint8_t proba[4][8][3][11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          int i = ((t * 8 + b) * 3 + c) * 11 + p;
          proba[t][b][c][p] = static_cast<uint8_t>(
              br.get(kCoeffsUpdateProba[i]) ? br.value_bits(8)
                                            : kCoeffsProba0[i]);
        }
  const int use_skip = br.value_bits(1);
  const int skip_p = use_skip ? br.value_bits(8) : 0;
  if (br.eof) return -2;
  // filter strengths (PrecomputeFilterStrengths)
  info[0] = w;
  info[1] = h;
  info[2] = mbw;
  info[3] = mbh;
  info[4] = filter_type;
  for (int s = 0; s < 4; ++s) {
    int base_level = use_segment
        ? fstrength[s] + (absolute ? 0 : level) : level;
    for (int i4 = 0; i4 <= 1; ++i4) {
      int lv = base_level;
      if (use_lf_delta) {
        lv += ref_lf_delta0;
        if (i4) lv += mode_lf_delta0;
      }
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      int32_t* f = info + 8 + 6 * s + 3 * i4;
      if (lv > 0) {
        int ilevel = lv;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        f[0] = 2 * lv + ilevel;
        f[1] = ilevel;
        f[2] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      } else {
        f[0] = f[1] = f[2] = 0;
      }
    }
  }
  // macroblocks
  std::vector<uint8_t> intra_t(static_cast<size_t>(4 * mbw), 0);
  std::vector<uint8_t> nz_top(static_cast<size_t>(mbw), 0);
  std::vector<uint8_t> nzdc_top(static_cast<size_t>(mbw), 0);
  std::memset(coeffs, 0, sizeof(int16_t) * 400 * mbw * mbh);
  for (int y = 0; y < mbh; ++y) {
    uint8_t intra_l[4] = {0, 0, 0, 0};
    uint8_t nz_left = 0, nzdc_left = 0;
    BoolDec& tok = parts[y & (nparts - 1)];
    for (int x = 0; x < mbw; ++x) {
      uint8_t* m = mb + 20 * (static_cast<int64_t>(y) * mbw + x);
      int16_t* c = coeffs + 400 * (static_cast<int64_t>(y) * mbw + x);
      int segment = update_map
          ? (!br.get(seg_proba[0]) ? br.get(seg_proba[1])
                                   : br.get(seg_proba[2]) + 2)
          : 0;
      int skip = use_skip ? br.get(skip_p) : 0;
      int is_i4 = !br.get(145);
      uint8_t* top = intra_t.data() + 4 * x;
      if (!is_i4) {
        int ymode = br.get(156) ? (br.get(128) ? 1 : 3)
                                : (br.get(163) ? 2 : 0);
        std::memset(m + 4, ymode, 16);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        for (int yy = 0; yy < 4; ++yy) {
          int ymode = intra_l[yy];
          for (int xx = 0; xx < 4; ++xx) {
            const uint8_t* prob = kBModesProba + (top[xx] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
            ymode = -i;
            top[xx] = static_cast<uint8_t>(ymode);
            m[4 + yy * 4 + xx] = static_cast<uint8_t>(ymode);
          }
          intra_l[yy] = static_cast<uint8_t>(ymode);
        }
      }
      int uvmode = !br.get(142) ? 0 : !br.get(114) ? 2 : br.get(183) ? 1 : 3;
      m[0] = static_cast<uint8_t>(is_i4);
      m[1] = static_cast<uint8_t>(uvmode);
      m[2] = static_cast<uint8_t>(segment);
      // residuals (ParseResiduals)
      const int* q = dqm[segment];
      bool any = false;
      if (!skip) {
        int first;
        const uint8_t(*ac)[3][11];
        if (!is_i4) {
          int ctx = nzdc_top[x] + nzdc_left;
          int nz = block_coeffs(tok, proba[1], ctx, q + 2, 0, c + 384);
          nzdc_top[x] = nzdc_left = nz > 0;
          first = 1;
          ac = proba[0];
        } else {
          first = 0;
          ac = proba[3];
        }
        uint8_t tnz = nz_top[x] & 0x0f, lnz = nz_left & 0x0f;
        for (int yy = 0; yy < 4; ++yy) {
          int l = lnz & 1;
          for (int xx = 0; xx < 4; ++xx) {
            int ctx = l + (tnz & 1);
            int16_t* blk = c + 16 * (yy * 4 + xx);
            int nz = block_coeffs(tok, ac, ctx, q, first, blk);
            l = nz > first;
            tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
            any |= nz > first;
          }
          tnz >>= 4;
          lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t t = nz_top[x] >> (4 + ch), ll = nz_left >> (4 + ch);
          for (int yy = 0; yy < 2; ++yy) {
            int l = ll & 1;
            for (int xx = 0; xx < 2; ++xx) {
              int ctx = l + (t & 1);
              int16_t* blk = c + 256 + 16 * (2 * ch + yy * 2 + xx);
              int nz = block_coeffs(tok, proba[2], ctx, q + 4, 0, blk);
              l = nz > 0;
              t = (t >> 1) | (l << 3);
              any |= nz > 0;
            }
            t >>= 2;
            ll = (ll >> 1) | (l << 5);
          }
          out_t |= (t << 4) << ch;
          out_l |= (ll & 0xf0) << ch;
        }
        nz_top[x] = static_cast<uint8_t>(out_t);
        nz_left = static_cast<uint8_t>(out_l);
      } else {
        nz_top[x] = nz_left = 0;
        if (!is_i4) nzdc_top[x] = nzdc_left = 0;
      }
      m[3] = static_cast<uint8_t>(any);
      if (tok.eof) return -2;
    }
    if (br.eof) return -2;
  }
  return 0;
}

namespace {

constexpr int BPS = 32;  // libwebp's work-buffer stride

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}
inline uint8_t avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) {
  return static_cast<uint8_t>((a + b + 1) >> 1);
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x)
      dst[y * BPS + x] = clip8(top[x] + dst[y * BPS - 1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 luma and 8x8 chroma: DC (with libwebp's edge variants), TM, V, H
void predict_block(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
  const int shift = size == 16 ? 5 : 4;
  if (mode == 0) {
    int dc = 0;
    if (mb_x > 0 && mb_y > 0) {
      for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, size, (dc + size) >> shift);
    } else if (mb_y > 0) {  // no left
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, size, (dc + size / 2) >> (shift - 1));
    } else if (mb_x > 0) {  // no top
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
      fill(dst, size, (dc + size / 2) >> (shift - 1));
    } else {
      fill(dst, size, 0x80);
    }
  } else if (mode == 1) {
    true_motion(dst, size);
  } else if (mode == 2) {
    for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
  } else {
    for (int y = 0; y < size; ++y)
      std::memset(dst + y * BPS, dst[y * BPS - 1], size);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = top[-1], A = top[0], B = top[1],
            C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  switch (mode) {
    case 0: {  // DC
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case 1: true_motion(dst, 4); break;
    case 2: {  // VE
      uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                      avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
      break;
    }
    case 3: {  // HE
      uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                      avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, v[y], 4);
      break;
    }
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = static_cast<uint8_t>(L);
      break;
  }
}
#undef DST

// one 4x4 block of residuals added and clipped (TransformOne's STORE)
void add_residual(uint8_t* dst, const int16_t* r) {
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      dst[y * BPS + x] = clip8(dst[y * BPS + x] + r[y * 4 + x]);
}

// ---- loop filters (dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t ||
         std::abs(p[step] - p[0]) > t;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <=
         t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
            q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `hstride` across the edge, `vstride` along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                  int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t))
        do_filter2(p, hstride);
      else if (mb_edge)
        do_filter6(p, hstride);
      else
        do_filter4(p, hstride);
    }
}

}  // namespace

// Reconstruct a parsed VP8 key frame into its planes (Y of mbh*16 rows of
// mbw*16, U and V of mbh*8 rows of mbw*8): each macroblock predicted from
// its unfiltered neighbours with libwebp's borders (127 above the frame,
// 129 left of it), `resid` (int16, 384 per macroblock: the inverse
// transforms' outputs) added, and then the loop filter over the frame in
// macroblock order (DoFilter). `mb` and `info` as vp8_parse gives them.
extern "C" int64_t vp8_reconstruct(const int32_t* info, const uint8_t* mb,
                                   const int16_t* resid, uint8_t* Y,
                                   uint8_t* U, uint8_t* V) {
  const int mbw = info[2], mbh = info[3], ftype = info[4];
  const int ys = mbw * 16, uvs = mbw * 8;
  static const int kScan[16] = {0, 4, 8, 12, 4 * BPS, 4 + 4 * BPS,
                                8 + 4 * BPS, 12 + 4 * BPS, 8 * BPS,
                                4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                                12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS,
                                12 + 12 * BPS};
  uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
  for (int my = 0; my < mbh; ++my) {
    for (int mx = 0; mx < mbw; ++mx) {
      const uint8_t* m = mb + 20 * (static_cast<int64_t>(my) * mbw + mx);
      const int16_t* r = resid + 384 * (static_cast<int64_t>(my) * mbw + mx);
      uint8_t* yd = ybuf + BPS + 8;  // room for the left and top borders
      uint8_t* ud = ubuf + BPS + 8;
      uint8_t* vd = vbuf + BPS + 8;
      uint8_t* y0 = Y + static_cast<int64_t>(my) * 16 * ys + mx * 16;
      uint8_t* u0 = U + static_cast<int64_t>(my) * 8 * uvs + mx * 8;
      uint8_t* v0 = V + static_cast<int64_t>(my) * 8 * uvs + mx * 8;
      // top row (with the top-left corner and four top-right samples)
      if (my == 0) {
        std::memset(yd - BPS - 1, 127, 21);
        std::memset(ud - BPS - 1, 127, 9);
        std::memset(vd - BPS - 1, 127, 9);
      } else {
        std::memcpy(yd - BPS, y0 - ys, 16);
        std::memcpy(ud - BPS, u0 - uvs, 8);
        std::memcpy(vd - BPS, v0 - uvs, 8);
        yd[-BPS - 1] = mx > 0 ? y0[-ys - 1] : 129;
        ud[-BPS - 1] = mx > 0 ? u0[-uvs - 1] : 129;
        vd[-BPS - 1] = mx > 0 ? v0[-uvs - 1] : 129;
        if (mx < mbw - 1)
          std::memcpy(yd - BPS + 16, y0 - ys + 16, 4);
        else
          std::memset(yd - BPS + 16, y0[-ys + 15], 4);
      }
      for (int j = 0; j < 16; ++j)
        yd[j * BPS - 1] = mx > 0 ? y0[j * ys - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        ud[j * BPS - 1] = mx > 0 ? u0[j * uvs - 1] : 129;
        vd[j * BPS - 1] = mx > 0 ? v0[j * uvs - 1] : 129;
      }
      if (m[0]) {  // 4x4 subblocks
        for (int k = 4; k < 16; k += 4)
          std::memcpy(yd - BPS + 16 + k * BPS, yd - BPS + 16, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = yd + kScan[n];
          predict4(dst, m[4 + n]);
          add_residual(dst, r + 16 * n);
        }
      } else {
        predict_block(yd, 16, m[4], mx, my);
        for (int n = 0; n < 16; ++n)
          add_residual(yd + kScan[n], r + 16 * n);
      }
      predict_block(ud, 8, m[1], mx, my);
      predict_block(vd, 8, m[1], mx, my);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        add_residual(ud + off, r + 256 + 16 * n);
        add_residual(vd + off, r + 320 + 16 * n);
      }
      for (int j = 0; j < 16; ++j) std::memcpy(y0 + j * ys, yd + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(u0 + j * uvs, ud + j * BPS, 8);
        std::memcpy(v0 + j * uvs, vd + j * BPS, 8);
      }
    }
  }
  if (ftype == 0) return 0;
  for (int my = 0; my < mbh; ++my) {
    for (int mx = 0; mx < mbw; ++mx) {
      const uint8_t* m = mb + 20 * (static_cast<int64_t>(my) * mbw + mx);
      const int32_t* f = info + 8 + 6 * m[2] + 3 * m[0];
      const int limit = f[0], ilevel = f[1], hev_t = f[2];
      const bool inner = m[0] || m[3];
      if (limit == 0) continue;
      uint8_t* yp = Y + static_cast<int64_t>(my) * 16 * ys + mx * 16;
      if (ftype == 1) {
        if (mx > 0) simple_edge(yp, 1, ys, limit + 4);
        if (inner)
          for (int k = 4; k < 16; k += 4) simple_edge(yp + k, 1, ys, limit);
        if (my > 0) simple_edge(yp, ys, 1, limit + 4);
        if (inner)
          for (int k = 4; k < 16; k += 4)
            simple_edge(yp + k * ys, ys, 1, limit);
        continue;
      }
      uint8_t* up = U + static_cast<int64_t>(my) * 8 * uvs + mx * 8;
      uint8_t* vp = V + static_cast<int64_t>(my) * 8 * uvs + mx * 8;
      if (mx > 0) {
        complex_edge(yp, 1, ys, 16, limit + 4, ilevel, hev_t, true);
        complex_edge(up, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
        complex_edge(vp, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4)
          complex_edge(yp + k, 1, ys, 16, limit, ilevel, hev_t, false);
        complex_edge(up + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
        complex_edge(vp + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
      }
      if (my > 0) {
        complex_edge(yp, ys, 1, 16, limit + 4, ilevel, hev_t, true);
        complex_edge(up, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
        complex_edge(vp, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4)
          complex_edge(yp + k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
        complex_edge(up + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
        complex_edge(vp + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------- CCITT fax
// libtiff 4.7's tif_fax3.c decoders, state machine for state machine: the
// bit accumulator (bytes enter LSB first, through the fill order's bit
// map), the run arrays (alternating white and black, the reference line
// ending in an imaginary 0), `EXPAND1D`, `EXPAND2D`, `SYNC_EOL` and the
// RLE/RLEW row alignments. Where libtiff logs an error and recovers
// (a bad code word, a line of the wrong length, uncompressed mode, data
// that ends early) this returns a negative code instead.
namespace fax {

enum State : uint8_t { kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW,
                       kTermB, kMakeUpW, kMakeUpB, kMakeUp, kEol };
struct Ent { uint8_t state = kNull, width = 0; uint16_t param = 0; };
struct Tables { Ent main[1 << 7], white[1 << 12], black[1 << 13]; };

// ITU-T T.4 tables 2 and 3: terminating codes 0-63, then make-up codes
const char* const kWhiteTerm[64] = {
  "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
  "10011", "10100", "00111", "01000", "001000", "000011", "110100",
  "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
  "0000011", "0000100", "0101000", "0101011", "0010011", "0100100",
  "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
  "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
  "00101001", "00101010", "00101011", "00101100", "00101101", "00000100",
  "00000101", "00001010", "00001011", "01010010", "01010011", "01010100",
  "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
  "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* const kWhiteMakeUp[27] = {  // 64, 128, ..., 1728
  "11011", "10010", "010111", "0110111", "00110110", "00110111",
  "01100100", "01100101", "01101000", "01100111", "011001100", "011001101",
  "011010010", "011010011", "011010100", "011010101", "011010110",
  "011010111", "011011000", "011011001", "011011010", "011011011",
  "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kBlackTerm[64] = {
  "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
  "000101", "000100", "0000100", "0000101", "0000111", "00000100",
  "00000111", "000011000", "0000010111", "0000011000", "0000001000",
  "00001100111", "00001101000", "00001101100", "00000110111",
  "00000101000", "00000010111", "00000011000", "000011001010",
  "000011001011", "000011001100", "000011001101", "000001101000",
  "000001101001", "000001101010", "000001101011", "000011010010",
  "000011010011", "000011010100", "000011010101", "000011010110",
  "000011010111", "000001101100", "000001101101", "000011011010",
  "000011011011", "000001010100", "000001010101", "000001010110",
  "000001010111", "000001100100", "000001100101", "000001010010",
  "000001010011", "000000100100", "000000110111", "000000111000",
  "000000100111", "000000101000", "000001011000", "000001011001",
  "000000101011", "000000101100", "000001011010", "000001100110",
  "000001100111"};
const char* const kBlackMakeUp[27] = {
  "0000001111", "000011001000", "000011001001", "000001011011",
  "000000110011", "000000110100", "000000110101", "0000001101100",
  "0000001101101", "0000001001010", "0000001001011", "0000001001100",
  "0000001001101", "0000001110010", "0000001110011", "0000001110100",
  "0000001110101", "0000001110110", "0000001110111", "0000001010010",
  "0000001010011", "0000001010100", "0000001010101", "0000001011010",
  "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtMakeUp[13] = {  // 1792, 1856, ..., 2560, both colours
  "00000001000", "00000001100", "00000001101", "000000010010",
  "000000010011", "000000010100", "000000010101", "000000010110",
  "000000010111", "000000011100", "000000011101", "000000011110",
  "000000011111"};
const char* const kEolCode = "000000000001";

// a code, first bit first, at every index of a table read LSB first
void put(Ent* tab, int wid, const char* bits, uint8_t state, int param) {
  int len = static_cast<int>(strlen(bits));
  uint32_t rev = 0;
  for (int i = 0; i < len; ++i)
    if (bits[i] == '1') rev |= 1u << i;
  for (uint32_t hi = 0; hi < (1u << (wid - len)); ++hi)
    tab[rev | (hi << len)] = {state, static_cast<uint8_t>(len),
                              static_cast<uint16_t>(param)};
}

const Tables& tables() {
  static const Tables* t = [] {
    Tables* t = new Tables();
    const struct { const char* bits; uint8_t state; int param; } main[] = {
      {"1", kV0, 0}, {"011", kVR, 1}, {"010", kVL, 1}, {"001", kHoriz, 0},
      {"0001", kPass, 0}, {"000011", kVR, 2}, {"000010", kVL, 2},
      {"0000011", kVR, 3}, {"0000010", kVL, 3}, {"0000001", kExt, 0},
      {"0000000", kEol, 0}};
    for (auto& m : main) put(t->main, 7, m.bits, m.state, m.param);
    for (int i = 0; i < 64; ++i) {
      put(t->white, 12, kWhiteTerm[i], kTermW, i);
      put(t->black, 13, kBlackTerm[i], kTermB, i);
    }
    for (int i = 0; i < 27; ++i) {
      put(t->white, 12, kWhiteMakeUp[i], kMakeUpW, 64 * (i + 1));
      put(t->black, 13, kBlackMakeUp[i], kMakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      put(t->white, 12, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
      put(t->black, 13, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
    }
    put(t->white, 12, kEolCode, kEol, 0);
    put(t->black, 13, kEolCode, kEol, 0);
    return t;
  }();
  return *t;
}

enum Err { kEof = -1, kBadCode = -2, kBadLength = -3, kUncompressed = -4,
           kOverflow = -5, kEarlyEol = -6 };

struct Bits {
  const uint8_t* data;
  int64_t n, cp = 0;
  uint32_t acc = 0;
  int avail = 0;
  bool reverse;  // FillOrder 1: the first bit of the stream is a byte's MSB
  uint32_t byte(int64_t i) const {
    uint32_t b = data[i];
    if (!reverse) return b;
    b = ((b & 0xF0) >> 4) | ((b & 0x0F) << 4);
    b = ((b & 0xCC) >> 2) | ((b & 0x33) << 2);
    return ((b & 0xAA) >> 1) | ((b & 0x55) << 1);
  }
  bool need8(int k) {
    if (avail < k) {
      if (cp >= n) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= byte(cp++) << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int k) {
    if (avail < k) {
      if (cp >= n) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= byte(cp++) << avail;
        if ((avail += 8) < k) {
          if (cp >= n) {
            avail = k;
          } else {
            acc |= byte(cp++) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int k) const { return acc & ((1u << k) - 1); }
  void clr(int k) { avail -= k; acc >>= k; }
};

struct Row {
  uint32_t* thisrun;
  uint32_t* pa;
  uint32_t* end;
  int a0 = 0, run_length = 0, lastx;
  bool set(int x) {
    if (pa >= end) return false;
    *pa++ = run_length + x;
    a0 += x;
    run_length = 0;
    return true;
  }
};

// One run of one colour: make-up codes, then a terminating code.
int colour_run(Bits& b, Row& r, bool white, int& eolcnt) {
  const Tables& t = tables();
  for (;;) {
    int wid = white ? 12 : 13;
    if (!b.need16(wid)) return kEof;
    const Ent& e = (white ? t.white : t.black)[b.get(wid)];
    b.clr(e.width);
    switch (e.state) {
      case kEol: eolcnt = 1; return kEarlyEol;
      case kTermW: case kTermB:
        return r.set(e.param) ? 0 : kOverflow;
      case kMakeUpW: case kMakeUpB: case kMakeUp:
        r.a0 += e.param;
        r.run_length += e.param;
        break;
      default: return kBadCode;
    }
  }
}

// CLEANUP_RUNS for a decoded row: anything but an exact width is refused
int cleanup(Row& r) {
  if (r.run_length && !r.set(0)) return kOverflow;
  return r.a0 == r.lastx ? 0 : kBadLength;
}

int expand1d(Bits& b, Row& r, int& eolcnt) {
  for (;;) {
    int st = colour_run(b, r, true, eolcnt);
    if (st) return st;
    if (r.a0 >= r.lastx) break;
    st = colour_run(b, r, false, eolcnt);
    if (st) return st;
    if (r.a0 >= r.lastx) break;
    if (r.pa[-1] == 0 && r.pa[-2] == 0) r.pa -= 2;
  }
  return cleanup(r);
}

int expand2d(Bits& b, Row& r, const uint32_t* refruns, const uint32_t* refend,
             int& eolcnt) {
  const Tables& t = tables();
  const uint32_t* pb = refruns;
  int b1 = static_cast<int>(*pb++);
  auto check_b1 = [&]() {
    if (r.pa != r.thisrun)
      while (b1 <= r.a0 && b1 < r.lastx) {
        if (pb + 1 >= refend) return false;
        b1 += pb[0] + pb[1];
        pb += 2;
      }
    return true;
  };
  while (r.a0 < r.lastx) {
    if (r.pa >= r.end) return kOverflow;
    if (!b.need8(7)) return kEof;
    const Ent& e = t.main[b.get(7)];
    b.clr(e.width);
    switch (e.state) {
      case kPass:
        if (!check_b1() || pb >= refend) return kOverflow;
        b1 += *pb++;
        r.run_length += b1 - r.a0;
        r.a0 = b1;
        if (pb >= refend) return kOverflow;
        b1 += *pb++;
        break;
      case kHoriz: {
        bool white = ((r.pa - r.thisrun) & 1) == 0;
        int st = colour_run(b, r, white, eolcnt);
        if (!st) st = colour_run(b, r, !white, eolcnt);
        if (st) return st == kEarlyEol ? kBadCode : st;
        if (!check_b1()) return kOverflow;
        break;
      }
      case kV0: case kVR:
        if (!check_b1()) return kOverflow;
        if (!r.set(b1 - r.a0 + (e.state == kVR ? e.param : 0)))
          return kOverflow;
        if (pb >= refend) return kOverflow;
        b1 += *pb++;
        break;
      case kVL:
        if (!check_b1()) return kOverflow;
        if (b1 < r.a0 + e.param) return kBadCode;
        if (!r.set(b1 - r.a0 - e.param)) return kOverflow;
        if (pb <= refruns) return kOverflow;
        b1 -= *--pb;
        break;
      case kExt: return kUncompressed;
      case kEol: eolcnt = 1; return kEarlyEol;
      default: return kBadCode;
    }
  }
  if (r.run_length && !r.set(0)) return kOverflow;
  return cleanup(r);
}

// SYNC_EOL: skip to just past the next EOL (fill bits included)
int sync_eol(Bits& b, int& eolcnt) {
  if (eolcnt == 0) {
    for (;;) {
      if (!b.need16(11)) return kEof;
      if (b.get(11) == 0) break;
      b.clr(1);
    }
  }
  for (;;) {
    if (!b.need8(8)) return kEof;
    if (b.get(8)) break;
    b.clr(8);
  }
  while (b.get(1) == 0) b.clr(1);
  b.clr(1);
  eolcnt = 0;
  return 0;
}

void fill(uint8_t* row, const uint32_t* runs, const uint32_t* end, int lastx) {
  memset(row, 0, (lastx + 7) / 8);
  int x = 0;
  for (const uint32_t* p = runs; p < end && x < lastx; ++p) {
    int run = std::min<int>(static_cast<int>(*p), lastx - x);
    if ((p - runs) & 1)
      for (int i = x; i < x + run; ++i) row[i >> 3] |= 0x80 >> (i & 7);
    x += run;
  }
}

}  // namespace

// One strip or tile of CCITT data → `rows` rows of packed 1-bit samples
// (black = 1, MSB first, rows byte-aligned). kind: 2 (MH, byte-aligned
// rows), 32771 (MH, 16-bit-aligned rows; `odd_start` if the data begins
// at an odd file offset), 3 (T.4 with EOLs; `two_d` for 2-D rows) or 4
// (T.6). `lsb_first`: FillOrder 2. → bytes written, or a negative code:
// -1 data ends early, -2 a bad code word or an EOL inside a row, -3 a row
// of the wrong length, -4 uncompressed mode, -5 runs overflowing the row.
extern "C" int64_t fax_decode(const uint8_t* src, int64_t n, int32_t kind,
                              int32_t two_d, int32_t lsb_first,
                              int32_t odd_start, int64_t width,
                              int64_t rows, uint8_t* dst) {
  using namespace fax;
  Bits b{src, n};
  b.reverse = !lsb_first;
  // libtiff's run arrays: 2·roundup(width + 1, 32) entries each; the
  // reference line is read up to that bound, past its own runs
  int64_t nruns = 2 * ((width + 1 + 31) / 32 * 32);
  std::vector<uint32_t> cur(nruns), ref(nruns);
  ref[0] = static_cast<uint32_t>(width);
  ref[1] = 0;
  int64_t rowbytes = (width + 7) / 8;
  int eolcnt = 0;
  for (int64_t y = 0; y < rows; ++y) {
    Row r{cur.data(), cur.data(), cur.data() + nruns, 0, 0,
          static_cast<int>(width)};
    int st = 0;
    if (kind == 2 || kind == 32771) {
      st = expand1d(b, r, eolcnt);
      if (st) return st;
      if (kind == 2) {
        b.clr(b.avail - (b.avail & ~7));
      } else {
        b.clr(b.avail - (b.avail & ~15));
        if (b.avail == 0 && ((b.cp + odd_start) & 1))
          b.cp++;
      }
    } else {
      bool is1d = true;
      if (kind == 3) {
        st = sync_eol(b, eolcnt);
        if (st) return st;
        if (two_d) {
          if (!b.need8(1)) return kEof;
          is1d = b.get(1);
          b.clr(1);
        }
      } else {
        is1d = false;
      }
      st = is1d ? expand1d(b, r, eolcnt)
                : expand2d(b, r, ref.data(), ref.data() + nruns, eolcnt);
      if (st) return st;
    }
    fill(dst + y * rowbytes, r.thisrun, r.pa, r.lastx);
    if (kind == 3 || kind == 4) {
      if (r.pa < r.end) r.set(0);
      std::swap(cur, ref);
    }
  }
  return rows * rowbytes;
}

// ThunderScan 4-bit rows (libtiff's tif_thunder.c, ThunderDecode per row)
// into packed rows of (width + 1) / 2 bytes; a row whose pixel count is
// not the width, or that a run ends without writing (libtiff leaves those
// bytes as they were), → -1.
extern "C" int64_t thunder_decode(const uint8_t* src, int64_t n,
                                  int64_t width, int64_t rows, uint8_t* dst) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  int64_t rowbytes = (width + 1) / 2, cc = n;
  const uint8_t* bp = src;
  memset(dst, 0, rowbytes * rows);
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* op = dst + y * rowbytes;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xF;
      if (npixels < width) {
        if (npixels++ & 1) *op++ |= lastpixel;
        else op[0] = static_cast<uint8_t>(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < width) {
      int c = *bp++, d;
      cc--;
      switch (c & 0xC0) {
        case 0x00: {  // a run of the last pixel
          int k = c & 0x3F;
          if (npixels & 1) {
            op[0] |= lastpixel;
            lastpixel = *op++;
            npixels++;
            k--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels >= width) return -1;
          for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(lastpixel);
          if (k == -1) *--op &= 0xF0;
          lastpixel &= 0xF;
          break;
        }
        case 0x40:  // 2-bit deltas
          if ((d = (c >> 4) & 3) != 2) setpixel(lastpixel + two[d]);
          if ((d = (c >> 2) & 3) != 2) setpixel(lastpixel + two[d]);
          if ((d = c & 3) != 2) setpixel(lastpixel + two[d]);
          break;
        case 0x80:  // 3-bit deltas
          if ((d = (c >> 3) & 7) != 4) setpixel(lastpixel + three[d]);
          if ((d = c & 7) != 4) setpixel(lastpixel + three[d]);
          break;
        default:    // raw
          setpixel(c);
      }
    }
    if (npixels != width) return -1;
  }
  return rowbytes * rows;
}

// ---------------------------------------------------------------- JPEG 2000
// One tile of a JPEG 2000 codestream as OpenJPEG 2.5 decodes it (ITU-T
// T.800): tier-2 (packet headers: tag trees, inclusion, zero bit-planes,
// pass counts, Lblock; SOP/EPH; packed headers), tier-1 (the MQ decoder,
// the raw bypass, the significance, refinement and cleanup passes with
// their 19 contexts, the code-block styles), ROI max-shift, dequantization
// and the inverse 5/3 (integer) or 9/7 (float32, OpenJPEG's constants and
// order of operations) wavelet. The geometry (bands, precincts, code-blocks)
// and the packet order come from `io/jpeg2000.py`.
namespace j2k {

// ITU-T T.800 Table C.2: Qe, NMPS, NLPS, SWITCH
const uint16_t kQe[47] = {
  0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
  0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
  0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
  0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
  0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
  0x0001, 0x5601};
const uint8_t kNmps[47] = {
  1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
  21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
  39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {
  1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
  18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
  35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1};

enum { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18 };
enum { kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kPterm = 16,
       kSegSym = 32 };

// The MQ decoder of C.3 as OpenJPEG's mqc.c runs it, over a segment
// followed by two 0xFF bytes; and the raw (bypass) bit reader.
struct Mq {
  const uint8_t* bp;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[19], mps[19];
  void reset_states() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  void bytein() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += static_cast<uint32_t>(*bp) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += static_cast<uint32_t>(*bp) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, int64_t len) {
    bp = data;
    c = len == 0 ? 0xFFu << 16 : static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void init_raw(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    uint8_t& s = state[cx];
    uint32_t qe = kQe[s];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        s = kNmps[s];
      } else {
        d = !mps[cx];
        if (kSwitch[s]) mps[cx] ^= 1;
        s = kNlps[s];
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = !mps[cx];
          if (kSwitch[s]) mps[cx] ^= 1;
          s = kNlps[s];
        } else {
          d = mps[cx];
          s = kNmps[s];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

struct Seg { int maxpasses = 0, numpasses = 0, newpasses = 0;
             int64_t len = 0, newlen = 0; };

struct Cblk {
  int band, x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, newpasses = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

// A code-block's state flags and the contexts of T.800 Annex D that both
// tier-1 coders read from them.
struct Flags {
  int w, h, orient, style;
  std::vector<uint8_t> sig, sgn, pi, mu;  // (h + 2) x (w + 2), padded
  int at(int x, int y) const { return (y + 1) * (w + 2) + x + 1; }
  // the row below is outside this sample's contexts under VSC at a
  // stripe's last row
  bool south(int y) const { return !((style & kVsc) && (y & 3) == 3); }
  int nb(int x, int y) const {
    int i = at(x, y), s = w + 2, n = sig[i - 1] + sig[i + 1] + sig[i - s]
        + sig[i - s - 1] + sig[i - s + 1];
    if (south(y)) n += sig[i + s] + sig[i + s - 1] + sig[i + s + 1];
    return n;
  }
  int zc(int x, int y) const {
    int i = at(x, y), s = w + 2;
    int hh = sig[i - 1] + sig[i + 1];
    int vv = sig[i - s] + (south(y) ? sig[i + s] : 0);
    int dd = sig[i - s - 1] + sig[i - s + 1]
        + (south(y) ? sig[i + s - 1] + sig[i + s + 1] : 0);
    if (orient == 3) {
      int hv = hh + vv;
      if (dd >= 3) return 8;
      if (dd == 2) return hv >= 1 ? 7 : 6;
      if (dd == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
      return hv >= 2 ? 2 : hv;
    }
    if (orient == 1) std::swap(hh, vv);
    if (hh == 2) return 8;
    if (hh == 1) return vv ? 7 : dd ? 6 : 5;
    if (vv) return vv == 2 ? 4 : 3;
    return dd >= 2 ? 2 : dd;
  }
  int contribution(int i) const { return sig[i] ? (sgn[i] ? -1 : 1) : 0; }
  // sign context and its XOR bit (T.800 Table D.3)
  int sc(int x, int y, int& xorbit) const {
    int i = at(x, y), s = w + 2;
    int hc = contribution(i - 1) + contribution(i + 1);
    int vc = contribution(i - s) + (south(y) ? contribution(i + s) : 0);
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
      xorbit = 1;
    } else if (hc == 0 && vc < 0) {
      vc = -vc;
      xorbit = 1;
    } else {
      xorbit = 0;
    }
    return kCtxSc + (hc == 0 ? (vc == 0 ? 0 : 1) : 3 + vc);
  }
  int mag_ctx(int x, int y) const {
    int i = at(x, y);
    return kCtxMag + (mu[i] ? 2 : nb(x, y) ? 1 : 0);
  }
  void clear_flags() {
    int n = (w + 2) * (h + 2);
    sig.assign(n, 0);
    sgn.assign(n, 0);
    pi.assign(n, 0);
    mu.assign(n, 0);
  }
  template <class F> void scan(F f) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) f(x, y);
  }
};

// One code-block's tier-1 decode into `out` (w·h int32, row-major).
struct T1 : Flags {
  int32_t* data;
  Mq mq;
  void become_significant(int x, int y, int neg, int32_t oneplushalf) {
    int i = at(x, y);
    sig[i] = 1;
    sgn[i] = neg;
    data[y * w + x] = neg ? -oneplushalf : oneplushalf;
  }
  void decode_sign(int x, int y, int32_t oneplushalf) {
    int xorbit, cx = sc(x, y, xorbit);
    become_significant(x, y, mq.decode(cx) ^ xorbit, oneplushalf);
  }
  void sigpass(int bpno, bool raw) {
    int32_t one = 1 << bpno, oph = one | (one >> 1);
    scan([&](int x, int y) {
      int i = at(x, y);
      if (sig[i] || !nb(x, y)) return;
      if (raw) {
        if (mq.raw()) become_significant(x, y, mq.raw(), oph);
      } else if (mq.decode(zc(x, y))) {
        decode_sign(x, y, oph);
      }
      pi[i] = 1;
    });
  }
  void refpass(int bpno, bool raw) {
    int32_t poshalf = (1 << bpno) >> 1;
    scan([&](int x, int y) {
      int i = at(x, y);
      if (!sig[i] || pi[i]) return;
      int v = raw ? mq.raw() : mq.decode(mag_ctx(x, y));
      int32_t& d = data[y * w + x];
      d += (v ^ (d < 0)) ? poshalf : -poshalf;
      mu[i] = 1;
    });
  }
  void clnpass(int bpno) {
    int32_t one = 1 << bpno, oph = one | (one >> 1);
    auto step = [&](int x, int y, bool skip_zc) {
      int i = at(x, y);
      if (sig[i] || pi[i]) return;
      if (skip_zc || mq.decode(zc(x, y))) decode_sign(x, y, oph);
    };
    for (int y0 = 0; y0 < h; y0 += 4) {
      for (int x = 0; x < w; ++x) {
        int y1 = std::min(y0 + 4, h), start = y0;
        if (y1 - y0 == 4) {
          bool run = true;
          for (int y = y0; y < y1 && run; ++y) {
            int i = at(x, y);
            run = !sig[i] && !pi[i] && !nb(x, y);
          }
          if (run) {
            if (!mq.decode(kCtxAgg)) {
              start = y1;
            } else {
              int r = mq.decode(kCtxUni);
              r = (r << 1) | mq.decode(kCtxUni);
              step(x, y0 + r, true);
              start = y0 + r + 1;
            }
          }
        }
        for (int y = start; y < y1; ++y) step(x, y, false);
        for (int y = y0; y < y1; ++y) pi[at(x, y)] = 0;
      }
    }
    if (style & kSegSym) {
      for (int k = 0; k < 4; ++k) mq.decode(kCtxUni);
    }
  }
  // → false where OpenJPEG fails the code-block
  bool decode(const Cblk& cb, int roishift) {
    clear_flags();
    memset(data, 0, sizeof(int32_t) * w * h);
    if (cb.segs.empty()) return true;
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31) return false;
    int passtype = 2;
    mq.reset_states();
    int64_t at_byte = 0;
    std::vector<uint8_t> buf;
    for (const Seg& seg : cb.segs) {
      bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2
          && (style & kLazy);
      buf.assign(cb.data.begin() + at_byte,
                 cb.data.begin() + at_byte + seg.len);
      buf.push_back(0xFF);
      buf.push_back(0xFF);
      at_byte += seg.len;
      if (raw) mq.init_raw(buf.data()); else mq.init(buf.data(), seg.len);
      for (int p = 0; p < seg.numpasses && bpno_plus_one >= 1; ++p) {
        if (passtype == 0) sigpass(bpno_plus_one, raw);
        else if (passtype == 1) refpass(bpno_plus_one, raw);
        else clnpass(bpno_plus_one);
        if ((style & kReset) && !raw) {
          mq.reset_states();
        }
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
    if (roishift) {
      int32_t thresh = 1 << roishift;
      for (int i = 0; i < w * h; ++i) {
        int32_t v = data[i], m = v < 0 ? -v : v;
        if (m >= thresh) {
          m >>= roishift;
          data[i] = v < 0 ? -m : m;
        }
      }
    }
    return true;
  }
};

// OpenJPEG's tag tree (tgt.c): nodes from the leaves up, values 999
struct TagTree {
  struct Node { int parent, value = 999, low = 0; };
  std::vector<Node> nodes;
  TagTree(int w, int h) {
    std::vector<int> lw{w}, lh{h};
    int n;
    do {
      n = lw.back() * lh.back();
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    } while (n > 1);
    int total = 0;
    std::vector<int> first;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      first.push_back(total);
      total += lw[l] * lh[l];
    }
    nodes.resize(std::max(total, 1));
    for (size_t l = 0; l < first.size(); ++l)
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i)
          nodes[first[l] + j * lw[l] + i].parent = l + 1 < first.size()
              ? first[l + 1] + (j / 2) * lw[l + 1] + i / 2 : -1;
  }
};

struct Bio {
  const uint8_t* bp;
  const uint8_t* start;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp >= end) return;
    buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

int tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
  int stk[32], sp = 0, node = leaf;
  while (t.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = t.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = t.nodes[node];
    if (low > nd.low) nd.low = low; else low = nd.low;
    while (low < threshold && low < nd.value) {
      if (bio.bit()) nd.value = low; else ++low;
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.nodes[node].value < threshold;
}

int numpasses(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

int floorlog2(int v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

void init_seg(Cblk& cb, int style, bool first) {
  Seg s;
  if (style & kTermAll) {
    s.maxpasses = 1;
  } else if (style & kLazy) {
    if (first) {
      s.maxpasses = 10;
    } else {
      int prev = cb.segs.back().maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
  cb.segs.push_back(s);
}

// 1-D synthesis on x[0..n) (interleaved; the low-pass samples at the
// positions of parity `cas`), with whole-sample symmetric extension
void idwt53(int32_t* x, int n, int cas) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto at = [&](int i) { return x[i < 0 ? -i : i >= n ? 2 * n - 2 - i : i]; };
  for (int i = cas; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1)) >> 1;
}

void idwt97(float* x, int n, int cas) {
  if (n == 1) return;
  const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
  const float kLift[4] = {-0.443506852f, -0.882911075f, 0.052980118f,
                          1.586134342f};   // -delta, -gamma, -beta, -alpha
  for (int i = cas; i < n; i += 2) x[i] = x[i] * kK;
  for (int i = 1 - cas; i < n; i += 2) x[i] = x[i] * kTwoInvK;
  auto at = [&](int i) { return x[i < 0 ? -i : i >= n ? 2 * n - 2 - i : i]; };
  for (int step = 0; step < 4; ++step) {
    int parity = step % 2 == 0 ? cas : 1 - cas;
    float c = kLift[step];
    for (int i = parity; i < n; i += 2) x[i] = x[i] + (at(i - 1) + at(i + 1)) * c;
  }
}

// the 2-D inverse wavelet of one tile-component, level by level, rows
// then columns (OpenJPEG's opj_dwt_decode_tile / _97)
template <class T, class F>
void idwt2d(T* a, int stride, const int32_t* res, int numres, F f) {
  std::vector<T> tmp;
  for (int r = 1; r < numres; ++r) {
    const int32_t* pr = res + 4 * (r - 1);
    const int32_t* cr = res + 4 * r;
    int sw = pr[2] - pr[0], shh = pr[3] - pr[1];
    int rw = cr[2] - cr[0], rh = cr[3] - cr[1];
    int cas_h = cr[0] & 1, cas_v = cr[1] & 1;
    tmp.resize(std::max(rw, rh));
    if (rw > 0)
      for (int y = 0; y < rh; ++y) {
        T* row = a + static_cast<int64_t>(y) * stride;
        for (int k = 0; k < sw; ++k) tmp[2 * k + cas_h] = row[k];
        for (int k = 0; k < rw - sw; ++k) tmp[2 * k + 1 - cas_h] = row[sw + k];
        f(tmp.data(), rw, cas_h);
        for (int i = 0; i < rw; ++i) row[i] = tmp[i];
      }
    if (rh > 0)
      for (int x = 0; x < rw; ++x) {
        for (int k = 0; k < shh; ++k)
          tmp[2 * k + cas_v] = a[static_cast<int64_t>(k) * stride + x];
        for (int k = 0; k < rh - shh; ++k)
          tmp[2 * k + 1 - cas_v] = a[static_cast<int64_t>(shh + k) * stride + x];
        f(tmp.data(), rh, cas_v);
        for (int i = 0; i < rh; ++i)
          a[static_cast<int64_t>(i) * stride + x] = tmp[i];
      }
  }
}


// ------------------------------------------------ JPEG 2000 encoding
// One tile as OpenJPEG 2.5 encodes it at OpenCV's parameters: the
// reversible 5/3 wavelet, code-blocks coded with no style bits and one
// termination (the MQ flush), each pass's rate and distortion estimate
// (t1.c: the nmsedec tables, opj_t1_getwmsedec), one quality layer whose
// passes the rate allocation picks (tcd.c: opj_tcd_rateallocate, the
// bisection on the rate-distortion slope against the byte budget) and the
// packets of tier-2 (t2.c: tag trees, pass counts, Lblock).

// the MQ coder of C.2 as OpenJPEG's mqc.c runs it; buf[0] is the byte
// before the code-block's data (OpenJPEG's bp starts at start - 1)
struct MqEnc {
  std::vector<uint8_t> buf;
  int64_t bp = 0;
  uint32_t a = 0x8000, c = 0;
  int ct = 12;
  uint8_t state[19], mps[19];
  MqEnc() {
    buf.assign(1, 0);
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  void put(uint8_t v) {
    if (++bp == static_cast<int64_t>(buf.size())) buf.push_back(v);
    else buf[bp] = v;
  }
  void byteout() {
    if (buf[bp] == 0xFF) {
      put(static_cast<uint8_t>(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      put(static_cast<uint8_t>(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      buf[bp]++;
      if (buf[bp] == 0xFF) {
        c &= 0x7FFFFFF;
        put(static_cast<uint8_t>(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        put(static_cast<uint8_t>(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }
  void encode(int cx, int d) {
    uint8_t& s = state[cx];
    uint32_t qe = kQe[s];
    a -= qe;
    if (mps[cx] == d) {
      if ((a & 0x8000) == 0) {
        if (a < qe) a = qe; else c += qe;
        s = kNmps[s];
        renorm();
      } else {
        c += qe;
      }
    } else {
      if (a < qe) c += qe; else a = qe;
      if (kSwitch[s]) mps[cx] ^= 1;
      s = kNlps[s];
      renorm();
    }
  }
  void flush() {
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (buf[bp] != 0xFF) bp++;
  }
  // bytes since the start, as OpenJPEG's unsigned opj_mqc_numbytes
  uint32_t numbytes() const { return static_cast<uint32_t>(bp - 1); }
};

// t1_luts.h: the distortion decrease of a coded bit, from the 7 bits at
// and below the plane (6 of them fractional), in units of 2^-13
struct Nmsedec {
  int16_t sig[128], sig0[128], ref[128], ref0[128];
  Nmsedec() {
    auto q = [](double x) {
      return static_cast<int16_t>(std::max(
          0, static_cast<int>(std::floor(x * 64.0 + 0.5) / 64.0 * 8192.0)));
    };
    for (int i = 0; i < 128; ++i) {
      double t = i / 64.0, u = t, v = t - 1.5;
      sig[i] = q(u * u - v * v);
      sig0[i] = q(u * u);
      u = t - 1.0;
      v = (i & 64) ? t - 1.5 : t - 0.5;
      ref[i] = q(u * u - v * v);
      ref0[i] = q(u * u);
    }
  }
};
const Nmsedec& nmsedec_tables() {
  static const Nmsedec t;
  return t;
}

// dwt.c: opj_dwt_norms, the 5/3 synthesis basis norms by orientation
// (LL, HL, LH, HH) and level
const double kNorms53[4][10] = {
  {1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3},
  {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
  {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
  {.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93}};

struct Pass {
  uint32_t rate = 0, len = 0;
  double dist = 0;
  bool term = false;
};

struct EncCblk {
  int numbps = 0;
  std::vector<uint8_t> data;
  std::vector<Pass> passes;
  // the layer's passes and bytes; tier-2's state
  int layer_passes = 0, numlenbits = 0, t2_passes = 0;
  uint32_t layer_len = 0;
};

// One code-block's tier-1 encode (opj_t1_encode_cblk with cblksty 0):
// `coef` holds its w·h wavelet coefficients, row-major.
struct T1Enc : Flags {
  std::vector<uint32_t> mag;  // |coefficient| << 6
  std::vector<uint8_t> neg;
  MqEnc mq;
  int bit(int x, int y, uint32_t one) const {
    return (mag[y * w + x] & one) != 0;
  }
  void encode_sign(int x, int y) {
    int xorbit, cx = sc(x, y, xorbit), i = at(x, y);
    mq.encode(cx, neg[y * w + x] ^ xorbit);
    sig[i] = 1;
    sgn[i] = neg[y * w + x];
  }
  int sig_decrease(int x, int y, int bpno) const {
    const Nmsedec& t = nmsedec_tables();
    uint32_t m = mag[y * w + x];
    return bpno > 0 ? t.sig[(m >> bpno) & 127] : t.sig0[m & 127];
  }
  int ref_decrease(int x, int y, int bpno) const {
    const Nmsedec& t = nmsedec_tables();
    uint32_t m = mag[y * w + x];
    return bpno > 0 ? t.ref[(m >> bpno) & 127] : t.ref0[m & 127];
  }
  int sigpass(int bpno) {
    uint32_t one = 1u << (bpno + 6);
    int nmsedec = 0;
    scan([&](int x, int y) {
      int i = at(x, y);
      if (sig[i] || !nb(x, y)) return;
      int v = bit(x, y, one);
      mq.encode(zc(x, y), v);
      if (v) {
        nmsedec += sig_decrease(x, y, bpno);
        encode_sign(x, y);
      }
      pi[i] = 1;
    });
    return nmsedec;
  }
  int refpass(int bpno) {
    uint32_t one = 1u << (bpno + 6);
    int nmsedec = 0;
    scan([&](int x, int y) {
      int i = at(x, y);
      if (!sig[i] || pi[i]) return;
      nmsedec += ref_decrease(x, y, bpno);
      mq.encode(mag_ctx(x, y), bit(x, y, one));
      mu[i] = 1;
    });
    return nmsedec;
  }
  int clnpass(int bpno) {
    uint32_t one = 1u << (bpno + 6);
    int nmsedec = 0;
    auto significant = [&](int x, int y) {
      nmsedec += sig_decrease(x, y, bpno);
      encode_sign(x, y);
    };
    for (int y0 = 0; y0 < h; y0 += 4) {
      for (int x = 0; x < w; ++x) {
        int y1 = std::min(y0 + 4, h), start = y0;
        if (y1 - y0 == 4) {
          bool run = true;
          for (int y = y0; y < y1 && run; ++y) {
            int i = at(x, y);
            run = !sig[i] && !pi[i] && !nb(x, y);
          }
          if (run) {
            int r = 0;
            while (r < 4 && !bit(x, y0 + r, one)) ++r;
            if (r == 4) {
              mq.encode(kCtxAgg, 0);
              start = y1;
            } else {
              mq.encode(kCtxAgg, 1);
              mq.encode(kCtxUni, r >> 1);
              mq.encode(kCtxUni, r & 1);
              significant(x, y0 + r);
              start = y0 + r + 1;
            }
          }
        }
        for (int y = start; y < y1; ++y) {
          int i = at(x, y);
          if (sig[i] || pi[i]) continue;
          int v = bit(x, y, one);
          mq.encode(zc(x, y), v);
          if (v) significant(x, y);
        }
        for (int y = y0; y < y1; ++y) pi[at(x, y)] = 0;
      }
    }
    return nmsedec;
  }
  // → the code-block's passes and data; `norm` is the band's basis norm
  void encode(const int32_t* coef, double norm, EncCblk& cb) {
    clear_flags();
    mag.resize(static_cast<size_t>(w) * h);
    neg.resize(mag.size());
    uint32_t max = 0;
    for (size_t k = 0; k < mag.size(); ++k) {
      int32_t v = coef[k];
      mag[k] = static_cast<uint32_t>(v < 0 ? -v : v) << 6;
      neg[k] = v < 0;
      max = std::max(max, mag[k]);
    }
    cb.numbps = max ? floorlog2(static_cast<int>(max)) + 1 - 6 : 0;
    cb.passes.clear();
    if (cb.numbps == 0) return;
    double cum = 0;
    for (int bpno = cb.numbps - 1, passtype = 2; bpno >= 0;) {
      int nmsedec = passtype == 0 ? sigpass(bpno)
          : passtype == 1 ? refpass(bpno) : clnpass(bpno);
      double wmsedec = 1.0 * norm * 1.0 * (1 << bpno);
      wmsedec *= wmsedec * nmsedec / 8192.0;
      cum += wmsedec;
      Pass p;
      p.dist = cum;
      if (bpno == 0 && passtype == 2) {
        mq.flush();
        p.term = true;
        p.rate = mq.numbytes();
      } else {
        p.rate = mq.numbytes() + 3;
      }
      cb.passes.push_back(p);
      if (++passtype == 3) {
        passtype = 0;
        bpno--;
      }
    }
    // rates never exceed the final length, and no pass ends on 0xFF
    uint32_t last = mq.numbytes();
    for (size_t k = cb.passes.size(); k-- > 0;) {
      if (cb.passes[k].rate > last) cb.passes[k].rate = last;
      else last = cb.passes[k].rate;
    }
    const uint8_t* data = mq.buf.data() + 1;
    for (size_t k = 0; k < cb.passes.size(); ++k) {
      Pass& p = cb.passes[k];
      if (data[p.rate - 1] == 0xFF) p.rate--;
      p.len = p.rate - (k == 0 ? 0 : cb.passes[k - 1].rate);
    }
    cb.data.assign(data, data + mq.numbytes());
  }
};

// 1-D 5/3 analysis on x[0..n) (even start), in place: lows to the first
// ceil(n/2) places, highs after them (opj_dwt_encode_1 and deinterleave)
void fdwt53(int32_t* x, int n, std::vector<int32_t>& tmp) {
  if (n == 1) return;
  auto at = [&](int i) { return x[i < 0 ? -i : i >= n ? 2 * n - 2 - i : i]; };
  for (int i = 1; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1)) >> 1;
  for (int i = 0; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1) + 2) >> 2;
  tmp.resize(n);
  int sn = (n + 1) / 2;
  for (int i = 0; i < n; ++i) tmp[(i & 1) ? sn + i / 2 : i / 2] = x[i];
  std::copy(tmp.begin(), tmp.begin() + n, x);
}

// OpenJPEG's tag tree encoder (tgt.c), over the decoder's node layout
struct TagTreeEnc : TagTree {
  std::vector<uint8_t> known;
  TagTreeEnc(int w, int h) : TagTree(w, h), known(nodes.size(), 0) {}
  void set(int leaf, int value) {
    for (int n = leaf; n >= 0 && nodes[n].value > value; n = nodes[n].parent)
      nodes[n].value = value;
  }
};

// t2.c's bit writer: a 0xFF byte is followed by 7 bits; a byte past the
// end is dropped and fails the flush
struct BioEnc {
  uint8_t* start;
  uint8_t* bp;
  uint8_t* end;
  uint32_t buf = 0;
  int ct = 8;
  bool byteout() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp >= end) return false;
    *bp++ = static_cast<uint8_t>(buf >> 8);
    return true;
  }
  void bit(uint32_t b) {
    if (ct == 0) byteout();
    ct--;
    buf |= b << ct;
  }
  void write(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) bit((v >> i) & 1);
  }
  bool flush() {
    if (!byteout()) return false;
    if (ct == 7 && !byteout()) return false;
    return true;
  }
};

void tgt_encode(BioEnc& bio, TagTreeEnc& t, int leaf, int threshold) {
  int stk[32], sp = 0, node = leaf;
  while (t.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = t.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = t.nodes[node];
    if (low > nd.low) nd.low = low; else low = nd.low;
    while (low < threshold) {
      if (low >= nd.value) {
        if (!t.known[node]) {
          bio.bit(1);
          t.known[node] = 1;
        }
        break;
      }
      bio.bit(0);
      ++low;
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
}

void put_numpasses(BioEnc& bio, int n) {
  if (n == 1) bio.bit(0);
  else if (n == 2) bio.write(2, 2);
  else if (n <= 5) bio.write(0xC | (n - 3), 4);
  else if (n <= 36) bio.write(0x1E0 | (n - 6), 9);
  else bio.write(0xFF80 | (n - 37), 16);
}

struct EncBand {
  int orient, numbps, ox, oy, bw, bh, cw, ch;
  std::vector<EncCblk> cblks;
};

// the bands of one resolution of one component: its precinct
struct EncRes {
  std::vector<EncBand> bands;
};

// One packet (layer 0) of `res` into [dst, dst + length): → its bytes, or
// -1 where it does not fit (opj_t2_encode_packet)
int64_t encode_packet(EncRes& res, uint8_t* dst, int64_t length) {
  std::vector<TagTreeEnc> incl, imsb;
  for (EncBand& b : res.bands) {
    incl.emplace_back(b.cw, b.ch);
    imsb.emplace_back(b.cw, b.ch);
    for (size_t k = 0; k < b.cblks.size(); ++k) {
      b.cblks[k].t2_passes = 0;
      imsb.back().set(static_cast<int>(k), b.numbps - b.cblks[k].numbps);
    }
  }
  BioEnc bio;
  bio.start = bio.bp = dst;
  bio.end = dst + length;
  bio.bit(1);
  for (size_t bi = 0; bi < res.bands.size(); ++bi) {
    EncBand& b = res.bands[bi];
    for (size_t k = 0; k < b.cblks.size(); ++k)
      if (b.cblks[k].layer_passes) incl[bi].set(static_cast<int>(k), 0);
    for (size_t k = 0; k < b.cblks.size(); ++k) {
      EncCblk& cb = b.cblks[k];
      tgt_encode(bio, incl[bi], static_cast<int>(k), 1);
      if (!cb.layer_passes) continue;
      cb.numlenbits = 3;
      tgt_encode(bio, imsb[bi], static_cast<int>(k), 999);
      put_numpasses(bio, cb.layer_passes);
      // one codeword segment: all the layer's passes end at its last
      int increment = 0, nump = 0;
      uint32_t len = 0;
      for (int p = 0; p < cb.layer_passes; ++p) {
        ++nump;
        len += cb.passes[p].len;
        if (cb.passes[p].term || p == cb.layer_passes - 1) {
          increment = std::max(increment, floorlog2(static_cast<int>(len)) + 1
                               - (cb.numlenbits + floorlog2(nump)));
          len = 0;
          nump = 0;
        }
      }
      for (int i = 0; i < increment; ++i) bio.bit(1);
      bio.bit(0);
      cb.numlenbits += increment;
      for (int p = 0; p < cb.layer_passes; ++p) {
        ++nump;
        len += cb.passes[p].len;
        if (cb.passes[p].term || p == cb.layer_passes - 1) {
          bio.write(len, cb.numlenbits + floorlog2(nump));
          len = 0;
          nump = 0;
        }
      }
    }
  }
  if (!bio.flush()) return -1;
  uint8_t* c = bio.bp;
  length -= c - dst;
  for (EncBand& b : res.bands)
    for (EncCblk& cb : b.cblks) {
      if (!cb.layer_passes) continue;
      if (cb.layer_len > length) return -1;
      memcpy(c, cb.data.data(), cb.layer_len);
      cb.t2_passes += cb.layer_passes;
      c += cb.layer_len;
      length -= cb.layer_len;
    }
  return c - dst;
}

// opj_tcd_makelayer for layer 0: each code-block takes the passes whose
// slope from the last pass taken is at least `thresh` (all where it is
// negative); → whether any code-block's count changed
bool make_layer(std::vector<std::vector<EncRes>>& tile, double thresh) {
  bool changed = false;
  for (auto& comp : tile)
    for (EncRes& res : comp)
      for (EncBand& b : res.bands)
        for (EncCblk& cb : b.cblks) {
          int total = static_cast<int>(cb.passes.size()), n = 0;
          if (thresh < 0) {
            n = total;
          } else {
            for (int p = 0; p < total; ++p) {
              uint32_t dr;
              double dd;
              if (n == 0) {
                dr = cb.passes[p].rate;
                dd = cb.passes[p].dist;
              } else {
                dr = cb.passes[p].rate - cb.passes[n - 1].rate;
                dd = cb.passes[p].dist - cb.passes[n - 1].dist;
              }
              if (!dr) {
                if (dd != 0) n = p + 1;
                continue;
              }
              if (thresh - dd / dr < DBL_EPSILON) n = p + 1;
            }
          }
          changed |= cb.layer_passes != n;
          cb.layer_passes = n;
          cb.layer_len = n ? cb.passes[n - 1].rate : 0;
        }
  return changed;
}

// the packets of layer 0 in LRCP order into [dst, dst + length): → their
// bytes, or -1 where they do not fit
int64_t encode_packets(std::vector<std::vector<EncRes>>& tile, int numres,
                       uint8_t* dst, int64_t length) {
  int64_t at = 0;
  for (int r = 0; r < numres; ++r)
    for (auto& comp : tile) {
      int64_t n = encode_packet(comp[r], dst + at, length - at);
      if (n < 0) return -1;
      at += n;
    }
  return at;
}

}  // namespace j2k

// One tile: packets → code-blocks → coefficients → samples.
//   comps   (n_comp, 140) int32: numres, style, reversible, roishift,
//           out offset (words), width, height, sop|eph<<1 (first row
//           only), then 33 x (x0, y0, x1, y1) of the resolutions
//   bands   (n_band, 10) int32: comp, res, bandno, x0, y0, x1, y1, Mb,
//           ox, oy (where the band sits in the tile-component array);
//           stepsize (n_band) float32
//   precs   (n_prec, 15) int32: comp, res, nbands, 3 x (band, cw, ch,
//           first code-block)
//   cblks   (n_cblk, 5) int32: band, x0, y0, x1, y1
//   packets (n_packet, 2) int32: precinct, layer
// `hdr` holds the packed packet headers (PPM/PPT) or is empty. `out`:
// each component's samples, int32 (reversible) or float32, at its offset.
// → 0, or -1 a packet past the data, -2 a code-block of > 30 bit-planes,
// -3 a bad packet header.
extern "C" int64_t j2k_decode_tile(
    const uint8_t* src, int64_t n, const uint8_t* hdr, int64_t hn,
    int32_t n_comp, const int32_t* comps, int32_t n_band,
    const int32_t* bands, const float* stepsize, int32_t n_prec,
    const int32_t* precs, int32_t n_cblk, const int32_t* cblks,
    int32_t n_packet, const int32_t* packets, int32_t* out) {
  using namespace j2k;
  const int kC = 140;
  bool sop = comps[7] & 1, eph = comps[7] & 2;
  std::vector<Cblk> cb(n_cblk);
  for (int i = 0; i < n_cblk; ++i) {
    const int32_t* c = cblks + 5 * i;
    cb[i].band = c[0];
    cb[i].x0 = c[1];
    cb[i].y0 = c[2];
    cb[i].x1 = c[3];
    cb[i].y1 = c[4];
  }
  // the tag trees of each precinct's bands
  std::vector<TagTree> incl, imsb;
  for (int p = 0; p < n_prec; ++p)
    for (int b = 0; b < 3; ++b) {
      const int32_t* pb = precs + 15 * p + 3 + 4 * b;
      int cw = b < precs[15 * p + 2] ? pb[1] : 0;
      int ch = b < precs[15 * p + 2] ? pb[2] : 0;
      incl.emplace_back(std::max(cw, 1), std::max(ch, 1));
      imsb.emplace_back(std::max(cw, 1), std::max(ch, 1));
    }
  const uint8_t* cur = src;
  const uint8_t* end = src + n;
  const uint8_t* hcur = hn ? hdr : nullptr;
  const uint8_t* hend = hdr + hn;
  for (int k = 0; k < n_packet; ++k) {
    int p = packets[2 * k], layer = packets[2 * k + 1];
    const int32_t* pr = precs + 15 * p;
    const int32_t* cc = comps + kC * pr[0];
    int style = cc[1];
    if (sop && end - cur >= 6 && cur[0] == 0xFF && cur[1] == 0x91) cur += 6;
    Bio bio;
    bio.start = bio.bp = hcur ? hcur : cur;
    bio.end = hcur ? hend : end;
    std::vector<int> touched;
    if (bio.bit()) {
      for (int b = 0; b < pr[2]; ++b) {
        const int32_t* pb = pr + 3 + 4 * b;
        const int32_t* band = bands + 10 * pb[0];
        if (band[5] == band[3] || band[6] == band[4]) continue;
        int ncb = pb[1] * pb[2];
        for (int i = 0; i < ncb; ++i) {
          Cblk& c = cb[pb[3] + i];
          bool included = c.segs.empty()
              ? tgt_decode(bio, incl[3 * p + b], i, layer + 1) : bio.bit();
          if (!included) {
            c.newpasses = 0;
            continue;
          }
          if (c.segs.empty()) {
            int z = 0;
            while (!tgt_decode(bio, imsb[3 * p + b], i, z)) {
              if (++z > 64) return -3;
            }
            c.numbps = band[7] + 1 - z;
            c.numlenbits = 3;
          }
          c.newpasses = numpasses(bio);
          int inc = 0;
          while (bio.bit()) ++inc;
          c.numlenbits += inc;
          int segno;
          if (c.segs.empty()) {
            init_seg(c, style, true);
            segno = 0;
          } else {
            segno = static_cast<int>(c.segs.size()) - 1;
            if (c.segs[segno].numpasses == c.segs[segno].maxpasses) {
              init_seg(c, style, false);
              ++segno;
            }
          }
          int left = c.newpasses;
          int first_seg = segno;
          do {
            Seg& s = c.segs[segno];
            s.newpasses = std::min(s.maxpasses - s.numpasses, left);
            int bits = c.numlenbits + floorlog2(s.newpasses);
            if (bits > 32) return -3;
            s.newlen = bio.read(bits);
            left -= s.newpasses;
            if (left > 0) {
              init_seg(c, style, false);
              ++segno;
            }
          } while (left > 0);
          touched.push_back(pb[3] + i);
          touched.push_back(first_seg);
        }
      }
    }
    bio.inalign();
    const uint8_t* after = bio.bp;
    if (eph && bio.end - after >= 2 && after[0] == 0xFF && after[1] == 0x92)
      after += 2;
    if (hcur) hcur = after; else cur = after;
    // the packet body
    for (size_t t = 0; t < touched.size(); t += 2) {
      Cblk& c = cb[touched[t]];
      for (size_t s = touched[t + 1]; s < c.segs.size(); ++s) {
        Seg& sg = c.segs[s];
        if (sg.newpasses == 0 && sg.newlen == 0) continue;
        if (sg.newlen > end - cur) return -1;
        c.data.insert(c.data.end(), cur, cur + sg.newlen);
        cur += sg.newlen;
        sg.numpasses += sg.newpasses;
        sg.len += sg.newlen;
        sg.newpasses = 0;
        sg.newlen = 0;
      }
    }
  }
  // tier-1, dequantization, the wavelet
  std::vector<int32_t> blk;
  for (int i = 0; i < n_cblk; ++i) {
    const int32_t* band = bands + 10 * cb[i].band;
    const int32_t* cc = comps + kC * band[0];
    j2k::T1 t1;
    t1.w = cb[i].x1 - cb[i].x0;
    t1.h = cb[i].y1 - cb[i].y0;
    if (t1.w <= 0 || t1.h <= 0) continue;
    t1.orient = band[2];
    t1.style = cc[1];
    blk.assign(static_cast<size_t>(t1.w) * t1.h, 0);
    t1.data = blk.data();
    if (!t1.decode(cb[i], cc[3])) return -2;
    int32_t* dst = out + cc[4];
    int stride = cc[5];
    int ox = cb[i].x0 - band[3] + band[8], oy = cb[i].y0 - band[4] + band[9];
    float step = 0.5f * stepsize[cb[i].band];
    for (int y = 0; y < t1.h; ++y)
      for (int x = 0; x < t1.w; ++x) {
        int32_t v = blk[y * t1.w + x];
        int32_t* o = dst + static_cast<int64_t>(oy + y) * stride + ox + x;
        if (cc[2]) {
          *o = v / 2;
        } else {
          float f = static_cast<float>(v) * step;
          memcpy(o, &f, 4);
        }
      }
  }
  for (int c = 0; c < n_comp; ++c) {
    const int32_t* cc = comps + kC * c;
    if (cc[2])
      idwt2d(out + cc[4], cc[5], cc + 8, cc[0], idwt53);
    else
      idwt2d(reinterpret_cast<float*>(out + cc[4]), cc[5], cc + 8, cc[0],
             idwt97);
  }
  return 0;
}

// One tile of `nc` components of (h, w) unsigned `prec`-bit samples
// (int32, component after component; w, h >= 32) coded as OpenJPEG 2.5
// codes it for OpenCV: 5 decomposition levels of the 5/3 wavelet,
// 64x64 code-blocks, one precinct per resolution, one layer in LRCP
// order, no MCT. `maxlen` is the layer's byte budget (opj_tcd_rateallocate
// bisects the slope threshold 128 times against it; 0: every pass).
// → the packets' bytes in `dst`, or -1 where `cap` is short.
extern "C" int64_t j2k_encode_tile(const int32_t* samples, int32_t w,
                                   int32_t h, int32_t nc, int32_t prec,
                                   int64_t maxlen, uint8_t* dst,
                                   int64_t cap) {
  using namespace j2k;
  const int numres = 6;
  std::vector<int> rw(numres), rh(numres);
  for (int r = 0; r < numres; ++r) {
    int s = numres - 1 - r;
    rw[r] = (w + (1 << s) - 1) >> s;
    rh[r] = (h + (1 << s) - 1) >> s;
  }
  std::vector<std::vector<EncRes>> tile(nc, std::vector<EncRes>(numres));
  std::vector<int32_t> a(static_cast<size_t>(w) * h), col, tmp, blk;
  for (int c = 0; c < nc; ++c) {
    const int32_t* src = samples + static_cast<int64_t>(c) * w * h;
    for (size_t k = 0; k < a.size(); ++k) a[k] = src[k] - (1 << (prec - 1));
    for (int r = numres - 1; r >= 1; --r) {
      int W = rw[r], H = rh[r];
      col.resize(H);
      for (int x = 0; x < W; ++x) {
        for (int y = 0; y < H; ++y) col[y] = a[static_cast<size_t>(y) * w + x];
        fdwt53(col.data(), H, tmp);
        for (int y = 0; y < H; ++y) a[static_cast<size_t>(y) * w + x] = col[y];
      }
      for (int y = 0; y < H; ++y) fdwt53(&a[static_cast<size_t>(y) * w], W, tmp);
    }
    for (int r = 0; r < numres; ++r) {
      EncRes& res = tile[c][r];
      int pw = r ? rw[r - 1] : 0, ph = r ? rh[r - 1] : 0;
      for (int orient = r ? 1 : 0; orient < (r ? 4 : 1); ++orient) {
        EncBand b;
        b.orient = orient;
        int gain = orient == 0 ? 0 : orient == 3 ? 2 : 1;
        b.numbps = prec + gain + 1;  // expn + guard bits - 1
        b.ox = orient & 1 ? pw : 0;
        b.oy = orient & 2 ? ph : 0;
        b.bw = orient == 0 ? rw[0] : orient & 1 ? rw[r] - pw : pw;
        b.bh = orient == 0 ? rh[0] : orient & 2 ? rh[r] - ph : ph;
        b.cw = (b.bw + 63) / 64;
        b.ch = (b.bh + 63) / 64;
        b.cblks.resize(static_cast<size_t>(b.cw) * b.ch);
        double norm = kNorms53[orient][numres - 1 - r];
        for (int j = 0; j < b.ch; ++j)
          for (int i = 0; i < b.cw; ++i) {
            T1Enc t1;
            t1.w = std::min(64, b.bw - 64 * i);
            t1.h = std::min(64, b.bh - 64 * j);
            t1.orient = orient;
            t1.style = 0;
            blk.resize(static_cast<size_t>(t1.w) * t1.h);
            for (int y = 0; y < t1.h; ++y)
              for (int x = 0; x < t1.w; ++x)
                blk[y * t1.w + x] = a[static_cast<size_t>(b.oy + 64 * j + y) * w
                                      + b.ox + 64 * i + x];
            t1.encode(blk.data(), norm, b.cblks[j * b.cw + i]);
          }
        res.bands.push_back(std::move(b));
      }
    }
  }
  // the slopes' range, then the bisection (opj_tcd_rateallocate)
  double lo = DBL_MAX, hi = 0;
  for (auto& comp : tile)
    for (EncRes& res : comp)
      for (EncBand& b : res.bands)
        for (EncCblk& cb : b.cblks)
          for (size_t p = 0; p < cb.passes.size(); ++p) {
            int32_t dr = static_cast<int32_t>(
                cb.passes[p].rate - (p ? cb.passes[p - 1].rate : 0));
            double dd = cb.passes[p].dist - (p ? cb.passes[p - 1].dist : 0);
            if (dr == 0) continue;
            double slope = dd / dr;
            lo = std::min(lo, slope);
            hi = std::max(hi, slope);
          }
  double good = -1;
  if (maxlen > 0) {
    std::vector<uint8_t> scratch(static_cast<size_t>(maxlen) + 16);
    double thresh = 0, stable = 0;
    bool fits = false;
    for (int i = 0; i < 128; ++i) {
      thresh = (lo + hi) / 2;
      if (make_layer(tile, thresh) || i == 0)
        fits = encode_packets(tile, numres, scratch.data(), maxlen) >= 0;
      if (fits) {
        hi = thresh;
        stable = thresh;
      } else {
        lo = thresh;
      }
    }
    good = stable == 0 ? thresh : stable;
  }
  make_layer(tile, good);
  return encode_packets(tile, numres, dst, cap);
}
