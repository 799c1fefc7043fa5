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
//
// Every function returns a byte count or position, or a negative error
// code the Python side turns into a ValueError naming the file.
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <vector>

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
