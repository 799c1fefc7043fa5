// Byte- and bit-serial parts of the image codecs of `rnb_neus2_torch/io/`:
// what numpy cannot vectorize because each step depends on the one before.
//
//   lzw_decode / lzw_encode       TIFF LZW (TIFF 6.0 section 13; MSB-first
//                                  codes of 9-12 bits, "early change")
//   packbits_decode / _encode     TIFF PackBits (section 9), row by row
//   exr_rle_decode                OpenEXR RLE (signed run counts)
//   jpeg_decode_scan              one sequential Huffman scan (ITU T.81
//                                  F.2) into dequantizable coefficients
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

// Decode one scan. bits: n_tables x 16, vals: n_tables x 256; comp_dc /
// comp_ac: the table of each scan component; block_comp[b]: the scan
// component of block b of an MCU; block_row[m * blocks_per_mcu + b]: the
// row of coefs (n x 64, natural order) that block goes to. Returns the
// position of the marker that ends the scan; -1 bad table, -2 bad code,
// -3 missing restart marker, -4 data ran out.
extern "C" int64_t jpeg_decode_scan(
    const uint8_t* data, int64_t n, int64_t pos, int64_t n_mcus,
    int32_t blocks_per_mcu, const int32_t* block_comp,
    const int64_t* block_row, const int32_t* comp_dc,
    const int32_t* comp_ac, int32_t n_tables, const uint8_t* bits,
    const uint8_t* vals, int32_t restart_interval, int16_t* coefs) {
  std::vector<HuffTable> tables(n_tables);
  for (int t = 0; t < n_tables; ++t)
    if (!tables[t].build(bits + 16 * t, vals + 256 * t)) return -1;
  BitReader br{data, n, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      int64_t p = br.pos;  // the reader stops at the marker
      while (p < n && data[p] != 0xFF) ++p;
      while (p + 1 < n && data[p + 1] == 0xFF) ++p;
      if (p + 1 >= n || data[p + 1] != 0xD0 + next_rst) return -3;
      next_rst = (next_rst + 1) & 7;
      br.restart(p + 2);
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
    if (br.fake > br.cnt) return -4;  // zeros past the data were decoded
  }
  // the next marker: skip the rest of the data (padding bits, fill bytes)
  int64_t p = br.pos;
  while (p + 1 < n) {
    if (data[p] == 0xFF && data[p + 1] != 0 && data[p + 1] != 0xFF &&
        !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7))
      return p;
    ++p;
  }
  return n;
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
