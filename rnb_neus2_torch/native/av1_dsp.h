// AV1 reconstruction arithmetic for native/av1.cc: the inverse transforms,
// the deblocking filters, CDEF and loop restoration, each as the AV1
// specification (sections 7.13-7.17) defines it, to the bit.
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace av1 {

static inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
static inline int64_t round2_64(int64_t x, int n) { return n ? (x + ((int64_t)1 << (n - 1))) >> n : x; }
static inline int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }
static inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
static inline int floor_log2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }
static inline int ceil_log2(uint32_t x) { if (x < 2) return 0; int i = 1; uint32_t p = 2; while (p < x) { i++; p <<= 1; } return i; }

// ---------------------------------------------------------------------------
// inverse transforms (7.13.2)
// ---------------------------------------------------------------------------

static const int kCos128[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948,
    3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461,
    3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824, 2751, 2675,
    2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660,
    1567, 1474, 1380, 1285, 1189, 1092, 995, 897, 799, 700, 601, 501,
    401, 301, 201, 101, 0};

static inline int cos128(int angle) {
    int a = angle & 255;
    if (a <= 64) return kCos128[a];
    if (a <= 128) return -kCos128[128 - a];
    if (a <= 192) return -kCos128[a - 128];
    return kCos128[256 - a];
}
static inline int sin128(int angle) { return cos128(angle - 64); }

struct Tx1D {
    int32_t* T;
    int range;  // bits of the clamp applied to sums, as libaom's
    int clampv(int64_t v) const {
        int64_t lo = -((int64_t)1 << (range - 1)), hi = ((int64_t)1 << (range - 1)) - 1;
        return (int)(v < lo ? lo : (v > hi ? hi : v));
    }
    // butterfly rotation B(a, b, angle, flip)
    void B(int a, int b, int angle, int flip) {
        int64_t x = (int64_t)T[a] * cos128(angle) - (int64_t)T[b] * sin128(angle);
        int64_t y = (int64_t)T[a] * sin128(angle) + (int64_t)T[b] * cos128(angle);
        T[a] = (int32_t)round2_64(x, 12);
        T[b] = (int32_t)round2_64(y, 12);
        if (flip) std::swap(T[a], T[b]);
    }
    // Hadamard rotation H(a, b, flip)
    void H(int a, int b, int flip) {
        if (flip) std::swap(a, b);
        int32_t x = T[a], y = T[b];
        T[a] = clampv((int64_t)x + y);
        T[b] = clampv((int64_t)x - y);
    }
};

static inline int brev(int numBits, int x) {
    int r = 0;
    for (int i = 0; i < numBits; i++) r |= ((x >> i) & 1) << (numBits - 1 - i);
    return r;
}

static void idct(int32_t* T, int n, int range) {
    int n0 = 1 << n;
    int32_t c[64];
    for (int i = 0; i < n0; i++) c[i] = T[i];
    for (int i = 0; i < n0; i++) T[i] = c[brev(n, i)];
    Tx1D t{T, range};
    if (n == 6) for (int i = 0; i < 16; i++) t.B(32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
    if (n >= 5) for (int i = 0; i < 8; i++) t.B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
    if (n == 6) for (int i = 0; i < 16; i++) t.H(32 + i * 2, 33 + i * 2, i & 1);
    if (n >= 4) for (int i = 0; i < 4; i++) t.B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
    if (n >= 5) for (int i = 0; i < 8; i++) t.H(16 + 2 * i, 17 + 2 * i, i & 1);
    if (n == 6) for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++)
        t.B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
    if (n >= 3) for (int i = 0; i < 2; i++) t.B(4 + i, 7 - i, 56 - 32 * i, 0);
    if (n >= 4) for (int i = 0; i < 4; i++) t.H(8 + 2 * i, 9 + 2 * i, i & 1);
    if (n >= 5) for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++)
        t.B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
    if (n == 6) for (int i = 0; i < 8; i++) for (int j = 0; j < 2; j++)
        t.H(32 + i * 4 + j, 35 + i * 4 - j, i & 1);
    for (int i = 0; i < 2; i++) t.B(2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i);
    if (n >= 3) for (int i = 0; i < 2; i++) t.H(4 + 2 * i, 5 + 2 * i, i);
    if (n >= 4) for (int i = 0; i < 2; i++) t.B(14 - i, 9 + i, 48 + 64 * i, 1);
    if (n >= 5) for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++)
        t.H(16 + 4 * i + j, 19 + 4 * i - j, i & 1);
    if (n == 6) for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++)
        t.B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
    for (int i = 0; i < 2; i++) t.H(i, 3 - i, 0);
    if (n >= 3) t.B(6, 5, 32, 1);
    if (n >= 4) for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++)
        t.H(8 + 4 * i + j, 11 + 4 * i - j, i);
    if (n >= 5) for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++)
        t.B(29 - i * 2 - j, 18 + i * 2 + j, 48 + (i << 6), 1);
    if (n == 6) for (int i = 0; i < 4; i++) for (int j = 0; j < 4; j++)
        t.H(32 + 8 * i + j, 39 + 8 * i - j, i & 1);
    if (n >= 3) for (int i = 0; i < 4; i++) t.H(i, 7 - i, 0);
    if (n >= 4) for (int i = 0; i < 2; i++) t.B(13 - i, 10 + i, 32, 1);
    if (n >= 5) for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++)
        t.H(16 + i * 8 + j, 23 + i * 8 - j, i);
    if (n == 6) for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++)
        t.B(59 - i * 4 - j, 36 + i * 4 + j, 48 + (i << 6), 1);
    if (n >= 4) for (int i = 0; i < 8; i++) t.H(i, 15 - i, 0);
    if (n >= 5) for (int i = 0; i < 4; i++) t.B(27 - i, 20 + i, 32, 1);
    if (n == 6) {
        for (int i = 0; i < 8; i++) t.H(32 + i, 47 - i, 0);
        for (int i = 0; i < 8; i++) t.H(48 + i, 63 - i, 1);
    }
    if (n >= 5) for (int i = 0; i < 16; i++) t.H(i, 31 - i, 0);
    if (n == 6) for (int i = 0; i < 8; i++) t.B(55 - i, 40 + i, 32, 1);
    if (n == 6) for (int i = 0; i < 32; i++) t.H(i, 63 - i, 0);
}

static inline int32_t half_btf(int w0, int32_t in0, int w1, int32_t in1) {
    return (int32_t)round2_64((int64_t)w0 * in0 + (int64_t)w1 * in1, 12);
}

static void iadst4(int32_t* T) {
    const int64_t s1_9 = 1321, s2_9 = 2482, s3_9 = 3344, s4_9 = 3803;
    int64_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
    int64_t s0 = s1_9 * x0, s1 = s2_9 * x0, s2 = s3_9 * x1, s3 = s4_9 * x2;
    int64_t s4 = s1_9 * x2, s5 = s2_9 * x3, s6 = s4_9 * x3;
    int64_t s7 = (x0 - x2) + x3;
    s0 = s0 + s3; s1 = s1 - s4; s3 = s2; s2 = s3_9 * s7;
    s0 = s0 + s5; s1 = s1 - s6;
    int64_t y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = s0 + s1;
    y3 = y3 - s3;
    T[0] = (int32_t)round2_64(y0, 12); T[1] = (int32_t)round2_64(y1, 12);
    T[2] = (int32_t)round2_64(y2, 12); T[3] = (int32_t)round2_64(y3, 12);
}

static inline int cospi(int i) { return cos128(i); }

static void iadst8(int32_t* T, int range) {
    Tx1D t{T, range};
    int32_t x[8], y[8];
    x[0] = T[7]; x[1] = T[0]; x[2] = T[5]; x[3] = T[2];
    x[4] = T[3]; x[5] = T[4]; x[6] = T[1]; x[7] = T[6];
    for (int i = 0; i < 4; i++) {
        int a = 4 + 16 * i;
        y[2 * i] = half_btf(cospi(a), x[2 * i], cospi(64 - a), x[2 * i + 1]);
        y[2 * i + 1] = half_btf(cospi(64 - a), x[2 * i], -cospi(a), x[2 * i + 1]);
    }
    for (int i = 0; i < 4; i++) { x[i] = t.clampv((int64_t)y[i] + y[i + 4]); x[i + 4] = t.clampv((int64_t)y[i] - y[i + 4]); }
    y[0] = x[0]; y[1] = x[1]; y[2] = x[2]; y[3] = x[3];
    y[4] = half_btf(cospi(16), x[4], cospi(48), x[5]);
    y[5] = half_btf(cospi(48), x[4], -cospi(16), x[5]);
    y[6] = half_btf(-cospi(48), x[6], cospi(16), x[7]);
    y[7] = half_btf(cospi(16), x[6], cospi(48), x[7]);
    for (int b = 0; b < 8; b += 4) for (int i = 0; i < 2; i++) {
        x[b + i] = t.clampv((int64_t)y[b + i] + y[b + i + 2]);
        x[b + i + 2] = t.clampv((int64_t)y[b + i] - y[b + i + 2]);
    }
    y[0] = x[0]; y[1] = x[1]; y[4] = x[4]; y[5] = x[5];
    y[2] = half_btf(cospi(32), x[2], cospi(32), x[3]);
    y[3] = half_btf(cospi(32), x[2], -cospi(32), x[3]);
    y[6] = half_btf(cospi(32), x[6], cospi(32), x[7]);
    y[7] = half_btf(cospi(32), x[6], -cospi(32), x[7]);
    T[0] = y[0]; T[1] = -y[4]; T[2] = y[6]; T[3] = -y[2];
    T[4] = y[3]; T[5] = -y[7]; T[6] = y[5]; T[7] = -y[1];
}

static void iadst16(int32_t* T, int range) {
    Tx1D t{T, range};
    int32_t x[16], y[16];
    static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
    for (int i = 0; i < 16; i++) x[i] = T[perm[i]];
    for (int i = 0; i < 8; i++) {
        int a = 2 + 8 * i;
        y[2 * i] = half_btf(cospi(a), x[2 * i], cospi(64 - a), x[2 * i + 1]);
        y[2 * i + 1] = half_btf(cospi(64 - a), x[2 * i], -cospi(a), x[2 * i + 1]);
    }
    for (int i = 0; i < 8; i++) { x[i] = t.clampv((int64_t)y[i] + y[i + 8]); x[i + 8] = t.clampv((int64_t)y[i] - y[i + 8]); }
    for (int i = 0; i < 8; i++) y[i] = x[i];
    y[8] = half_btf(cospi(8), x[8], cospi(56), x[9]);
    y[9] = half_btf(cospi(56), x[8], -cospi(8), x[9]);
    y[10] = half_btf(cospi(40), x[10], cospi(24), x[11]);
    y[11] = half_btf(cospi(24), x[10], -cospi(40), x[11]);
    y[12] = half_btf(-cospi(56), x[12], cospi(8), x[13]);
    y[13] = half_btf(cospi(8), x[12], cospi(56), x[13]);
    y[14] = half_btf(-cospi(24), x[14], cospi(40), x[15]);
    y[15] = half_btf(cospi(40), x[14], cospi(24), x[15]);
    for (int b = 0; b < 16; b += 8) for (int i = 0; i < 4; i++) {
        x[b + i] = t.clampv((int64_t)y[b + i] + y[b + i + 4]);
        x[b + i + 4] = t.clampv((int64_t)y[b + i] - y[b + i + 4]);
    }
    for (int i = 0; i < 16; i++) y[i] = x[i];
    for (int b = 0; b < 16; b += 8) {
        y[b + 4] = half_btf(cospi(16), x[b + 4], cospi(48), x[b + 5]);
        y[b + 5] = half_btf(cospi(48), x[b + 4], -cospi(16), x[b + 5]);
        y[b + 6] = half_btf(-cospi(48), x[b + 6], cospi(16), x[b + 7]);
        y[b + 7] = half_btf(cospi(16), x[b + 6], cospi(48), x[b + 7]);
    }
    for (int b = 0; b < 16; b += 4) for (int i = 0; i < 2; i++) {
        x[b + i] = t.clampv((int64_t)y[b + i] + y[b + i + 2]);
        x[b + i + 2] = t.clampv((int64_t)y[b + i] - y[b + i + 2]);
    }
    for (int i = 0; i < 16; i++) y[i] = x[i];
    for (int b = 0; b < 16; b += 4) {
        y[b + 2] = half_btf(cospi(32), x[b + 2], cospi(32), x[b + 3]);
        y[b + 3] = half_btf(cospi(32), x[b + 2], -cospi(32), x[b + 3]);
    }
    T[0] = y[0]; T[1] = -y[8]; T[2] = y[12]; T[3] = -y[4];
    T[4] = y[6]; T[5] = -y[14]; T[6] = y[10]; T[7] = -y[2];
    T[8] = y[3]; T[9] = -y[11]; T[10] = y[15]; T[11] = -y[7];
    T[12] = y[5]; T[13] = -y[13]; T[14] = y[9]; T[15] = -y[1];
}

static void iidentity(int32_t* T, int n) {
    int n0 = 1 << n;
    for (int i = 0; i < n0; i++) {
        int64_t v = T[i];
        if (n == 2) T[i] = (int32_t)round2_64(v * 5793, 12);
        else if (n == 3) T[i] = (int32_t)(v * 2);
        else if (n == 4) T[i] = (int32_t)round2_64(v * 11586, 12);
        else T[i] = (int32_t)(v * 4);
    }
}

static void iwht(int32_t* T, int shift) {
    int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
    a += c; d -= b;
    int32_t e = (a - d) >> 1;
    b = e - b; c = e - c;
    a -= b; d += c;
    T[0] = a; T[1] = b; T[2] = c; T[3] = d;
}

// 1-D kinds: 0 DCT, 1 ADST, 2 flipped ADST, 3 identity
static void inverse_1d(int32_t* T, int kind, int n, int range) {
    if (kind == 0) idct(T, n, range);
    else if (kind == 3) iidentity(T, n);
    else {
        if (n == 2) iadst4(T);
        else if (n == 3) iadst8(T, range);
        else iadst16(T, range);
    }
}

// tx_type -> (vertical kind, horizontal kind)
static const int kTxVert[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3};
static const int kTxHorz[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2};

// Residual of a w x h block (log2W, log2H) from the dequantized
// coefficients `coef` (row by row, width min(w, 32)); adds it to `dst`.
static void inverse_transform_add(const int32_t* coef, int log2W, int log2H, int txType,
                                  int lossless, int rowShift, int bd,
                                  uint16_t* dst, int stride) {
    int w = 1 << log2W, h = 1 << log2H;
    int tw = std::min(32, w);
    static thread_local int32_t R[64 * 64];
    int32_t T[64];
    int maxv = (1 << bd) - 1;
    if (lossless) {
        for (int i = 0; i < 4; i++) {
            for (int j = 0; j < 4; j++) T[j] = coef[i * 4 + j];
            iwht(T, 2);
            for (int j = 0; j < 4; j++) R[i * 4 + j] = T[j];
        }
        for (int j = 0; j < 4; j++) {
            for (int i = 0; i < 4; i++) T[i] = R[i * 4 + j];
            iwht(T, 0);
            for (int i = 0; i < 4; i++) {
                uint16_t* p = dst + i * stride + j;
                *p = (uint16_t)clip3(0, maxv, *p + T[i]);
            }
        }
        return;
    }
    int vk = kTxVert[txType], hk = kTxHorz[txType];
    int flipUD = vk == 2, flipLR = hk == 2;
    int rowRange = bd + 8, colRange = std::max(bd + 6, 16);
    int rowLo = -(1 << (rowRange - 1)), rowHi = (1 << (rowRange - 1)) - 1;
    int colLo = -(1 << (colRange - 1)), colHi = (1 << (colRange - 1)) - 1;
    int rect = std::abs(log2W - log2H) == 1;
    int hmax = std::min(32, h);
    for (int i = 0; i < h; i++) {
        if (i >= hmax) { for (int j = 0; j < w; j++) R[i * w + j] = 0; continue; }
        for (int j = 0; j < w; j++) T[j] = j < tw ? coef[i * tw + j] : 0;
        if (rect) for (int j = 0; j < w; j++) T[j] = (int32_t)round2_64((int64_t)T[j] * 2896, 12);
        for (int j = 0; j < w; j++) T[j] = clip3(rowLo, rowHi, T[j]);
        inverse_1d(T, hk, log2W, rowRange);
        for (int j = 0; j < w; j++) R[i * w + j] = (int32_t)round2_64(T[j], rowShift);
    }
    for (int i = 0; i < h; i++) for (int j = 0; j < w; j++)
        R[i * w + j] = clip3(colLo, colHi, R[i * w + j]);
    for (int j = 0; j < w; j++) {
        int jj = flipLR ? w - 1 - j : j;
        for (int i = 0; i < h; i++) T[i] = R[i * w + jj];
        inverse_1d(T, vk, log2H, colRange);
        for (int i = 0; i < h; i++) {
            int v = (int)round2_64(T[flipUD ? h - 1 - i : i], 4);
            uint16_t* p = dst + i * stride + j;
            *p = (uint16_t)clip3(0, maxv, *p + v);
        }
    }
}

// ---------------------------------------------------------------------------
// deblocking (7.14.6): libaom's 4-, 6-, 8- and 14-tap filters
// ---------------------------------------------------------------------------

struct LfParams { int limit, blimit, thresh; };

static inline int sclamp(int t, int bd) {
    int lim = 128 << (bd - 8);
    return clip3(-lim, lim - 1, t);
}

// s points at q0; step is the distance between taps across the edge
static void lf_filter4(uint16_t* s, int step, int hev, int mask, int bd) {
    if (!mask) return;
    int off = 0x80 << (bd - 8);
    int ps1 = s[-2 * step] - off, ps0 = s[-step] - off, qs0 = s[0] - off, qs1 = s[step] - off;
    int filter = hev ? sclamp(ps1 - qs1, bd) : 0;
    filter = sclamp(filter + 3 * (qs0 - ps0), bd);
    int f1 = sclamp(filter + 4, bd) >> 3;
    int f2 = sclamp(filter + 3, bd) >> 3;
    s[0] = (uint16_t)(sclamp(qs0 - f1, bd) + off);
    s[-step] = (uint16_t)(sclamp(ps0 + f2, bd) + off);
    if (!hev) {
        int f = round2(f1, 1);
        s[step] = (uint16_t)(sclamp(qs1 - f, bd) + off);
        s[-2 * step] = (uint16_t)(sclamp(ps1 + f, bd) + off);
    }
}

// one sample position across an edge; size 4, 6, 8 or 14
static void lf_sample(uint16_t* s, int step, int size, const LfParams& lp, int bd) {
    int sh = bd - 8;
    int limit = lp.limit << sh, blimit = lp.blimit << sh, thresh = lp.thresh << sh;
    int one = 1 << sh;
    auto P = [&](int i) { return (int)s[-(i + 1) * step]; };
    auto Q = [&](int i) { return (int)s[i * step]; };
    int p0 = P(0), p1 = P(1), q0 = Q(0), q1 = Q(1);
    int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    int mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
               std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
    if (size == 4) { lf_filter4(s, step, hev, mask, bd); return; }
    int p2 = P(2), q2 = Q(2);
    mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
    if (size == 6) {
        int flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one &&
                   std::abs(p2 - p0) <= one && std::abs(q2 - q0) <= one;
        if (flat && mask) {
            s[-2 * step] = (uint16_t)round2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3);
            s[-step] = (uint16_t)round2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3);
            s[0] = (uint16_t)round2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3);
            s[step] = (uint16_t)round2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3);
        } else lf_filter4(s, step, hev, mask, bd);
        return;
    }
    int p3 = P(3), q3 = Q(3);
    mask = mask && std::abs(p3 - p2) <= limit && std::abs(q3 - q2) <= limit;
    int flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one &&
               std::abs(p2 - p0) <= one && std::abs(q2 - q0) <= one &&
               std::abs(p3 - p0) <= one && std::abs(q3 - q0) <= one;
    int flat2 = 0;
    if (size == 14) {
        int p4 = P(4), p5 = P(5), p6 = P(6), q4 = Q(4), q5 = Q(5), q6 = Q(6);
        flat2 = std::abs(p4 - p0) <= one && std::abs(q4 - q0) <= one &&
                std::abs(p5 - p0) <= one && std::abs(q5 - q0) <= one &&
                std::abs(p6 - p0) <= one && std::abs(q6 - q0) <= one;
        if (flat2 && flat && mask) {
            int p[7] = {p0, p1, p2, p3, p4, p5, p6}, q[7] = {q0, q1, q2, q3, q4, q5, q6};
            // the 13-tap filter: F[i] for i = -6..5 (i < 0: p side)
            auto F = [&](int k) { return k < 0 ? p[std::min(-k - 1, 6)] : q[std::min(k, 6)]; };
            int out[12];
            for (int i = -6; i < 6; i++) {
                int tsum = 0;
                for (int j = -6; j <= 6; j++) {
                    int pp = clip3(-7, 6, i + j);
                    tsum += F(pp) * ((std::abs(j) <= 1) ? 2 : 1);
                }
                out[i + 6] = round2(tsum, 4);
            }
            for (int i = -6; i < 6; i++) s[i * step] = (uint16_t)out[i + 6];
            return;
        }
    }
    if (flat && mask) {
        s[-3 * step] = (uint16_t)round2(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0, 3);
        s[-2 * step] = (uint16_t)round2(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1, 3);
        s[-step] = (uint16_t)round2(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2, 3);
        s[0] = (uint16_t)round2(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3, 3);
        s[step] = (uint16_t)round2(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3, 3);
        s[2 * step] = (uint16_t)round2(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3, 3);
    } else lf_filter4(s, step, hev, mask, bd);
}

// ---------------------------------------------------------------------------
// CDEF (7.15)
// ---------------------------------------------------------------------------

static const int kCdefDirections[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
    {{1, 1}, {2, 2}}, {{1, 0}, {2, 1}}, {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
static const int kCdefUvDir[2][2][8] = {
    {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
    {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};

static void cdef_direction(const uint16_t* p, int stride, int bd, int* dirOut, int* varOut) {
    static const int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
    int cost[8] = {0}, partial[8][15];
    memset(partial, 0, sizeof(partial));
    for (int i = 0; i < 8; i++) for (int j = 0; j < 8; j++) {
        int x = (p[i * stride + j] >> (bd - 8)) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
    }
    for (int i = 0; i < 8; i++) {
        cost[2] += partial[2][i] * partial[2][i];
        cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= kDiv[8]; cost[6] *= kDiv[8];
    for (int i = 0; i < 7; i++) {
        cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * kDiv[i + 1];
        cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * kDiv[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * kDiv[8];
    cost[4] += partial[4][7] * partial[4][7] * kDiv[8];
    for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
        cost[i] *= kDiv[8];
        for (int j = 0; j < 3; j++)
            cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * kDiv[2 * j + 2];
    }
    int best = 0, dir = 0;
    for (int i = 0; i < 8; i++) if (cost[i] > best) { best = cost[i]; dir = i; }
    *dirOut = dir;
    *varOut = (best - cost[(dir + 4) & 7]) >> 10;
}

static inline int cdef_constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int adj = std::max(0, damping - floor_log2(threshold));
    int val = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
    return diff < 0 ? -val : val;
}

}  // namespace av1
