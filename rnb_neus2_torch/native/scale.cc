// libyuv's plane scaler as libavif's avifImageScaleWithLimit calls it
// (kFilterBox): ScalePlane for 8-bit planes, ScalePlane_12 for 10- and
// 12-bit ones, sample for sample as the libyuv bundled with libavif 1.4
// scales on x86-64. libyuv reduces the filter by the ratio
// (ScaleFilterReduce) and picks a routine by it: a copy, a vertical-only
// blend, 3/4, 1/2, 3/8 and 1/4 down, a box filter below one half, 2x up
// (linear or bilinear), bilinear up or down, or point sampling. Where the
// routine's x86 SIMD rows compute otherwise than libyuv's C rows (the
// 8-bit column filter's 7-bit fraction; the 3/4 and 3/8 box rows, which
// blend the rows before the columns), this follows the SIMD rows for the
// widths they cover and the C rows for the rest, as libyuv's "Any"
// wrappers split a row.
//
// C interface (ctypes, io/native.py):
//   scale_plane(src, sw, sh, dst, dw, dh, deep) -> 0
// src and dst are uint16 planes, row by row without padding; deep = 0
// scales as ScalePlane (8-bit samples), 1 as ScalePlane_12.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Filter { kNone = 0, kLinear = 1, kBilinear = 2, kBox = 3 };

using u16 = uint16_t;

int fixed_div(int num, int div) { return (int)(((int64_t)num << 16) / div); }
int fixed_div1(int num, int div) { return (int)((((int64_t)num << 16) - 0x00010001) / (div - 1)); }
int center_start(int dx, int s) { return dx < 0 ? -((-dx >> 1) + s) : ((dx >> 1) + s); }

Filter reduce(int sw, int sh, int dw, int dh, Filter f) {
    if (f == kBox && (dw * 2 >= sw || dh * 2 >= sh)) f = kBilinear;
    if (f == kBilinear) {
        if (sh == 1) f = kLinear;
        if (dh == sh || dh * 3 == sh) f = kLinear;
        if (sw == 1) f = kNone;
    }
    if (f == kLinear) {
        if (sw == 1) f = kNone;
        if (dw == sw || dw * 3 == sw) f = kNone;
    }
    return f;
}

void slope(int sw, int sh, int dw, int dh, Filter f, int* x, int* y, int* dx, int* dy) {
    if (dw == 1 && sw >= 32768) dw = sw;
    if (dh == 1 && sh >= 32768) dh = sh;
    if (f == kBox) {
        *dx = fixed_div(sw, dw); *dy = fixed_div(sh, dh); *x = 0; *y = 0;
    } else if (f == kBilinear || f == kLinear) {
        if (dw <= sw) { *dx = fixed_div(sw, dw); *x = center_start(*dx, -32768); }
        else if (sw > 1 && dw > 1) { *dx = fixed_div1(sw, dw); *x = 0; }
        if (f == kLinear) { *dy = fixed_div(sh, dh); *y = *dy >> 1; }
        else if (dh <= sh) { *dy = fixed_div(sh, dh); *y = center_start(*dy, -32768); }
        else if (sh > 1 && dh > 1) { *dy = fixed_div1(sh, dh); *y = 0; }
    } else {
        *dx = fixed_div(sw, dw); *dy = fixed_div(sh, dh);
        *x = center_start(*dx, 0); *y = center_start(*dy, 0);
    }
}

struct Scaler {
    const u16* src; int sw, sh; u16* dst; int dw, dh; bool deep;

    const u16* row(int y) const { return src + (size_t)y * sw; }
    u16* out(int y) const { return dst + (size_t)y * dw; }

    // InterpolateRow_C (= the SSSE3/AVX2 rows) and InterpolateRow_16_C
    static void interpolate(u16* d, const u16* s0, const u16* s1, int w, int f) {
        if (f == 0) { memcpy(d, s0, (size_t)w * 2); return; }
        if (f == 128) { for (int i = 0; i < w; i++) d[i] = (u16)((s0[i] + s1[i] + 1) >> 1); return; }
        for (int i = 0; i < w; i++) d[i] = (u16)((s0[i] * (256 - f) + s1[i] * f + 128) >> 8);
    }

    // ScaleFilterCols: SSSE3 (7-bit fraction) for 8-bit, _16_C for deep
    void filter_cols(u16* d, const u16* s, int w, int x, int dx) const {
        for (int j = 0; j < w; j++, x += dx) {
            int xi = x >> 16, a = s[xi], b = s[xi + 1];
            if (deep) {
                int64_t f = x & 0xffff;
                d[j] = (u16)(a + (int)((f * (b - a) + 0x8000) >> 16));
            } else {
                int f = (x >> 9) & 127;
                d[j] = (u16)std::min(255, ((128 - f) * a + f * b + 64) >> 7);
            }
        }
    }

    static void point_cols(u16* d, const u16* s, int w, int x, int dx) {
        for (int j = 0; j < w; j++, x += dx) d[j] = s[x >> 16];
    }

    void vertical(int y, int dy, Filter f) const {
        const int maxY = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
        for (int j = 0; j < dh; j++) {
            if (y > maxY) y = maxY;
            int yi = y >> 16, yf = f ? ((y >> 8) & 255) : 0;
            interpolate(out(j), row(yi), yf ? row(yi + 1) : row(yi), dw, yf);
            y += dy;
        }
    }

    void down2(Filter f) const {
        for (int y = 0; y < dh; y++) {
            const u16 *s = row(2 * y), *t = row(2 * y + 1);
            u16* d = out(y);
            for (int x = 0; x < dw; x++) {
                if (f == kNone) d[x] = t[2 * x + 1];
                else if (f == kLinear) d[x] = (u16)((s[2 * x] + s[2 * x + 1] + 1) >> 1);
                else d[x] = (u16)((s[2 * x] + s[2 * x + 1] + t[2 * x] + t[2 * x + 1] + 2) >> 2);
            }
        }
    }

    void down4(Filter f) const {
        for (int y = 0; y < dh; y++) {
            u16* d = out(y);
            for (int x = 0; x < dw; x++) {
                if (f == kNone) { d[x] = row(4 * y + 2)[4 * x + 2]; continue; }
                int sum = 0;
                for (int r = 0; r < 4; r++) for (int c = 0; c < 4; c++) sum += row(4 * y + r)[4 * x + c];
                d[x] = (u16)((sum + 8) >> 4);
            }
        }
    }

    // ScaleRowDown34_{0,1}_Box: C blends columns then rows; the 8-bit
    // SSSE3 rows (the first dw - dw % 24 outputs) rows then columns
    void row34(const u16* s, const u16* t, u16* d, int w, bool one) const {
        int n = deep ? 0 : w - w % 24;
        for (int x = 0; x < w; x += 3, s += 4, t += 4, d += 3) {
            if (x < n) {
                int v[4];
                for (int i = 0; i < 4; i++) {
                    int m = (s[i] + t[i] + 1) >> 1;
                    v[i] = one ? m : (s[i] + m + 1) >> 1;
                }
                d[0] = (u16)((3 * v[0] + v[1] + 2) >> 2);
                d[1] = (u16)((2 * v[1] + 2 * v[2] + 2) >> 2);
                d[2] = (u16)((v[2] + 3 * v[3] + 2) >> 2);
            } else {
                int a0 = (s[0] * 3 + s[1] + 2) >> 2, a1 = (s[1] + s[2] + 1) >> 1, a2 = (s[2] + s[3] * 3 + 2) >> 2;
                int b0 = (t[0] * 3 + t[1] + 2) >> 2, b1 = (t[1] + t[2] + 1) >> 1, b2 = (t[2] + t[3] * 3 + 2) >> 2;
                if (one) { d[0] = (u16)((a0 + b0 + 1) >> 1); d[1] = (u16)((a1 + b1 + 1) >> 1); d[2] = (u16)((a2 + b2 + 1) >> 1); }
                else { d[0] = (u16)((a0 * 3 + b0 + 2) >> 2); d[1] = (u16)((a1 * 3 + b1 + 2) >> 2); d[2] = (u16)((a2 * 3 + b2 + 2) >> 2); }
            }
        }
    }

    static void point34(const u16* s, u16* d, int w) {
        for (int x = 0; x < w; x += 3, s += 4, d += 3) { d[0] = s[0]; d[1] = s[1]; d[2] = s[3]; }
    }

    void down34(Filter f) const {
        int y = 0, sy = 0;
        auto r0 = [&](int srow, int trow) {
            if (f == kNone) point34(row(srow), out(y), dw);
            else row34(row(srow), row(f == kLinear ? srow : trow), out(y), dw, false);
            y++;
        };
        auto r1 = [&](int srow, int trow) {
            if (f == kNone) point34(row(srow), out(y), dw);
            else row34(row(srow), row(f == kLinear ? srow : trow), out(y), dw, true);
            y++;
        };
        for (; y < dh - 2;) {
            r0(sy, sy + 1); sy++;
            r1(sy, sy + 1); sy++;
            r0(sy + 1, sy); sy += 2;
        }
        if (dh % 3 == 2) { r0(sy, sy + 1); sy++; r1(sy, sy); }
        else if (dh % 3 == 1) r0(sy, sy);
    }

    // ScaleRowDown38_{3,2}_Box over `rows` source rows (one row counted
    // `rows` times where libyuv passes a zero stride); the 8-bit SSSE3
    // 2-row box (the first w - w % 6 outputs) averages the rows first
    void row38(int sy, int rows, bool same, u16* d, int w) const {
        int n = (deep || rows != 2) ? 0 : w - w % 6;
        for (int x = 0, sx = 0; x < w; x += 3, sx += 8) {
            int s0 = 0, s1 = 0, s2 = 0;
            if (x < n) {
                const u16 *a = row(sy) + sx, *b = row(same ? sy : sy + 1) + sx;
                int v[8];
                for (int i = 0; i < 8; i++) v[i] = (a[i] + b[i] + 1) >> 1;
                d[x] = (u16)(((v[0] + v[1] + v[2]) * (65536 / 3)) >> 16);
                d[x + 1] = (u16)(((v[3] + v[4] + v[5]) * (65536 / 3)) >> 16);
                d[x + 2] = (u16)(((v[6] + v[7]) * (65536 / 2)) >> 16);
                continue;
            }
            for (int r = 0; r < rows; r++) {
                const u16* s = row(same ? sy : sy + r) + sx;
                s0 += s[0] + s[1] + s[2]; s1 += s[3] + s[4] + s[5]; s2 += s[6] + s[7];
            }
            int full = rows == 3 ? 65536 / 9 : 65536 / 6, part = rows == 3 ? 65536 / 6 : 65536 / 4;
            d[x] = (u16)((s0 * full) >> 16); d[x + 1] = (u16)((s1 * full) >> 16);
            d[x + 2] = (u16)((s2 * part) >> 16);
        }
    }

    void down38(Filter f) const {
        int y = 0, sy = 0;
        auto r = [&](int rows, bool same) {
            if (f == kNone) {
                const u16* s = row(sy);
                u16* d = out(y);
                for (int x = 0, sx = 0; x < dw; x += 3, sx += 8) { d[x] = s[sx]; d[x + 1] = s[sx + 3]; d[x + 2] = s[sx + 6]; }
            } else row38(sy, rows, same || f == kLinear, out(y), dw);
            y++;
        };
        for (; y < dh - 2;) { r(3, false); sy += 3; r(3, false); sy += 3; r(2, false); sy += 2; }
        if (dh % 3 == 2) { r(3, false); sy += 3; r(3, true); }
        else if (dh % 3 == 1) r(3, true);
    }

    void box() const {
        int x = 0, y = 0, dx = 0, dy = 0;
        const int maxY = sh << 16;
        slope(sw, sh, dw, dh, kBox, &x, &y, &dx, &dy);
        std::vector<uint32_t> sums(sw);
        for (int j = 0; j < dh; j++) {
            int iy = y >> 16;
            y += dy;
            if (y > maxY) y = maxY;
            int boxh = std::max(1, (y >> 16) - iy);
            std::fill(sums.begin(), sums.end(), 0);
            for (int k = 0; k < boxh; k++) {
                const u16* s = row(iy + k);
                for (int i = 0; i < sw; i++) sums[i] += s[i];
            }
            u16* d = out(j);
            if (dx & 0xffff) {
                int minw = dx >> 16;
                int tbl[2] = {65536 / (std::max(1, minw) * boxh), 65536 / (std::max(1, minw + 1) * boxh)};
                int xx = x;
                for (int i = 0; i < dw; i++) {
                    int ix = xx >> 16;
                    xx += dx;
                    int bw = std::max(1, (xx >> 16) - ix);
                    uint32_t sum = 0;
                    for (int k = 0; k < bw; k++) sum += sums[ix + k];
                    d[i] = (u16)((sum * (uint32_t)tbl[bw - minw]) >> 16);
                }
            } else {
                int bw = std::max(1, dx >> 16), scale = 65536 / (bw * boxh), xx = x >> 16;
                for (int i = 0; i < dw; i++, xx += bw) {
                    uint32_t sum = 0;
                    for (int k = 0; k < bw; k++) sum += sums[xx + k];
                    d[i] = (u16)((sum * (uint32_t)scale) >> 16);
                }
            }
        }
    }

    // ScaleRowUp2_Linear (Any): first and last copied, (3, 1) / 4 between
    void up2_row(const u16* s, u16* d) const {
        d[0] = s[0];
        for (int k = 0; k < (dw - 1) / 2; k++) {
            d[1 + 2 * k] = (u16)((3 * s[k] + s[k + 1] + 2) >> 2);
            d[2 + 2 * k] = (u16)((s[k] + 3 * s[k + 1] + 2) >> 2);
        }
        d[dw - 1] = s[(dw - 1) / 2];
    }

    void up2_linear() const {
        if (dh == 1) { up2_row(row((sh - 1) / 2), out(0)); return; }
        int dy = fixed_div(sh - 1, dh - 1), y = (1 << 15) - 1;
        for (int i = 0; i < dh; i++, y += dy) up2_row(row(y >> 16), out(i));
    }

    // ScaleRowUp2_Bilinear (Any) between source rows a and b → two rows
    void up2_bilinear_rows(const u16* a, const u16* b, u16* da, u16* db) const {
        da[0] = (u16)((3 * a[0] + b[0] + 2) >> 2);
        if (db) db[0] = (u16)((a[0] + 3 * b[0] + 2) >> 2);
        for (int k = 0; k < (dw - 1) / 2; k++) {
            int s0 = a[k], s1 = a[k + 1], t0 = b[k], t1 = b[k + 1];
            da[1 + 2 * k] = (u16)((s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4);
            da[2 + 2 * k] = (u16)((s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4);
            if (db) {
                db[1 + 2 * k] = (u16)((s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4);
                db[2 + 2 * k] = (u16)((s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4);
            }
        }
        int m = (dw - 1) / 2;
        da[dw - 1] = (u16)((3 * a[m] + b[m] + 2) >> 2);
        if (db) db[dw - 1] = (u16)((a[m] + 3 * b[m] + 2) >> 2);
    }

    void up2_bilinear() const {
        up2_bilinear_rows(row(0), row(0), out(0), nullptr);
        int y = 1;
        for (int r = 0; r < sh - 1; r++, y += 2) up2_bilinear_rows(row(r), row(r + 1), out(y), out(y + 1));
        if (!(dh & 1)) up2_bilinear_rows(row(sh - 1), row(sh - 1), out(y), nullptr);
    }

    void bilinear_up(Filter f) const {
        int x = 0, y = 0, dx = 0, dy = 0;
        const int maxY = (sh - 1) << 16;
        slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
        std::vector<u16> buf((size_t)dw * 2 + 2);
        u16* rows[2] = {buf.data(), buf.data() + dw + 1};
        auto cols = [&](u16* d, const u16* s) {
            if (f) filter_cols(d, s, dw, x, dx); else point_cols(d, s, dw, x, dx);
        };
        if (y > maxY) y = maxY;
        int yi = y >> 16, srow = yi, lasty = yi, cur = 0;
        cols(rows[0], row(srow));
        if (sh > 1) srow++;
        cols(rows[1], row(srow));
        if (sh > 2) srow++;
        for (int j = 0; j < dh; j++) {
            yi = y >> 16;
            if (yi != lasty) {
                if (y > maxY) { y = maxY; yi = y >> 16; srow = yi; }
                if (yi != lasty) {
                    cols(rows[cur], row(srow));
                    cur ^= 1;
                    lasty = yi;
                    if (y + 65536 < maxY) srow++;
                }
            }
            if (f == kLinear) interpolate(out(j), rows[cur], rows[cur], dw, 0);
            else interpolate(out(j), rows[cur], rows[cur ^ 1], dw, (y >> 8) & 255);
            y += dy;
        }
    }

    void bilinear_down(Filter f) const {
        int x = 0, y = 0, dx = 0, dy = 0;
        const int maxY = (sh - 1) << 16;
        slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
        std::vector<u16> tmp((size_t)sw + 1);
        if (y > maxY) y = maxY;
        for (int j = 0; j < dh; j++) {
            int yi = y >> 16;
            if (f == kLinear) filter_cols(out(j), row(yi), dw, x, dx);
            else {
                int yf = (y >> 8) & 255;
                interpolate(tmp.data(), row(yi), yf ? row(yi + 1) : row(yi), sw, yf);
                filter_cols(out(j), tmp.data(), dw, x, dx);
            }
            y += dy;
            if (y > maxY) y = maxY;
        }
    }

    void simple() const {
        int x = 0, y = 0, dx = 0, dy = 0;
        slope(sw, sh, dw, dh, kNone, &x, &y, &dx, &dy);
        for (int i = 0; i < dh; i++, y += dy) point_cols(out(i), row(y >> 16), dw, x, dx);
    }

    void run() const {
        Filter f = reduce(sw, sh, dw, dh, kBox);
        if (deep && ((f == kLinear && (dw + 1) / 2 == sw)
                     || ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == kBilinear || f == kBox)))) {
            // ScalePlane_12's own 2x paths (the same rows as ScalePlane_16's)
            if (f == kLinear) up2_linear(); else up2_bilinear();
            return;
        }
        if (dw == sw && dh == sh) { memcpy(dst, src, (size_t)sw * sh * 2); return; }
        if (dw == sw && f != kBox) {
            int dy = 0, y = 0;
            if (dh <= sh) { dy = fixed_div(sh, dh); y = center_start(dy, -32768); }
            else if (sh > 1 && dh > 1) dy = fixed_div1(sh, dh);
            vertical(y, dy, f);
            return;
        }
        if (dw <= sw && dh <= sh) {
            if (4 * dw == 3 * sw && 4 * dh == 3 * sh) { down34(f); return; }
            if (2 * dw == sw && 2 * dh == sh) { down2(f); return; }
            if (8 * dw == 3 * sw && 8 * dh == 3 * sh) { down38(f); return; }
            if (4 * dw == sw && 4 * dh == sh && (f == kBox || f == kNone)) { down4(f); return; }
        }
        if (f == kBox && dh * 2 < sh) { box(); return; }
        if ((dw + 1) / 2 == sw && f == kLinear) { up2_linear(); return; }
        if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == kBilinear || f == kBox)) { up2_bilinear(); return; }
        if (f && dh > sh) { bilinear_up(f); return; }
        if (f) { bilinear_down(f); return; }
        simple();
    }
};

}  // namespace

extern "C" int64_t scale_plane(const uint16_t* src, int32_t sw, int32_t sh, uint16_t* dst,
                               int32_t dw, int32_t dh, int32_t deep) {
    if (sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0) return -1;
    Scaler{src, sw, sh, dst, dw, dh, deep != 0}.run();
    return 0;
}
