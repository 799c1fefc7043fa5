// AV1 film grain synthesis (specification 7.18.3) for native/av1.cc, as
// libaom's av1_add_film_grain applies it to the frame it hands libavif:
// the seeded shift-register generator, the luma (73x82) and chroma grain
// templates from the Gaussian sequence with their auto-regressive
// filter, the piecewise-linear scaling look-up, the grain laid in 32x32
// luma blocks at random offsets with their 2-sample overlaps blended,
// then added to chroma (scaled by the merged luma and chroma) and to
// luma, and clipped to the full or the restricted range.
#pragma once
#include <algorithm>
#include <cstdint>
#include <vector>

#include "av1_tables.h"

namespace av1 {

struct FilmGrain {
    int apply = 0, seed = 0, numY = 0, numCb = 0, numCr = 0;
    int pointY[16][2] = {{0}}, pointCb[16][2] = {{0}}, pointCr[16][2] = {{0}};
    int chromaFromLuma = 0, scalingMinus8 = 0, arLag = 0, arShiftMinus6 = 0, scaleShift = 0;
    int arY[24] = {0}, arCb[25] = {0}, arCr[25] = {0};   // minus 128
    int cbMult = 0, cbLumaMult = 0, cbOffset = 0, crMult = 0, crLumaMult = 0, crOffset = 0;
    int overlap = 0, clipRestricted = 0;
};

class GrainSynthesis {
public:
    GrainSynthesis(const FilmGrain& p, int bitDepth, int mono, int ssx, int ssy)
        : p_(p), bd_(bitDepth), mono_(mono), ssx_(ssx), ssy_(ssy) {
        grainMin_ = -(128 << (bd_ - 8));
        grainMax_ = (128 << (bd_ - 8)) - 1;
        chromaW_ = ssx_ ? 44 : 82;
        chromaH_ = ssy_ ? 38 : 73;
        generate();
        for (int plane = 0; plane < 3; plane++) scaling_lut(plane);
    }

    // planes[3] with strides (samples), w x h luma samples
    void apply(uint16_t* const planes[3], const int strides[3], int w, int h, int mcIdentity) {
        int numPlanes = mono_ ? 1 : 3;
        int stripes = (h + 31) / 32 + 1;
        int stripeW = w + 80;
        // noiseStripe[lumaNum][plane][i][x], 34 rows a stripe
        std::vector<int> stripe((size_t)stripes * 3 * 34 * stripeW, 0);
        auto ns = [&](int lumaNum, int plane, int i, int x) -> int& {
            return stripe[(((size_t)lumaNum * 3 + plane) * 34 + i) * stripeW + x];
        };
        int lumaNum = 0;
        for (int y = 0; y < (h + 1) / 2; y += 16) {
            rng_ = p_.seed;
            rng_ ^= ((lumaNum * 37 + 178) & 255) << 8;
            rng_ ^= ((lumaNum * 173 + 105) & 255);
            for (int x = 0; x < (w + 1) / 2; x += 16) {
                int r = random(8);
                int offX = r >> 4, offY = r & 15;
                for (int plane = 0; plane < numPlanes; plane++) {
                    int sx = plane ? ssx_ : 0, sy = plane ? ssy_ : 0;
                    int pox = sx ? 6 + offX : 9 + offX * 2;
                    int poy = sy ? 6 + offY : 9 + offY * 2;
                    for (int i = 0; i < (34 >> sy); i++)
                        for (int j = 0; j < (34 >> sx); j++) {
                            int g = grain(plane, poy + i, pox + j);
                            if (sx == 0) {
                                int& dst = ns(lumaNum, plane, i, x * 2 + j);
                                if (j < 2 && p_.overlap && x > 0) {
                                    int old = dst;
                                    g = j == 0 ? old * 27 + g * 17 : old * 17 + g * 27;
                                    g = clip3(grainMin_, grainMax_, round2(g, 5));
                                }
                                dst = g;
                            } else {
                                int& dst = ns(lumaNum, plane, i, x + j);
                                if (j == 0 && p_.overlap && x > 0) {
                                    int old = dst;
                                    g = old * 23 + g * 22;
                                    g = clip3(grainMin_, grainMax_, round2(g, 5));
                                }
                                dst = g;
                            }
                        }
                }
            }
            lumaNum++;
        }
        // the noise image, the stripes' 2-row overlaps blended
        std::vector<int> noise[3];
        for (int plane = 0; plane < numPlanes; plane++) {
            int sx = plane ? ssx_ : 0, sy = plane ? ssy_ : 0;
            int pw = (w + sx) >> sx, ph = (h + sy) >> sy;
            noise[plane].assign((size_t)pw * ph, 0);
            for (int y = 0; y < ph; y++) {
                int ln = y >> (5 - sy), i = y - (ln << (5 - sy));
                for (int x = 0; x < pw; x++) {
                    int g = ns(ln, plane, i, x);
                    if (sy == 0) {
                        if (i < 2 && ln > 0 && p_.overlap) {
                            int old = ns(ln - 1, plane, i + 32, x);
                            g = i == 0 ? old * 27 + g * 17 : old * 17 + g * 27;
                            g = clip3(grainMin_, grainMax_, round2(g, 5));
                        }
                    } else if (i < 1 && ln > 0 && p_.overlap) {
                        int old = ns(ln - 1, plane, i + 16, x);
                        g = old * 23 + g * 22;
                        g = clip3(grainMin_, grainMax_, round2(g, 5));
                    }
                    noise[plane][(size_t)y * pw + x] = g;
                }
            }
        }
        // blend
        int minV, maxLuma, maxChroma;
        if (p_.clipRestricted) {
            minV = 16 << (bd_ - 8);
            maxLuma = 235 << (bd_ - 8);
            maxChroma = mcIdentity ? maxLuma : 240 << (bd_ - 8);
        } else {
            minV = 0;
            maxLuma = maxChroma = (256 << (bd_ - 8)) - 1;
        }
        int shift = p_.scalingMinus8 + 8;
        int maxv = (1 << bd_) - 1;
        const uint16_t* Y = planes[0];
        if (numPlanes > 1) {
            int pw = (w + ssx_) >> ssx_, ph = (h + ssy_) >> ssy_;
            for (int y = 0; y < ph; y++)
                for (int x = 0; x < pw; x++) {
                    int lx = x << ssx_, ly = y << ssy_;
                    int lnx = std::min(lx + 1, w - 1);
                    int avg = ssx_ ? round2(Y[(size_t)ly * strides[0] + lx] + Y[(size_t)ly * strides[0] + lnx], 1)
                                   : Y[(size_t)ly * strides[0] + lx];
                    for (int c = 1; c < 3; c++) {
                        int num = c == 1 ? p_.numCb : p_.numCr;
                        if (!(num > 0 || p_.chromaFromLuma)) continue;
                        uint16_t* px = planes[c] + (size_t)y * strides[c] + x;
                        int orig = *px, merged;
                        if (p_.chromaFromLuma) {
                            merged = avg;
                        } else {
                            int mult = (c == 1 ? p_.cbMult : p_.crMult) - 128;
                            int lmult = (c == 1 ? p_.cbLumaMult : p_.crLumaMult) - 128;
                            int off = (c == 1 ? p_.cbOffset : p_.crOffset) - 256;
                            int combined = avg * lmult + orig * mult;
                            merged = clip3(0, maxv, (combined >> 6) + off * (1 << (bd_ - 8)));
                        }
                        int n = round2(scale(c, merged) * noise[c][(size_t)y * pw + x], shift);
                        *px = (uint16_t)clip3(minV, maxChroma, orig + n);
                    }
                }
        }
        if (p_.numY > 0)
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) {
                    uint16_t* px = planes[0] + (size_t)y * strides[0] + x;
                    int orig = *px;
                    int n = round2(scale(0, orig) * noise[0][(size_t)y * w + x], shift);
                    *px = (uint16_t)clip3(minV, maxLuma, orig + n);
                }
    }

private:
    const FilmGrain& p_;
    int bd_, mono_, ssx_, ssy_, grainMin_, grainMax_, chromaW_, chromaH_;
    uint16_t rng_ = 0;
    int luma_[73][82] = {{0}}, cb_[73][82] = {{0}}, cr_[73][82] = {{0}};
    int lut_[3][256] = {{0}};

    static int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
    static int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }

    int random(int bits) {
        unsigned r = rng_;
        unsigned bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
        r = (r >> 1) | (bit << 15);
        rng_ = (uint16_t)r;
        return (int)((r >> (16 - bits)) & ((1u << bits) - 1));
    }

    int grain(int plane, int y, int x) const {
        return plane == 0 ? luma_[y][x] : plane == 1 ? cb_[y][x] : cr_[y][x];
    }

    void generate() {
        int shift = 12 - bd_ + p_.scaleShift;
        rng_ = (uint16_t)p_.seed;
        for (int y = 0; y < 73; y++)
            for (int x = 0; x < 82; x++)
                luma_[y][x] = p_.numY > 0 ? round2(k_gaussian_sequence[random(11)], shift) : 0;
        int arShift = p_.arShiftMinus6 + 6, lag = p_.arLag;
        if (p_.numY > 0)
            for (int y = 3; y < 73; y++)
                for (int x = 3; x < 82 - 3; x++) {
                    int sum = 0, pos = 0;
                    for (int dr = -lag; dr <= 0; dr++)
                        for (int dc = -lag; dc <= lag; dc++) {
                            if (dr == 0 && dc == 0) break;
                            sum += luma_[y + dr][x + dc] * p_.arY[pos++];
                        }
                    luma_[y][x] = clip3(grainMin_, grainMax_, luma_[y][x] + round2(sum, arShift));
                }
        if (mono_) return;
        int useCb = p_.numCb > 0 || p_.chromaFromLuma, useCr = p_.numCr > 0 || p_.chromaFromLuma;
        rng_ = (uint16_t)(p_.seed ^ 0xb524);
        for (int y = 0; y < chromaH_; y++)
            for (int x = 0; x < chromaW_; x++)
                cb_[y][x] = useCb ? round2(k_gaussian_sequence[random(11)], shift) : 0;
        rng_ = (uint16_t)(p_.seed ^ 0x49d8);
        for (int y = 0; y < chromaH_; y++)
            for (int x = 0; x < chromaW_; x++)
                cr_[y][x] = useCr ? round2(k_gaussian_sequence[random(11)], shift) : 0;
        for (int y = 3; y < chromaH_; y++)
            for (int x = 3; x < chromaW_ - 3; x++) {
                int sum0 = 0, sum1 = 0, pos = 0;
                for (int dr = -lag; dr <= 0; dr++) {
                    bool done = false;
                    for (int dc = -lag; dc <= lag; dc++) {
                        int c0 = p_.arCb[pos], c1 = p_.arCr[pos];
                        if (dr == 0 && dc == 0) {
                            if (p_.numY > 0) {
                                int luma = 0;
                                int lx = ((x - 3) << ssx_) + 3, ly = ((y - 3) << ssy_) + 3;
                                for (int i = 0; i <= ssy_; i++)
                                    for (int j = 0; j <= ssx_; j++) luma += luma_[ly + i][lx + j];
                                luma = round2(luma, ssx_ + ssy_);
                                sum0 += luma * c0;
                                sum1 += luma * c1;
                            }
                            done = true;
                            break;
                        }
                        sum0 += c0 * cb_[y + dr][x + dc];
                        sum1 += c1 * cr_[y + dr][x + dc];
                        pos++;
                    }
                    if (done) break;
                }
                if (useCb) cb_[y][x] = clip3(grainMin_, grainMax_, cb_[y][x] + round2(sum0, arShift));
                if (useCr) cr_[y][x] = clip3(grainMin_, grainMax_, cr_[y][x] + round2(sum1, arShift));
            }
    }

    void scaling_lut(int plane) {
        const int (*pts)[2] = p_.pointY;
        int n = p_.numY;
        if (plane == 1 && !p_.chromaFromLuma) { pts = p_.pointCb; n = p_.numCb; }
        if (plane == 2 && !p_.chromaFromLuma) { pts = p_.pointCr; n = p_.numCr; }
        int* lut = lut_[plane];
        if (n == 0) { std::fill(lut, lut + 256, 0); return; }
        for (int i = 0; i < pts[0][0]; i++) lut[i] = pts[0][1];
        for (int i = 0; i < n - 1; i++) {
            int dy = pts[i + 1][1] - pts[i][1], dx = pts[i + 1][0] - pts[i][0];
            int64_t delta = (int64_t)dy * ((65536 + (dx >> 1)) / dx);
            for (int x = 0; x < dx; x++) lut[pts[i][0] + x] = pts[i][1] + (int)((x * delta + 32768) >> 16);
        }
        for (int i = pts[n - 1][0]; i < 256; i++) lut[i] = pts[n - 1][1];
    }

    int scale(int plane, int index) const {
        int shift = bd_ - 8, x = index >> shift, rem = index - (x << shift);
        if (bd_ == 8 || x == 255) return lut_[plane][x];
        int start = lut_[plane][x], end = lut_[plane][x + 1];
        return start + round2((end - start) * rem, shift);
    }
};

}  // namespace av1
