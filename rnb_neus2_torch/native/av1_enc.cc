// AV1 still-picture encoder for the port's AVIF writer (io/avif.py): one
// 8-bit key frame, monochrome or 4:2:0, as the OBUs of an AVIF item (a
// reduced still-picture sequence header, then a frame OBU) and the frame
// that a decoder reconstructs from them.
//
// The coding decisions are the encoder's own, chosen by rate and
// distortion (J = SSE + lambda * bits, the bits from the frame's CDFs):
// each 64x64 superblock's quantizer (base_q_idx or an offset below it,
// delta_q), its partition (none, horizontal, vertical or split, down to
// 4x4; split or the one half where a block crosses the frame's edge, as
// the syntax forces), the luma mode (DC, the directional modes with their
// angle deltas, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH) and the chroma mode of
// each block, the modes first ranked by the SAD of their predictions.
// A block skips its residual where all its coefficients quantize to 0.
// Transforms are the largest of each block (TX_MODE_LARGEST): DCT_DCT for
// luma, for chroma the type its mode implies. Coefficients are rounded to
// the nearest multiple of the block's dc_q / ac_q; chroma is quantized 16
// steps finer than luma, as libaom does at cv2's settings. The frame
// header disables CDF updates, the loop
// filter, CDEF and loop restoration, so the reconstruction is the
// prediction plus the residual; both come from native/av1_common.h and
// native/av1_dsp.h, the code native/av1.cc decodes with. The symbols go
// through the range encoder (the inverse of av1.cc's SymDec, as libaom's
// od_ec_enc writes them); a frame wider than 4096 samples or larger than
// 4096x2304 is split into the fewest uniform tiles the syntax allows.
//
// C interface (ctypes, io/native.py):
//   av1_encode(y, u, v, width, height, mono, qindex, cp, tc, mc, out, cap,
//              recon, level) -> bytes written, or < 0
// y, u, v: 8-bit planes, row by row (u and v (width + 1) / 2 x
// (height + 1) / 2, ignored when mono); cp, tc, mc: the colour
// description (2, 2, 2 writes none), always full range; recon receives the reconstructed Y,
// then U and V; level[0] the sequence header's seq_level_idx. -(bytes
// needed) - 1000 when cap is too small; -1 for a size or quantizer the
// encoder does not take.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "av1_common.h"

using namespace av1;

namespace {

// ---------------------------------------------------------------- bits
struct BitWriter {
    std::vector<uint8_t> d;
    size_t n = 0;
    void f(uint32_t v, int k) {
        for (int i = k - 1; i >= 0; i--) {
            if ((n & 7) == 0) d.push_back(0);
            d.back() |= (uint8_t)(((v >> i) & 1) << (7 - (n & 7)));
            n++;
        }
    }
    void align() { while (n & 7) f(0, 1); }
    void trailing() { f(1, 1); align(); }
};

static void leb128(std::vector<uint8_t>& out, size_t v) {
    do {
        uint8_t b = v & 0x7F;
        v >>= 7;
        out.push_back(b | (v ? 0x80 : 0));
    } while (v);
}

static void obu(std::vector<uint8_t>& out, int type, const std::vector<uint8_t>& payload) {
    out.push_back((uint8_t)((type << 3) | 2));   // obu_has_size_field
    leb128(out, payload.size());
    out.insert(out.end(), payload.begin(), payload.end());
}

// ---------------------------------------------------------------- the range encoder
// libaom's od_ec_enc: symbols on inverse CDFs (32768 - cdf), a carry
// buffer, and od_ec_enc_done's flush, which leaves the trailing one bit
// the decoder checks
struct SymEnc {
    std::vector<uint16_t> pre;
    uint64_t low = 0;
    uint32_t rng = 0x8000;
    int cnt = -9;
    void normalize(uint64_t l, uint32_t r) {
        int d = 16 - (floor_log2(r) + 1);
        int c = cnt, s = c + d;
        if (s >= 0) {
            c += 16;
            uint64_t m = ((uint64_t)1 << c) - 1;
            if (s >= 8) {
                pre.push_back((uint16_t)(l >> c));
                l &= m;
                c -= 8;
                m >>= 8;
            }
            pre.push_back((uint16_t)(l >> c));
            s = c + d - 24;
            l &= m;
        }
        low = l << d;
        rng = r << d;
        cnt = s;
    }
    void encode(uint32_t fl, uint32_t fh, int s, int nsyms) {
        uint64_t l = low;
        uint32_t r = rng;
        int N = nsyms - 1;
        if (fl < 32768) {
            uint32_t u = (((r >> 8) * (fl >> 6)) >> 1) + 4 * (uint32_t)(N - (s - 1));
            uint32_t v = (((r >> 8) * (fh >> 6)) >> 1) + 4 * (uint32_t)(N - s);
            l += r - u;
            r = u - v;
        } else {
            r -= (((r >> 8) * (fh >> 6)) >> 1) + 4 * (uint32_t)(N - s);
        }
        normalize(l, r);
    }
    void symbol(const uint16_t* icdf, int N, int s) { encode(s > 0 ? icdf[s - 1] : 32768, icdf[s], s, N); }
    std::vector<uint8_t> done() {
        uint64_t l = low, m = 0x3FFF;
        int c = cnt, s = 10 + c;
        uint64_t e = ((l + m) & ~m) | (m + 1);
        std::vector<uint16_t> buf = pre;
        if (s > 0) {
            uint64_t n = ((uint64_t)1 << (c + 16)) - 1;
            do {
                buf.push_back((uint16_t)(e >> (c + 16)));
                e &= n;
                s -= 8;
                c -= 8;
                n >>= 8;
            } while (s > 0);
        }
        std::vector<uint8_t> out(buf.size());
        uint32_t carry = 0;
        for (size_t i = buf.size(); i-- > 0;) {
            carry += buf[i];
            out[i] = (uint8_t)carry;
            carry >>= 8;
        }
        return out;
    }
};

// -log2(p) of a probability p * 32768
struct CostTable {
    float c[32769];
    CostTable() {
        c[0] = 24.0f;
        for (int i = 1; i <= 32768; i++) c[i] = (float)-std::log2(i / 32768.0);
    }
};
static const CostTable& costs() { static const CostTable t; return t; }

// the symbols of a tile, written or only counted
struct Coder {
    SymEnc* enc = nullptr;
    double bits = 0;
    void sym(const uint16_t* icdf, int N, int s) {
        if (enc) { enc->symbol(icdf, N, s); return; }
        int hi = s > 0 ? icdf[s - 1] : 32768;
        bits += costs().c[std::max(hi - (int)icdf[s], 1)];
    }
    void bit(int b) {
        static const uint16_t half[2] = {16384, 0};
        if (enc) enc->symbol(half, 2, b); else bits += 1;
    }
    void literal(uint32_t v, int k) { for (int i = k - 1; i >= 0; i--) bit((v >> i) & 1); }
};

// ---------------------------------------------------------------- forward transforms
// The forward 1-D transforms are the inverses of the decoder's own 1-D
// inverse transforms (av1_dsp.h: inverse_1d), taken as linear maps, so the
// coefficients are on the scale the decoder reconstructs from.
struct ForwardBases {
    std::vector<double> m[2][7];   // [DCT, ADST][log2 size]: coefficient k from sample i at k * n + i
    ForwardBases() {
        for (int kind = 0; kind < 2; kind++)
            for (int lg = 2; lg <= 6; lg++) {
                if (kind == 1 && lg > 4) continue;
                int n = 1 << lg;
                std::vector<double> a((size_t)n * n), inv((size_t)n * n, 0.0);
                const int amp = 1 << 14;
                for (int j = 0; j < n; j++) {
                    int32_t T[64] = {0};
                    T[j] = amp;
                    inverse_1d(T, kind, lg, 30);
                    for (int i = 0; i < n; i++) a[(size_t)i * n + j] = (double)T[i] / amp;
                }
                for (int i = 0; i < n; i++) inv[(size_t)i * n + i] = 1.0;
                for (int col = 0; col < n; col++) {   // Gauss-Jordan with partial pivoting
                    int piv = col;
                    for (int r = col + 1; r < n; r++)
                        if (std::fabs(a[(size_t)r * n + col]) > std::fabs(a[(size_t)piv * n + col])) piv = r;
                    for (int k = 0; k < n; k++) {
                        std::swap(a[(size_t)col * n + k], a[(size_t)piv * n + k]);
                        std::swap(inv[(size_t)col * n + k], inv[(size_t)piv * n + k]);
                    }
                    double p = a[(size_t)col * n + col];
                    for (int k = 0; k < n; k++) { a[(size_t)col * n + k] /= p; inv[(size_t)col * n + k] /= p; }
                    for (int r = 0; r < n; r++) {
                        if (r == col) continue;
                        double f = a[(size_t)r * n + col];
                        if (f == 0) continue;
                        for (int k = 0; k < n; k++) {
                            a[(size_t)r * n + k] -= f * a[(size_t)col * n + k];
                            inv[(size_t)r * n + k] -= f * inv[(size_t)col * n + k];
                        }
                    }
                }
                m[kind][lg] = inv;
            }
    }
};
static const ForwardBases& bases() { static const ForwardBases b; return b; }

// the coefficients (row by row, min(32, w) wide, min(32, h) tall) of a
// w x h residual (row by row) under txType (DCT or ADST in each direction)
static void forward_transform(const int32_t* res, int txSz, int txType, double* out) {
    int lw = floor_log2(kTxW[txSz]), lh = floor_log2(kTxH[txSz]);
    int w = 1 << lw, h = 1 << lh, tw = std::min(32, w), th = std::min(32, h);
    const double* fh = bases().m[kTxHorz[txType]][lw].data();
    const double* fv = bases().m[kTxVert[txType]][lh].data();
    double scale = std::ldexp(1.0, kRowShift[txSz] + 4);
    if (std::abs(lw - lh) == 1) scale *= 4096.0 / 2896.0;
    static thread_local double tmp[64 * 32];
    for (int i = 0; i < h; i++)
        for (int k = 0; k < tw; k++) {
            double s = 0;
            const double* row = fh + (size_t)k * w;
            for (int j = 0; j < w; j++) s += row[j] * res[i * w + j];
            tmp[i * tw + k] = s;
        }
    for (int k2 = 0; k2 < th; k2++) {
        const double* col = fv + (size_t)k2 * h;
        for (int k = 0; k < tw; k++) {
            double s = 0;
            for (int i = 0; i < h; i++) s += col[i] * tmp[i * tw + k];
            out[k2 * tw + k] = s * scale;
        }
    }
}

// ---------------------------------------------------------------- the encoder
// the chroma planes' quantizer offset (DC and AC), as libaom's all-intra
// mode sets it for 4:2:0 at cv2's quality
const int kChromaDeltaQ = -16;
// the offsets from base_q_idx a superblock's quantizer may take (delta_q):
// 0, -24 and -48; and the rate's weight: lambda = kLambda *
// (ac_q(base_q_idx) / 8)^2 per bit against the squared error
const int kSbOffsetStep = 24, kNumSbOffsets = 3;
const int kDeltaQRes = 3;   // the offsets are coded in steps of 8
const double kLambda = 0.005;

struct Mi { uint8_t size, ymode, uvmode, skip; };

struct BlockChoice { uint8_t ymode, uvmode, skip; int8_t ydelta, uvdelta; };

// a partition node: its partition, its blocks (in coding order) and, for
// a split above 8x8, its four children
struct Node { int partition; BlockChoice blocks[4]; int child[4]; };

struct Encoder {
    // ---- frame
    int W = 0, H = 0, mono = 0, numPlanes = 3, qindex = 0, bitDepth = 8;
    int MiCols = 0, MiRows = 0, cw = 0, ch = 0;
    int tileColsLog2 = 0, tileRowsLog2 = 0, miColStarts[65], miRowStarts[65], tileCols = 1, tileRows = 1;
    double lambda = 0;
    int fast = 0;              // the quick search that picks a superblock's quantizer
    Cdfs cdf;
    Plane src[3], rec[3];
    std::vector<Mi> mi;
    int miStride = 0;
    std::vector<uint8_t> aboveLevel[3], aboveDc[3], leftLevel[3], leftDc[3];
    uint8_t blockDecoded[3][35][35];
    int dctSymbol[3] = {0, 0, 0};      // DCT_DCT's symbol in each intra transform set
    // ---- tile and block
    int MiRowStart = 0, MiRowEnd = 0, MiColStart = 0, MiColEnd = 0;
    int MiRow = 0, MiCol = 0, MiSize = 0, bw4 = 0, bh4 = 0, HasChroma = 0;
    int AvailU = 0, AvailL = 0, AvailUChroma = 0, AvailLChroma = 0;
    int YMode = 0, UVMode = 0, AngleDeltaY = 0, AngleDeltaUV = 0, Skip = 0;
    int currentQIndex = 0, readDeltas = 0, sbQIndex = 0;   // the superblocks' quantizer (5.11.10)
    double sse = 0;            // distortion of what was coded since the last reset
    int codeLuma = 1, codeChroma = 1;   // which planes a block codes (mode trials)
    Coder* coder = nullptr;
    std::vector<Node> nodes;

    Mi& at(int r, int c) { return mi[(size_t)r * miStride + c]; }
    int is_inside(int r, int c) const { return c >= MiColStart && c < MiColEnd && r >= MiRowStart && r < MiRowEnd; }

    void setup(const uint8_t* y, const uint8_t* u, const uint8_t* v) {
        numPlanes = mono ? 1 : 3;
        MiCols = 2 * ((W + 7) >> 3); MiRows = 2 * ((H + 7) >> 3);
        cw = (W + 1) >> 1; ch = (H + 1) >> 1;
        int cols = (MiCols + 15) / 16 * 16 + 16, rows = (MiRows + 15) / 16 * 16 + 16;
        miStride = cols;
        mi.assign((size_t)rows * cols, Mi{0, 0, 0, 0});
        for (int p = 0; p < numPlanes; p++) {
            int s = p ? 1 : 0;
            int pw = (cols * 4) >> s, ph = (rows * 4) >> s;
            int vw = p ? cw : W, vh = p ? ch : H;
            const uint8_t* in = p == 0 ? y : p == 1 ? u : v;
            for (Plane* pl : {&src[p], &rec[p]}) {
                pl->w = pw; pl->h = ph; pl->stride = pw;
                pl->px.assign((size_t)pw * ph, 0);
            }
            // the source, its last column and row repeated over the padding
            for (int r = 0; r < ph; r++)
                for (int c = 0; c < pw; c++)
                    *src[p].at(r, c) = in[(size_t)std::min(r, vh - 1) * vw + std::min(c, vw - 1)];
            aboveLevel[p].assign(pw / 4 + 32, 0); aboveDc[p].assign(pw / 4 + 32, 0);
            leftLevel[p].assign(ph / 4 + 32, 0); leftDc[p].assign(ph / 4 + 32, 0);
        }
        cdf.init(qindex);
        for (int s = 0; s < 16; s++) {
            if (k_ext_tx_inv[3][s] == DCT_DCT && s < 7) dctSymbol[1] = s;
            if (k_ext_tx_inv[2][s] == DCT_DCT && s < 5) dctSymbol[2] = s;
        }
        double q = ac_q(bitDepth, qindex) / 8.0;
        lambda = kLambda * q * q;
        tile_layout();
    }

    // uniform tile spacing at the fewest tiles (5.9.15)
    static int tile_log2(int blk, int target) { int k = 0; while ((blk << k) < target) k++; return k; }
    void tile_layout() {
        int sbCols = (MiCols + 15) >> 4, sbRows = (MiRows + 15) >> 4;
        int maxTileAreaSb = (4096 * 2304) >> 12;
        int minLog2TileCols = tile_log2(64, sbCols);
        int minLog2Tiles = std::max(minLog2TileCols, tile_log2(maxTileAreaSb, sbRows * sbCols));
        tileColsLog2 = minLog2TileCols;
        int tileWidthSb = (sbCols + (1 << tileColsLog2) - 1) >> tileColsLog2;
        int i = 0;
        for (int s = 0; s < sbCols; s += tileWidthSb) miColStarts[i++] = s << 4;
        miColStarts[i] = MiCols; tileCols = i;
        tileRowsLog2 = std::max(minLog2Tiles - tileColsLog2, 0);
        int tileHeightSb = (sbRows + (1 << tileRowsLog2) - 1) >> tileRowsLog2;
        i = 0;
        for (int s = 0; s < sbRows; s += tileHeightSb) miRowStarts[i++] = s << 4;
        miRowStarts[i] = MiRows; tileRows = i;
    }

    // ============================================================ headers
    int level() const {
        // libaom's set_bitstream_level_tier: the first level whose picture
        // size and dimensions the frame fits at 30 frames a second
        static const int lv[][4] = {{0, 512, 288, 4}, {1, 704, 396, 4}, {4, 1088, 612, 4},
                                    {5, 1376, 774, 4}, {8, 2048, 1152, 3}, {12, 4096, 2176, 2},
                                    {16, 8192, 4352, 2}};
        for (auto& l : lv)
            if ((int64_t)W * H <= (int64_t)l[1] * l[2] && W <= l[1] * l[3] && H <= l[2] * l[3]) return l[0];
        return 31;
    }

    std::vector<uint8_t> sequence_header(int cp, int tc, int mc) const {
        BitWriter b;
        b.f(0, 3);                  // seq_profile
        b.f(1, 1); b.f(1, 1);       // still_picture, reduced_still_picture_header
        b.f(level(), 5);
        int wb = W > 1 ? floor_log2(W - 1) + 1 : 1, hb = H > 1 ? floor_log2(H - 1) + 1 : 1;
        b.f(wb - 1, 4); b.f(hb - 1, 4);
        b.f(W - 1, wb); b.f(H - 1, hb);
        b.f(0, 1);                  // use_128x128_superblock
        b.f(0, 1);                  // enable_filter_intra
        b.f(1, 1);                  // enable_intra_edge_filter
        b.f(0, 1); b.f(0, 1); b.f(0, 1);   // superres, CDEF, loop restoration
        b.f(0, 1);                  // high_bitdepth
        b.f(mono, 1);
        int desc = !(cp == 2 && tc == 2 && mc == 2);
        b.f(desc, 1);
        if (desc) { b.f(cp, 8); b.f(tc, 8); b.f(mc, 8); }
        b.f(1, 1);                  // color_range: full
        if (!mono) {
            b.f(0, 2);              // chroma_sample_position: unknown
            b.f(0, 1);              // separate_uv_delta_q
        }
        b.f(0, 1);                  // film_grain_params_present
        b.trailing();
        return b.d;
    }

    void frame_header(BitWriter& b) const {
        b.f(1, 1);                  // disable_cdf_update
        b.f(0, 1);                  // allow_screen_content_tools
        b.f(0, 1);                  // render_and_frame_size_different
        // tile_info: uniform spacing at the fewest tiles
        int sbCols = (MiCols + 15) >> 4, sbRows = (MiRows + 15) >> 4;
        int maxTileAreaSb = (4096 * 2304) >> 12;
        int minLog2TileCols = tile_log2(64, sbCols);
        int maxLog2TileCols = tile_log2(1, std::min(sbCols, 64));
        int maxLog2TileRows = tile_log2(1, std::min(sbRows, 64));
        int minLog2Tiles = std::max(minLog2TileCols, tile_log2(maxTileAreaSb, sbRows * sbCols));
        b.f(1, 1);
        if (minLog2TileCols < maxLog2TileCols) b.f(0, 1);
        if (std::max(minLog2Tiles - tileColsLog2, 0) < maxLog2TileRows) b.f(0, 1);
        if (tileColsLog2 > 0 || tileRowsLog2 > 0) {
            b.f(0, tileRowsLog2 + tileColsLog2);   // context_update_tile_id
            b.f(3, 2);              // tile_size_bytes_minus_1
        }
        b.f(qindex, 8);
        b.f(0, 1);                  // DeltaQYDc
        if (numPlanes > 1)          // DeltaQUDc, DeltaQUAc (V takes U's)
            for (int i = 0; i < 2; i++) { b.f(1, 1); b.f((uint32_t)kChromaDeltaQ & 127, 7); }
        b.f(0, 1);                  // using_qmatrix
        b.f(0, 1);                  // segmentation_enabled
        b.f(1, 1);                  // delta_q_present
        b.f(kDeltaQRes, 2);         // delta_q_res
        b.f(0, 1);                  // delta_lf_present
        b.f(0, 6); b.f(0, 6);       // loop_filter_level[0], [1]
        b.f(0, 3);                  // loop_filter_sharpness
        b.f(0, 1);                  // loop_filter_delta_enabled
        b.f(0, 1);                  // tx_mode_select: TX_MODE_LARGEST
        b.f(0, 1);                  // reduced_tx_set
    }

    // ============================================================ state snapshots
    struct Snap {
        int r0 = 0, c0 = 0, r1 = 0, c1 = 0;
        std::vector<uint16_t> px[3];
        std::vector<uint8_t> ctx[3];
        std::vector<Mi> m;
        uint8_t bd[3][35][35];
        int currentQIndex = 0, readDeltas = 0;
    };
    void save(Snap& s, int r, int c, int bsize) {
        s.r0 = r & ~1; s.c0 = c & ~1;
        s.r1 = (r + kNum4x4H[bsize] + 1) & ~1; s.c1 = (c + kNum4x4W[bsize] + 1) & ~1;
        for (int p = 0; p < numPlanes; p++) {
            int sh = p ? 1 : 0;
            int x0 = (s.c0 * 4) >> sh, x1 = (s.c1 * 4) >> sh, y0 = (s.r0 * 4) >> sh, y1 = (s.r1 * 4) >> sh;
            s.px[p].resize((size_t)(x1 - x0) * (y1 - y0));
            for (int y = y0; y < y1; y++)
                memcpy(&s.px[p][(size_t)(y - y0) * (x1 - x0)], rec[p].at(y, x0), (x1 - x0) * 2);
            int ax0 = x0 >> 2, ax1 = x1 >> 2, ly0 = y0 >> 2, ly1 = y1 >> 2;
            std::vector<uint8_t>& v = s.ctx[p];
            v.clear();
            v.insert(v.end(), aboveLevel[p].begin() + ax0, aboveLevel[p].begin() + ax1);
            v.insert(v.end(), aboveDc[p].begin() + ax0, aboveDc[p].begin() + ax1);
            v.insert(v.end(), leftLevel[p].begin() + ly0, leftLevel[p].begin() + ly1);
            v.insert(v.end(), leftDc[p].begin() + ly0, leftDc[p].begin() + ly1);
        }
        s.m.clear();
        for (int y = s.r0; y < s.r1; y++)
            for (int x = s.c0; x < s.c1; x++) s.m.push_back(at(y, x));
        memcpy(s.bd, blockDecoded, sizeof(blockDecoded));
        s.currentQIndex = currentQIndex; s.readDeltas = readDeltas;
    }
    void restore(const Snap& s) {
        for (int p = 0; p < numPlanes; p++) {
            int sh = p ? 1 : 0;
            int x0 = (s.c0 * 4) >> sh, x1 = (s.c1 * 4) >> sh, y0 = (s.r0 * 4) >> sh, y1 = (s.r1 * 4) >> sh;
            for (int y = y0; y < y1; y++)
                memcpy(rec[p].at(y, x0), &s.px[p][(size_t)(y - y0) * (x1 - x0)], (x1 - x0) * 2);
            int ax0 = x0 >> 2, ax1 = x1 >> 2, ly0 = y0 >> 2, ly1 = y1 >> 2;
            const uint8_t* v = s.ctx[p].data();
            int na = ax1 - ax0, nl = ly1 - ly0;
            std::copy(v, v + na, aboveLevel[p].begin() + ax0); v += na;
            std::copy(v, v + na, aboveDc[p].begin() + ax0); v += na;
            std::copy(v, v + nl, leftLevel[p].begin() + ly0); v += nl;
            std::copy(v, v + nl, leftDc[p].begin() + ly0);
        }
        size_t k = 0;
        for (int y = s.r0; y < s.r1; y++)
            for (int x = s.c0; x < s.c1; x++) at(y, x) = s.m[k++];
        memcpy(blockDecoded, s.bd, sizeof(blockDecoded));
        currentQIndex = s.currentQIndex; readDeltas = s.readDeltas;
    }

    // ============================================================ tiles
    std::vector<uint8_t> encode_tile() {
        for (int p = 0; p < numPlanes; p++) {
            std::fill(aboveLevel[p].begin(), aboveLevel[p].end(), 0);
            std::fill(aboveDc[p].begin(), aboveDc[p].end(), 0);
        }
        currentQIndex = qindex;
        SymEnc enc;
        Coder writer, counter;
        writer.enc = &enc;
        Snap sb;
        for (int r = MiRowStart; r < MiRowEnd; r += 16) {
            for (int p = 0; p < numPlanes; p++) {
                std::fill(leftLevel[p].begin(), leftLevel[p].end(), 0);
                std::fill(leftDc[p].begin(), leftDc[p].end(), 0);
            }
            for (int c = MiColStart; c < MiColEnd; c += 16) {
                clear_block_decoded_flags(r, c);
                readDeltas = 1;
                save(sb, r, c, BLOCK_64X64);
                coder = &counter;
                // the superblock's quantizer: the offset from base_q_idx
                // whose quick search (no rectangular partitions, one luma
                // mode tried) costs least
                fast = 1;
                double bestJ = 1e300;
                int bestQ = qindex;
                for (int k = 0; k < kNumSbOffsets; k++) {
                    if (k) restore(sb);
                    nodes.clear();
                    sbQIndex = clip3(1, 255, qindex - k * kSbOffsetStep);
                    double sse0 = sse, bits0 = counter.bits;
                    search_partition(r, c, BLOCK_64X64);
                    double J = (sse - sse0) + lambda * (counter.bits - bits0);
                    sse = sse0; counter.bits = bits0;
                    if (J < bestJ) { bestJ = J; bestQ = sbQIndex; }
                }
                // the full search at that quantizer, then its symbols
                fast = 0;
                restore(sb);
                nodes.clear();
                sbQIndex = bestQ;
                int root = search_partition(r, c, BLOCK_64X64);
                restore(sb);
                coder = &writer;
                code_partition(r, c, BLOCK_64X64, root);
            }
        }
        return enc.done();
    }

    void clear_block_decoded_flags(int r, int c) {
        for (int p = 0; p < numPlanes; p++) {
            int s = p ? 1 : 0;
            int sbW4 = (MiColEnd - c) >> s, sbH4 = (MiRowEnd - r) >> s;
            for (int y = -1; y <= (16 >> s); y++)
                for (int x = -1; x <= (16 >> s); x++) {
                    uint8_t v;
                    if (y < 0 && x < sbW4) v = 1;
                    else if (x < 0 && y < sbH4) v = 1;
                    else v = 0;
                    blockDecoded[p][y + 1][x + 1] = v;
                }
            blockDecoded[p][(16 >> s) + 1][0] = 0;
        }
    }

    // ============================================================ partitions (5.11.4)
    struct Split { int hasRows, hasCols, half; };
    Split split_of(int r, int c, int bSize) const {
        int half = kNum4x4W[bSize] >> 1;
        return {(r + half) < MiRows, (c + half) < MiCols, half};
    }
    static int sub_size(int bSize, int partition) {
        int w4 = kNum4x4W[bSize], h4 = kNum4x4H[bSize];
        if (partition == PARTITION_NONE) return bSize;
        if (partition == PARTITION_HORZ) return block_from_wh(w4, h4 / 2);
        if (partition == PARTITION_VERT) return block_from_wh(w4 / 2, h4);
        return block_from_wh(w4 / 2, h4 / 2);
    }

    void code_partition_symbol(int r, int c, int bSize, int partition) {
        if (bSize < BLOCK_8X8) return;
        Split sp = split_of(r, c, bSize);
        int availU = is_inside(r - 1, c), availL = is_inside(r, c - 1);
        int bsl = kMiWLog2[bSize];
        int above = availU && kMiWLog2[at(r - 1, c).size] < bsl;
        int left = availL && kMiHLog2[at(r, c - 1).size] < bsl;
        const uint16_t* pc = cdf.partition[(bsl - 1) * 4 + left * 2 + above];
        int N = bSize == BLOCK_8X8 ? 4 : 10;
        auto prob = [&](int e) { return (e > 0 ? pc[e - 1] : 32768) - pc[e]; };
        if (sp.hasRows && sp.hasCols) coder->sym(pc, N, partition);
        else if (sp.hasCols) {
            int s2 = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                     prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B) + prob(PARTITION_VERT_4);
            uint16_t c2[3] = {(uint16_t)s2, 0, 0};
            coder->sym(c2, 2, partition == PARTITION_SPLIT);
        } else if (sp.hasRows) {
            int s2 = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                     prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A) + prob(PARTITION_HORZ_4);
            uint16_t c2[3] = {(uint16_t)s2, 0, 0};
            coder->sym(c2, 2, partition == PARTITION_SPLIT);
        }
    }

    // code a partition with its decisions (nodes[id])
    void code_partition(int r, int c, int bSize, int id) {
        if (r >= MiRows || c >= MiCols) return;
        const Node& nd = nodes[id];
        Split sp = split_of(r, c, bSize);
        int sub = sub_size(bSize, nd.partition);
        code_partition_symbol(r, c, bSize, nd.partition);
        switch (nd.partition) {
            case PARTITION_NONE: code_block(r, c, sub, nd.blocks[0]); break;
            case PARTITION_HORZ:
                code_block(r, c, sub, nd.blocks[0]);
                if (sp.hasRows) code_block(r + sp.half, c, sub, nd.blocks[1]);
                break;
            case PARTITION_VERT:
                code_block(r, c, sub, nd.blocks[0]);
                if (sp.hasCols) code_block(r, c + sp.half, sub, nd.blocks[1]);
                break;
            default:
                if (bSize == BLOCK_8X8) {
                    code_block(r, c, sub, nd.blocks[0]); code_block(r, c + 1, sub, nd.blocks[1]);
                    code_block(r + 1, c, sub, nd.blocks[2]); code_block(r + 1, c + 1, sub, nd.blocks[3]);
                } else {
                    code_partition(r, c, sub, nd.child[0]); code_partition(r, c + sp.half, sub, nd.child[1]);
                    code_partition(r + sp.half, c, sub, nd.child[2]);
                    code_partition(r + sp.half, c + sp.half, sub, nd.child[3]);
                }
        }
    }

    double cost_now() const { return sse + lambda * coder->bits; }

    // the best partition of a block by rate and distortion; leaves the
    // state as that partition codes it and returns its node
    int search_partition(int r, int c, int bSize) {
        int id = (int)nodes.size();
        nodes.push_back(Node{});
        if (r >= MiRows || c >= MiCols) return id;
        Split sp = split_of(r, c, bSize);
        int cands[4], n = 0;
        if (sp.hasRows && sp.hasCols) {
            cands[n++] = PARTITION_NONE;
            if (!fast) { cands[n++] = PARTITION_HORZ; cands[n++] = PARTITION_VERT; }
            cands[n++] = PARTITION_SPLIT;
        } else if (sp.hasCols) { cands[n++] = PARTITION_HORZ; cands[n++] = PARTITION_SPLIT; }
        else if (sp.hasRows) { cands[n++] = PARTITION_VERT; cands[n++] = PARTITION_SPLIT; }
        else cands[n++] = PARTITION_SPLIT;
        Snap start, best;
        if (n > 1) save(start, r, c, bSize);
        double bestJ = 1e300, bestSse = 0, bestBits = 0;
        Node bestNode{};
        for (int k = 0; k < n; k++) {
            int part = cands[k];
            if (k > 0) restore(start);
            double sse0 = sse, bits0 = coder->bits;
            Node nd{};
            nd.partition = part;
            code_partition_symbol(r, c, bSize, part);
            int sub = sub_size(bSize, part);
            if (part == PARTITION_NONE) nd.blocks[0] = search_block(r, c, sub);
            else if (part == PARTITION_HORZ) {
                nd.blocks[0] = search_block(r, c, sub);
                if (sp.hasRows) nd.blocks[1] = search_block(r + sp.half, c, sub);
            } else if (part == PARTITION_VERT) {
                nd.blocks[0] = search_block(r, c, sub);
                if (sp.hasCols) nd.blocks[1] = search_block(r, c + sp.half, sub);
            } else if (bSize == BLOCK_8X8) {
                nd.blocks[0] = search_block(r, c, sub); nd.blocks[1] = search_block(r, c + 1, sub);
                nd.blocks[2] = search_block(r + 1, c, sub); nd.blocks[3] = search_block(r + 1, c + 1, sub);
            } else {
                nd.child[0] = search_partition(r, c, sub);
                nd.child[1] = search_partition(r, c + sp.half, sub);
                nd.child[2] = search_partition(r + sp.half, c, sub);
                nd.child[3] = search_partition(r + sp.half, c + sp.half, sub);
            }
            double J = (sse - sse0) + lambda * (coder->bits - bits0);
            if (J < bestJ) {
                bestJ = J; bestNode = nd;
                if (n > 1 && k < n - 1) save(best, r, c, bSize);
                bestSse = sse - sse0; bestBits = coder->bits - bits0;
            }
            sse = sse0; coder->bits = bits0;
        }
        if (n > 1 && bestNode.partition != cands[n - 1]) restore(best);
        sse += bestSse; coder->bits += bestBits;
        nodes[id] = bestNode;
        return id;
    }

    // ============================================================ blocks (5.11.5)
    void block_setup(int r, int c, int subSize) {
        MiRow = r; MiCol = c; MiSize = subSize;
        bw4 = kNum4x4W[subSize]; bh4 = kNum4x4H[subSize];
        if (bh4 == 1 && (MiRow & 1) == 0) HasChroma = 0;
        else if (bw4 == 1 && (MiCol & 1) == 0) HasChroma = 0;
        else HasChroma = numPlanes > 1;
        AvailU = is_inside(r - 1, c); AvailL = is_inside(r, c - 1);
        AvailUChroma = AvailU; AvailLChroma = AvailL;
        if (HasChroma) {
            if (bh4 == 1) AvailUChroma = is_inside(r - 2, c);
            if (bw4 == 1) AvailLChroma = is_inside(r, c - 2);
        } else AvailUChroma = AvailLChroma = 0;
    }

    // the modes and skip of one block by rate and distortion; leaves the
    // state as the chosen block codes it
    BlockChoice search_block(int r, int c, int subSize) {
        block_setup(r, c, subSize);
        int hasChroma = HasChroma;
        Snap start;
        save(start, r, c, subSize);
        double sse0 = sse, bits0 = coder->bits;
        BlockChoice ch{DC_PRED, DC_PRED, 0, 0, 0};
        // luma: the modes whose predictions are closest, then by their cost
        int lumaModes[64][2], nl = luma_candidates(r, c, subSize, lumaModes);
        double bestJ = 1e300;
        for (int k = 0; k < nl; k++) {
            BlockChoice t = ch;
            t.ymode = (uint8_t)lumaModes[k][0]; t.ydelta = (int8_t)lumaModes[k][1];
            codeLuma = 1; codeChroma = 0;
            code_block(r, c, subSize, t);
            double J = (sse - sse0) + lambda * (coder->bits - bits0);
            restore(start); sse = sse0; coder->bits = bits0;
            if (J < bestJ) { bestJ = J; ch = t; }
        }
        if (hasChroma) {
            int uvModes[64][2], nu = chroma_candidates(r, c, subSize, ch, uvModes);
            bestJ = 1e300;
            BlockChoice bestC = ch;
            for (int k = 0; k < nu; k++) {
                BlockChoice t = ch;
                t.uvmode = (uint8_t)uvModes[k][0]; t.uvdelta = (int8_t)uvModes[k][1];
                codeLuma = 0; codeChroma = 1;
                code_block(r, c, subSize, t);
                double J = (sse - sse0) + lambda * (coder->bits - bits0);
                restore(start); sse = sse0; coder->bits = bits0;
                if (J < bestJ) { bestJ = J; bestC = t; }
            }
            ch = bestC;
        }
        codeLuma = 1; codeChroma = 1;
        // skip: with the residual, then without
        ch.skip = 0;
        code_block(r, c, subSize, ch);
        double J0 = (sse - sse0) + lambda * (coder->bits - bits0);
        if (!lastNonzero) { ch.skip = 1; }
        else {
            restore(start); sse = sse0; coder->bits = bits0;
            BlockChoice t = ch; t.skip = 1;
            code_block(r, c, subSize, t);
            double J1 = (sse - sse0) + lambda * (coder->bits - bits0);
            if (J1 < J0) return t;
            restore(start); sse = sse0; coder->bits = bits0;
            code_block(r, c, subSize, ch);
            return ch;
        }
        restore(start); sse = sse0; coder->bits = bits0;
        code_block(r, c, subSize, ch);
        return ch;
    }

    // the sum of absolute differences of a luma or chroma prediction
    int64_t pred_sad(int plane, int x, int y, int w, int h) {
        int vw = plane ? cw : W, vh = plane ? ch : H;
        int64_t s = 0;
        for (int i = 0; i < h && y + i < vh; i++)
            for (int j = 0; j < w && x + j < vw; j++)
                s += std::abs((int)*src[plane].at(y + i, x + j) - (int)*rec[plane].at(y + i, x + j));
        return s;
    }

    void predict(int plane, int x, int y, int txSz, int mode, int delta, int haveAboveRt, int haveBelowLt) {
        int haveLeft = plane == 0 ? AvailL : AvailLChroma, haveAbove = plane == 0 ? AvailU : AvailUChroma;
        int s = plane ? 1 : 0;
        int edge = is_directional(mode) ? get_filter_type(plane) : -1;
        predict_intra(rec[plane].px.data(), rec[plane].stride, x, y, ((MiCols * 4) >> s) - 1,
                      ((MiRows * 4) >> s) - 1, bitDepth, haveLeft, haveAbove, haveAboveRt, haveBelowLt,
                      mode, delta, floor_log2(kTxW[txSz]), floor_log2(kTxH[txSz]), edge, -1);
    }

    // haveAboveRt and haveBelowLt of a transform block (5.11.35)
    void edge_flags(int plane, int x, int y, int txSz, int* aboveRt, int* belowLt) const {
        int s = plane ? 1 : 0;
        int row = (y << s) >> 2, col = (x << s) >> 2;
        int sbRow = row & 15, sbCol = col & 15;
        int stepX = kTxW[txSz] >> 2, stepY = kTxH[txSz] >> 2;
        *aboveRt = blockDecoded[plane][(sbRow >> s) - 1 + 1][(sbCol >> s) + stepX + 1];
        *belowLt = blockDecoded[plane][(sbRow >> s) + stepY + 1][(sbCol >> s) - 1 + 1];
    }

    // rank (mode, angle delta) pairs by their prediction's SAD plus an
    // estimate of their mode bits; keep the best few
    int rank(std::vector<std::pair<double, std::pair<int, int>>>& v, int out[][2], int keep) {
        std::sort(v.begin(), v.end());
        int n = std::min<int>(keep, (int)v.size());
        for (int i = 0; i < n; i++) { out[i][0] = v[i].second.first; out[i][1] = v[i].second.second; }
        return n;
    }

    static double symbol_bits(const uint16_t* icdf, int s) {
        int hi = s > 0 ? icdf[s - 1] : 32768;
        return costs().c[std::max(hi - (int)icdf[s], 1)];
    }

    // score the 13 modes at angle delta 0, then the other deltas of the
    // best-scoring directional mode
    template <typename F> void search_modes(int subSize, F score, std::vector<std::pair<double, std::pair<int, int>>>& v) {
        int bestDir = -1;
        double bestDirScore = 1e300;
        for (int m = DC_PRED; m <= PAETH_PRED; m++) {
            double sc = score(m, 0);
            v.push_back({sc, {m, 0}});
            if (is_directional(m) && sc < bestDirScore) { bestDirScore = sc; bestDir = m; }
        }
        if (subSize >= BLOCK_8X8 && bestDir >= 0)
            for (int d = -3; d <= 3; d++) if (d) v.push_back({score(bestDir, d), {bestDir, d}});
    }

    int luma_candidates(int r, int c, int subSize, int out[][2]) {
        int txSz = kMaxTxRect[subSize];
        int x = c * 4, y = r * 4, w = kTxW[txSz], h = kTxH[txSz];
        int aRt, bLt;
        edge_flags(0, x, y, txSz, &aRt, &bLt);
        int aboveMode = AvailU ? at(r - 1, c).ymode : (int)DC_PRED;
        int leftMode = AvailL ? at(r, c - 1).ymode : (int)DC_PRED;
        const uint16_t* ycdf = cdf.kf_y_mode[kIntraModeContext[aboveMode]][kIntraModeContext[leftMode]];
        auto score = [&](int m, int d) {
            predict(0, x, y, txSz, m, d, aRt, bLt);
            double bits = symbol_bits(ycdf, m);
            if (subSize >= BLOCK_8X8 && is_directional(m)) bits += symbol_bits(cdf.angle_delta[m - V_PRED], d + 3);
            return (double)pred_sad(0, x, y, w, h) + std::sqrt(lambda) * bits;
        };
        std::vector<std::pair<double, std::pair<int, int>>> v;
        search_modes(subSize, score, v);
        return rank(v, out, fast ? 1 : 2);
    }

    int chroma_candidates(int r, int c, int subSize, const BlockChoice& ch, int out[][2]) {
        // the chroma block of this block (its residual size), as residual() places it
        int planeSz = k_ss_size_lookup[subSize][1][1];
        int txSz = kMaxTxRect[planeSz];
        if (kTxW[txSz] == 64 || kTxH[txSz] == 64) txSz = TX_32X32;
        int x = (c >> 1) * 4, y = (r >> 1) * 4, w = kTxW[txSz], h = kTxH[txSz];
        int cflAllowed = std::max(bw4, bh4) * 4 <= 32;
        const uint16_t* ucdf = cdf.uv_mode[cflAllowed][ch.ymode];
        int aRt, bLt;
        edge_flags(1, x, y, txSz, &aRt, &bLt);
        auto score = [&](int m, int d) {
            int64_t sad = 0;
            for (int p = 1; p < 3; p++) {
                predict(p, x, y, txSz, m, d, aRt, bLt);
                sad += pred_sad(p, x, y, w, h);
            }
            double bits = symbol_bits(ucdf, m);
            if (subSize >= BLOCK_8X8 && is_directional(m)) bits += symbol_bits(cdf.angle_delta[m - V_PRED], d + 3);
            return (double)sad + std::sqrt(lambda) * bits;
        };
        std::vector<std::pair<double, std::pair<int, int>>> v;
        search_modes(subSize, score, v);
        return rank(v, out, 2);
    }

    int lastNonzero = 0;   // whether the last coded block had a non-zero coefficient

    // code one block with given modes and skip (the order of 5.11.5);
    // codeLuma / codeChroma limit a mode trial to its planes
    void code_block(int r, int c, int subSize, const BlockChoice& ch) {
        block_setup(r, c, subSize);
        YMode = ch.ymode; UVMode = ch.uvmode; AngleDeltaY = ch.ydelta; AngleDeltaUV = ch.uvdelta;
        Skip = ch.skip;
        // intra_frame_mode_info
        int sctx = (AvailU ? at(r - 1, c).skip : 0) + (AvailL ? at(r, c - 1).skip : 0);
        coder->sym(cdf.skip[sctx], 2, Skip);
        if (readDeltas && !(MiSize == BLOCK_64X64 && Skip)) {   // read_delta_qindex
            int delta = (sbQIndex - currentQIndex) >> kDeltaQRes, a = std::abs(delta);
            coder->sym(cdf.delta_q, 4, std::min(a, 3));
            if (a >= 3) {
                int rem = floor_log2(a - 1);
                coder->literal(rem - 1, 3);
                coder->literal(a - 1 - (1 << rem), rem);
            }
            if (a) coder->bit(delta < 0);
            currentQIndex = sbQIndex;
        }
        readDeltas = 0;
        int aboveMode = AvailU ? at(r - 1, c).ymode : (int)DC_PRED;
        int leftMode = AvailL ? at(r, c - 1).ymode : (int)DC_PRED;
        coder->sym(cdf.kf_y_mode[kIntraModeContext[aboveMode]][kIntraModeContext[leftMode]], 13, YMode);
        if (MiSize >= BLOCK_8X8 && is_directional(YMode)) coder->sym(cdf.angle_delta[YMode - V_PRED], 7, AngleDeltaY + 3);
        if (HasChroma && codeChroma) {
            int cflAllowed = std::max(bw4, bh4) * 4 <= 32;
            coder->sym(cdf.uv_mode[cflAllowed][YMode], 13 + cflAllowed, UVMode);
            if (MiSize >= BLOCK_8X8 && is_directional(UVMode)) coder->sym(cdf.angle_delta[UVMode - V_PRED], 7, AngleDeltaUV + 3);
        }
        for (int y = 0; y < bh4; y++)
            for (int x = 0; x < bw4; x++)
                at(r + y, c + x) = Mi{(uint8_t)MiSize, (uint8_t)YMode, (uint8_t)UVMode, (uint8_t)Skip};
        if (Skip) reset_block_context();
        lastNonzero = 0;
        residual();
    }

    void reset_block_context() {
        for (int p = 0; p < 1 + 2 * HasChroma; p++) {
            int s = p ? 1 : 0;
            for (int i = MiCol >> s; i < ((MiCol + bw4 - 1) >> s) + 1; i++) { aboveLevel[p][i] = 0; aboveDc[p][i] = 0; }
            for (int i = MiRow >> s; i < ((MiRow + bh4 - 1) >> s) + 1; i++) { leftLevel[p][i] = 0; leftDc[p][i] = 0; }
        }
    }

    int is_smooth(int row, int col, int plane) {
        int mode = plane == 0 ? at(row, col).ymode : at(row, col).uvmode;
        return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
    }
    int get_filter_type(int plane) {
        int aboveSmooth = 0, leftSmooth = 0;
        if (plane == 0 ? AvailU : AvailUChroma) {
            int r = MiRow - 1, c = MiCol;
            if (plane > 0) { if (!(MiCol & 1)) c++; if (MiRow & 1) r--; }
            aboveSmooth = is_smooth(r, c, plane);
        }
        if (plane == 0 ? AvailL : AvailLChroma) {
            int r = MiRow, c = MiCol - 1;
            if (plane > 0) { if (MiCol & 1) c--; if (!(MiRow & 1)) r++; }
            leftSmooth = is_smooth(r, c, plane);
        }
        return aboveSmooth || leftSmooth;
    }

    // ---- residual (5.11.34): one transform block per plane (TX_MODE_LARGEST)
    void residual() {
        int widthChunks = std::max(1, bw4 >> 4), heightChunks = std::max(1, bh4 >> 4);
        for (int cy = 0; cy < heightChunks; cy++)
            for (int cx = 0; cx < widthChunks; cx++)
                for (int p = 0; p < 1 + HasChroma * 2; p++) {
                    if (p == 0 ? !codeLuma : !codeChroma) continue;
                    int planeSz = p ? k_ss_size_lookup[MiSize][1][1] : MiSize;
                    int txSz = kMaxTxRect[planeSz];
                    if (p && (kTxW[txSz] == 64 || kTxH[txSz] == 64))
                        txSz = kTxW[txSz] == 16 ? TX_16X32 : kTxH[txSz] == 16 ? TX_32X16 : TX_32X32;
                    int stepX = kTxW[txSz] >> 2, stepY = kTxH[txSz] >> 2;
                    int n4w = kNum4x4W[planeSz], n4h = kNum4x4H[planeSz];
                    int s = p ? 1 : 0;
                    int baseX = (MiCol >> s) * 4, baseY = (MiRow >> s) * 4;
                    for (int y = 0; y < std::min(n4h, 16 >> s); y += stepY)
                        for (int x = 0; x < std::min(n4w, 16 >> s); x += stepX)
                            transform_block(p, baseX, baseY, txSz, x + ((cx << 4) >> s), y + ((cy << 4) >> s));
                }
    }

    void transform_block(int plane, int baseX, int baseY, int txSz, int x, int y) {
        int startX = baseX + 4 * x, startY = baseY + 4 * y;
        int s = plane ? 1 : 0;
        int row = (startY << s) >> 2, col = (startX << s) >> 2;
        int sbRow = row & 15, sbCol = col & 15;
        int stepX = kTxW[txSz] >> 2, stepY = kTxH[txSz] >> 2;
        int maxX = (MiCols * 4) >> s, maxY = (MiRows * 4) >> s;
        if (startX >= maxX || startY >= maxY) return;
        int aRt, bLt;
        edge_flags(plane, startX, startY, txSz, &aRt, &bLt);
        int mode = plane == 0 ? YMode : UVMode;
        predict(plane, startX, startY, txSz, mode, plane == 0 ? AngleDeltaY : AngleDeltaUV, aRt, bLt);
        if (!Skip) code_residual(plane, startX, startY, txSz);
        // the distortion over the mode info grid, the source's last row and
        // column repeated to it: a frame's edge weighs as a whole block
        int w = kTxW[txSz], h = kTxH[txSz], vw = maxX, vh = maxY;
        for (int i = 0; i < h && startY + i < vh; i++)
            for (int j = 0; j < w && startX + j < vw; j++) {
                int d = (int)*src[plane].at(startY + i, startX + j) - (int)*rec[plane].at(startY + i, startX + j);
                sse += d * d;
            }
        for (int i = 0; i < stepY; i++)
            for (int j = 0; j < stepX; j++)
                blockDecoded[plane][(sbRow >> s) + i + 1][(sbCol >> s) + j + 1] = 1;
    }

    // ---- coefficients (5.11.39) and reconstruction (7.12.3)
    int get_tx_set(int txSz) const {
        int sq = tx_sqr(txSz), up = tx_sqr_up(txSz);
        if (up >= TX_32X32) return 0;
        return sq == TX_16X16 ? 2 : 1;
    }

    void code_residual(int plane, int startX, int startY, int txSz) {
        int w = kTxW[txSz], h = kTxH[txSz];
        int tw = std::min(32, w), th = std::min(32, h);
        int set = get_tx_set(txSz);
        int txType = plane == 0 || set == 0 ? DCT_DCT : kModeToTxfm[UVMode];
        static thread_local int32_t res[64 * 64], quant[1024], coef[1024];
        static thread_local double C[1024];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                res[i * w + j] = (int)*src[plane].at(startY + i, startX + j) - (int)*rec[plane].at(startY + i, startX + j);
        forward_transform(res, txSz, txType, C);
        int dq = plane ? kChromaDeltaQ : 0;
        int dcQ = dc_q(bitDepth, currentQIndex + dq), acQ = ac_q(bitDepth, currentQIndex + dq), sh = dq_shift(txSz);
        for (int pos = 0; pos < tw * th; pos++) {
            double step = (double)(pos == 0 ? dcQ : acQ) / (1 << sh);
            double a = std::fabs(C[pos]) / step;
            int qv = (int)(a + 0.5);
            qv = std::min(qv, (1 << 20) - 1);
            quant[pos] = C[pos] < 0 ? -qv : qv;
        }
        int eob = code_coeffs(plane, startX >> 2, startY >> 2, txSz, quant);
        if (eob > 0) {
            lastNonzero = 1;
            dequantize(quant, coef, tw, th, dcQ, acQ, sh, nullptr, bitDepth);
            Plane& f = rec[plane];
            inverse_transform_add(coef, floor_log2(w), floor_log2(h), txType, 0, kRowShift[txSz], bitDepth,
                                  f.at(startY, startX), f.stride);
        }
    }

    // writes (or counts) a transform block's coefficients; returns its eob
    // (zeroing what lies past the scan's end)
    int code_coeffs(int plane, int x4, int y4, int txSz, int32_t* quant) {
        int w4 = kTxW[txSz] >> 2, h4 = kTxH[txSz] >> 2;
        int txSzCtx = (tx_sqr(txSz) + tx_sqr_up(txSz) + 1) >> 1;
        int ptype = plane > 0;
        int s = plane ? 1 : 0;
        int maxX4 = MiCols >> s, maxY4 = MiRows >> s;
        int bsize = plane ? k_ss_size_lookup[MiSize][1][1] : MiSize;
        int adj = adjusted_tx(txSz);
        int bwl = floor_log2(kTxW[adj]), txw = kTxW[adj], txh = kTxH[adj];
        const int16_t* scan = default_scan(txSz);
        int eob = 0;
        for (int c = 0; c < txw * txh; c++) if (quant[scan[c]]) eob = c + 1;
        int ctx = txb_skip_ctx(plane, txSz, bsize, aboveLevel[plane].data(), aboveDc[plane].data(),
                               leftLevel[plane].data(), leftDc[plane].data(), x4, y4, maxX4, maxY4);
        coder->sym(cdf.txb_skip[txSzCtx][ctx], 2, eob == 0);
        int culLevel = 0, dcCategory = 0;
        if (eob > 0) {
            if (plane == 0) {
                int set = get_tx_set(txSz), sq = tx_sqr(txSz);
                if (set == 1) coder->sym(cdf.intra_tx[1][sq][YMode], 7, dctSymbol[1]);
                else if (set == 2) coder->sym(cdf.intra_tx[2][sq][YMode], 5, dctSymbol[2]);
            }
            int eobMultisize = std::min(floor_log2(kTxW[txSz]), 5) + std::min(floor_log2(kTxH[txSz]), 5) - 4;
            int eobPt = eob <= 2 ? eob : floor_log2(eob - 1) + 2;
            switch (eobMultisize) {
                case 0: coder->sym(cdf.eob16[ptype][0], 5, eobPt - 1); break;
                case 1: coder->sym(cdf.eob32[ptype][0], 6, eobPt - 1); break;
                case 2: coder->sym(cdf.eob64[ptype][0], 7, eobPt - 1); break;
                case 3: coder->sym(cdf.eob128[ptype][0], 8, eobPt - 1); break;
                case 4: coder->sym(cdf.eob256[ptype][0], 9, eobPt - 1); break;
                case 5: coder->sym(cdf.eob512[ptype][0], 10, eobPt - 1); break;
                default: coder->sym(cdf.eob1024[ptype][0], 11, eobPt - 1); break;
            }
            if (eobPt >= 3) {
                int rem = eob - ((1 << (eobPt - 2)) + 1), shift = eobPt - 3;
                coder->sym(cdf.eob_extra[txSzCtx][ptype][eobPt - 3], 2, (rem >> shift) & 1);
                for (int k = shift - 1; k >= 0; k--) coder->bit((rem >> k) & 1);
            }
            static thread_local int32_t lv[1024];
            for (int i = 0; i < txw * txh; i++) lv[i] = 0;
            for (int c = eob - 1; c >= 0; c--) {
                int pos = scan[c], a = std::abs(quant[pos]);
                if (c == eob - 1)
                    coder->sym(cdf.base_eob[txSzCtx][ptype][coeff_base_eob_ctx(c, txw, txh)], 3, std::min(a, 3) - 1);
                else
                    coder->sym(cdf.base[txSzCtx][ptype][coeff_base_ctx(lv, txSz, bwl, txh, pos, 0)], 4, std::min(a, 3));
                if (a > 2) {
                    int bctx = coeff_br_ctx(lv, bwl, txh, pos, 0), k = a - 3;
                    for (int idx = 0; idx < 4; idx++) {
                        int br = std::min(k, 3);
                        coder->sym(cdf.br[std::min(txSzCtx, 3)][ptype][bctx], 4, br);
                        k -= br;
                        if (br < 3) break;
                    }
                }
                lv[pos] = std::min(a, 15);
            }
            for (int c = 0; c < eob; c++) {
                int pos = scan[c], q = quant[pos], a = std::abs(q);
                if (!q) continue;
                if (c == 0)
                    coder->sym(cdf.dc_sign[ptype][dc_sign_ctx(txSz, aboveDc[plane].data(), leftDc[plane].data(),
                                                              x4, y4, maxX4, maxY4)], 2, q < 0);
                else coder->bit(q < 0);
                if (a >= 15) {   // Golomb code of a - 15
                    uint32_t g = (uint32_t)(a - 14);
                    int len = floor_log2(g) + 1;
                    for (int i = 0; i < len - 1; i++) coder->bit(0);
                    coder->bit(1);
                    for (int i = len - 2; i >= 0; i--) coder->bit((g >> i) & 1);
                }
                culLevel += a;
                if (pos == 0) dcCategory = q < 0 ? 1 : 2;
            }
            culLevel = std::min(63, culLevel);
        }
        for (int i = 0; i < w4; i++) { aboveLevel[plane][x4 + i] = (uint8_t)culLevel; aboveDc[plane][x4 + i] = (uint8_t)dcCategory; }
        for (int i = 0; i < h4; i++) { leftLevel[plane][y4 + i] = (uint8_t)culLevel; leftDc[plane][y4 + i] = (uint8_t)dcCategory; }
        return eob;
    }

    // ============================================================ the frame
    std::vector<uint8_t> encode(int cp, int tc, int mc) {
        std::vector<uint8_t> out;
        obu(out, 1, sequence_header(cp, tc, mc));
        BitWriter b;
        frame_header(b);
        b.align();
        int numTiles = tileCols * tileRows;
        if (numTiles > 1) { b.f(0, 1); b.align(); }   // tile_start_and_end_present_flag
        std::vector<uint8_t> payload = b.d;
        for (int tr = 0; tr < tileRows; tr++)
            for (int tc2 = 0; tc2 < tileCols; tc2++) {
                MiRowStart = miRowStarts[tr]; MiRowEnd = miRowStarts[tr + 1];
                MiColStart = miColStarts[tc2]; MiColEnd = miColStarts[tc2 + 1];
                std::vector<uint8_t> t = encode_tile();
                if (tr * tileCols + tc2 < numTiles - 1)
                    for (int i = 0; i < 4; i++) payload.push_back((uint8_t)((t.size() - 1) >> (8 * i)));
                payload.insert(payload.end(), t.begin(), t.end());
            }
        obu(out, 6, payload);
        return out;
    }
};

}  // namespace

extern "C" int64_t av1_encode(const uint8_t* y, const uint8_t* u, const uint8_t* v, int32_t width,
                              int32_t height, int32_t mono, int32_t qindex, int32_t cp, int32_t tc,
                              int32_t mc, uint8_t* out, int64_t cap, uint8_t* recon, int32_t* level) {
    if (width < 1 || height < 1 || width > 65536 || height > 65536 || qindex < 1 || qindex > 255) return -1;
    Encoder* e = new Encoder();
    e->W = width; e->H = height; e->mono = mono ? 1 : 0; e->qindex = qindex;
    e->setup(y, u, v);
    std::vector<uint8_t> obus = e->encode(cp, tc, mc);
    if ((int64_t)obus.size() > cap) { int64_t need = (int64_t)obus.size(); delete e; return -need - 1000; }
    memcpy(out, obus.data(), obus.size());
    level[0] = e->level();
    uint8_t* o = recon;
    for (int p = 0; p < e->numPlanes; p++) {
        int pw = p ? e->cw : e->W, ph = p ? e->ch : e->H;
        for (int r = 0; r < ph; r++)
            for (int c = 0; c < pw; c++) *o++ = (uint8_t)*e->rec[p].at(r, c);
    }
    delete e;
    return (int64_t)obus.size();
}
