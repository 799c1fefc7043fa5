// AV1 definitions that native/av1.cc (the decoder) and native/av1_enc.cc
// (the still-picture encoder) share, so that the encoder reconstructs each
// block exactly as the decoder does: block and transform sizes, intra
// modes, the CDF set of a frame, the scan orders, the coefficient contexts
// (5.11.39), the quantiser lookups (7.12.2) and intra prediction (7.11.2).
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <type_traits>
#include <vector>

#include "av1_dsp.h"
#include "av1_tables.h"

namespace av1 {

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
       PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
       BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64,
       BLOCK_64X16, BLOCK_INVALID = 255 };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4,
       TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16,
       TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };

const int kNum4x4W[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const int kNum4x4H[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
const int kMiWLog2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const int kMiHLog2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
const int kMaxTxRect[22] = {TX_4X4, TX_4X8, TX_8X4, TX_8X8, TX_8X16, TX_16X8,
    TX_16X16, TX_16X32, TX_32X16, TX_32X32, TX_32X64, TX_64X32, TX_64X64,
    TX_64X64, TX_64X64, TX_64X64, TX_4X16, TX_16X4, TX_8X32, TX_32X8,
    TX_16X64, TX_64X16};
const int kTxW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const int kTxH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const int kSplitTx[19] = {TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4,
    TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
    TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16};
const int kRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};
const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int kFilterIntraDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
const int kModeToTxfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST,
    ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    ADST_ADST, DCT_DCT};
const int kCoeffBaseCtxOffset[3][5][5] = {
    {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}},
    {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}},
    {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}}};
const int kSigRefDiff[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int kMagRefOffset[3][3][2] = {
    {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};

static inline int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return 2;  // vertical
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return 1;  // horizontal
    return 0;
}
static inline int tx_from_wh(int w, int h) {
    for (int t = 0; t < 19; t++) if (kTxW[t] == w && kTxH[t] == h) return t;
    return -1;
}
static inline int block_from_wh(int w4, int h4) {
    for (int b = 0; b < 22; b++) if (kNum4x4W[b] == w4 && kNum4x4H[b] == h4) return b;
    return BLOCK_INVALID;
}
static inline int tx_sqr(int t) { int m = std::min(kTxW[t], kTxH[t]); return tx_from_wh(m, m); }
static inline int tx_sqr_up(int t) { int m = std::max(kTxW[t], kTxH[t]); return tx_from_wh(m, m); }
static inline int adjusted_tx(int t) { return tx_from_wh(std::min(32, kTxW[t]), std::min(32, kTxH[t])); }
static inline int is_directional(int m) { return m >= V_PRED && m <= D67_PRED; }

struct Cdfs {
    uint16_t partition[20][11], kf_y_mode[5][5][14], uv_mode[2][13][15];
    uint16_t angle_delta[8][8], intrabc[3], skip[3][3], seg[3][9];
    uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5], tx_size[4][3][4];
    uint16_t filter_intra[22][3], filter_intra_mode[6];
    uint16_t pal_y_size[7][8], pal_uv_size[7][8], pal_y_mode[7][3][3], pal_uv_mode[2][3];
    uint16_t pal_y_color[7][5][9], pal_uv_color[7][5][9];
    uint16_t cfl_sign[9], cfl_alpha[6][17], intra_tx[3][4][13][17], inter_tx[4][4][17], txfm_part[21][3];
    uint16_t switchable_restore[4], wiener[3], sgrproj[3];
    uint16_t txb_skip[5][13][3], eob16[2][2][6], eob32[2][2][7], eob64[2][2][8];
    uint16_t eob128[2][2][9], eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
    uint16_t eob_extra[5][2][9][3], dc_sign[2][3][3], base_eob[5][2][4][4];
    uint16_t base[5][2][42][5], br[5][2][21][5];
    // inter frames
    uint16_t y_mode[4][14], intra_inter[4][3], single_ref[3][6][3], newmv[6][3], zeromv[2][3];
    uint16_t refmv[6][3], drl[3][3], interp[16][4], motion_mode[22][4], obmc[22][3];
    uint16_t interintra[4][3], comp_inter[5][3], skip_mode[3][3], seg_pred[3][3], nmv[143];
    uint16_t interintra_mode[4][5], wedge_interintra[22][3], wedge_idx[22][17];
    uint16_t comp_ref_type[5][3], uni_comp_ref[3][3][3], comp_ref[3][3][3], comp_bwdref[3][2][3];
    uint16_t compound_mode[8][9], comp_group_idx[6][3], compound_idx[6][3], compound_type[22][3];

    // libaom's av1_reset_cdf_symbol_counters: the counter after each CDF's
    // last symbol, for the number of symbols each is read with
    template <typename T> static void zero(T& a, int n) {
        uint16_t* p = reinterpret_cast<uint16_t*>(&a);
        const size_t last = std::extent<T, std::rank<T>::value - 1>::value;
        for (size_t i = 0; i + last <= sizeof(a) / sizeof(uint16_t); i += last) p[i + n] = 0;
    }
    void reset_counters() {
        for (int i = 0; i < 20; i++) {
            int n = i < 4 ? 4 : i < 16 ? 10 : 8;
            partition[i][n] = 0;
        }
        zero(kf_y_mode, 13); zero(uv_mode[0], 13); zero(uv_mode[1], 14); zero(angle_delta, 7);
        zero(intrabc, 2); zero(skip, 2); zero(seg, 8); zero(delta_q, 4); zero(delta_lf, 4);
        zero(delta_lf_multi, 4); zero(tx_size[0], 2); zero(tx_size[1], 3); zero(tx_size[2], 3);
        zero(tx_size[3], 3); zero(filter_intra, 2); zero(filter_intra_mode, 5);
        zero(pal_y_size, 7); zero(pal_uv_size, 7); zero(pal_y_mode, 2); zero(pal_uv_mode, 2);
        for (int k = 0; k < 7; k++) { zero(pal_y_color[k], k + 2); zero(pal_uv_color[k], k + 2); }
        zero(cfl_sign, 8); zero(cfl_alpha, 16); zero(intra_tx[1], 7); zero(intra_tx[2], 5);
        zero(inter_tx[1], 16); zero(inter_tx[2], 12); zero(inter_tx[3], 2); zero(txfm_part, 2);
        zero(switchable_restore, 3); zero(wiener, 2); zero(sgrproj, 2);
        zero(txb_skip, 2); zero(eob16, 5); zero(eob32, 6); zero(eob64, 7); zero(eob128, 8);
        zero(eob256, 9); zero(eob512, 10); zero(eob1024, 11); zero(eob_extra, 2); zero(dc_sign, 2);
        zero(base_eob, 3); zero(base, 4); zero(br, 4);
        zero(y_mode, 13); zero(intra_inter, 2); zero(single_ref, 2); zero(newmv, 2); zero(zeromv, 2);
        zero(refmv, 2); zero(drl, 2); zero(interp, 3); zero(motion_mode, 3); zero(obmc, 2);
        zero(interintra, 2); zero(comp_inter, 2); zero(skip_mode, 2); zero(seg_pred, 2);
        zero(interintra_mode, 4); zero(wedge_interintra, 2); zero(wedge_idx, 16);
        zero(comp_ref_type, 2); zero(uni_comp_ref, 2); zero(comp_ref, 2); zero(comp_bwdref, 2);
        zero(compound_mode, 8); zero(comp_group_idx, 2); zero(compound_idx, 2); zero(compound_type, 2);
        // nmv: joints, then per component classes, class0_fr (2), fr, sign,
        // class0_hp, hp, class0, bits (10)
        nmv[4] = 0;
        for (int c = 0; c < 2; c++) {
            uint16_t* m = nmv + 5 + 69 * c;
            m[11] = 0; m[12 + 4] = 0; m[17 + 4] = 0; m[22 + 4] = 0; m[27 + 2] = 0;
            m[30 + 2] = 0; m[33 + 2] = 0; m[36 + 2] = 0;
            for (int i = 0; i < 10; i++) m[39 + 3 * i + 2] = 0;
        }
    }

    void init(int baseQ) {
#define CP(dst, src) static_assert(sizeof(dst) == sizeof(src), #dst); memcpy(dst, src, sizeof(dst))
        CP(partition, k_partition_cdf); CP(kf_y_mode, k_kf_y_mode_cdf); CP(uv_mode, k_uv_mode_cdf);
        CP(angle_delta, k_angle_delta_cdf); CP(intrabc, k_intrabc_cdf); CP(skip, k_skip_cdf);
        CP(seg, k_spatial_pred_seg_cdf); CP(delta_q, k_delta_q_cdf); CP(delta_lf, k_delta_lf_cdf);
        CP(delta_lf_multi, k_delta_lf_multi_cdf); CP(tx_size, k_tx_size_cdf);
        CP(filter_intra, k_filter_intra_cdfs); CP(filter_intra_mode, k_filter_intra_mode_cdf);
        CP(pal_y_size, k_palette_y_size_cdf); CP(pal_uv_size, k_palette_uv_size_cdf);
        CP(pal_y_mode, k_palette_y_mode_cdf); CP(pal_uv_mode, k_palette_uv_mode_cdf);
        CP(pal_y_color, k_palette_y_color_cdf); CP(pal_uv_color, k_palette_uv_color_cdf);
        CP(cfl_sign, k_cfl_sign_cdf); CP(cfl_alpha, k_cfl_alpha_cdf); CP(intra_tx, k_intra_ext_tx_cdf);
        CP(inter_tx, k_inter_ext_tx_cdf); CP(txfm_part, k_txfm_partition_cdf);
        CP(switchable_restore, k_switchable_restore_cdf); CP(wiener, k_wiener_restore_cdf);
        CP(sgrproj, k_sgrproj_restore_cdf);
        CP(y_mode, k_y_mode_cdf); CP(intra_inter, k_intra_inter_cdf); CP(single_ref, k_single_ref_cdf);
        CP(newmv, k_newmv_cdf); CP(zeromv, k_zeromv_cdf); CP(refmv, k_refmv_cdf); CP(drl, k_drl_cdf);
        CP(interp, k_switchable_interp_cdf); CP(motion_mode, k_motion_mode_cdf); CP(obmc, k_obmc_cdf);
        CP(interintra, k_interintra_cdf); CP(comp_inter, k_comp_inter_cdf); CP(skip_mode, k_skip_mode_cdf);
        CP(seg_pred, k_seg_pred_cdf); CP(nmv, k_nmv_cdf);
        CP(interintra_mode, k_interintra_mode_cdf); CP(wedge_interintra, k_wedge_interintra_cdf);
        CP(wedge_idx, k_wedge_idx_cdf);
        CP(comp_ref_type, k_comp_ref_type_cdf); CP(uni_comp_ref, k_uni_comp_ref_cdf); CP(comp_ref, k_comp_ref_cdf);
        CP(comp_bwdref, k_comp_bwdref_cdf); CP(compound_mode, k_compound_mode_cdf);
        CP(comp_group_idx, k_comp_group_idx_cdf); CP(compound_idx, k_compound_idx_cdf);
        CP(compound_type, k_compound_type_cdf);
        int q = baseQ <= 20 ? 0 : baseQ <= 60 ? 1 : baseQ <= 120 ? 2 : 3;
        CP(txb_skip, k_txb_skip_cdf[q]); CP(eob16, k_eob_multi16_cdf[q]); CP(eob32, k_eob_multi32_cdf[q]);
        CP(eob64, k_eob_multi64_cdf[q]); CP(eob128, k_eob_multi128_cdf[q]);
        CP(eob256, k_eob_multi256_cdf[q]); CP(eob512, k_eob_multi512_cdf[q]);
        CP(eob1024, k_eob_multi1024_cdf[q]); CP(eob_extra, k_eob_extra_cdf[q]);
        CP(dc_sign, k_dc_sign_cdf[q]); CP(base_eob, k_coeff_base_eob_cdf[q]);
        CP(base, k_coeff_base_cdf[q]); CP(br, k_coeff_br_cdf[q]);
#undef CP
    }
};

struct Plane {
    std::vector<uint16_t> px; int stride = 0, w = 0, h = 0;  // w, h: allocated
    uint16_t* at(int y, int x) { return &px[(size_t)y * stride + x]; }
    uint16_t get(int y, int x) const { return px[(size_t)y * stride + x]; }
};

static inline int dc_q(int bitDepth, int b) { return k_dc_qlookup[(bitDepth - 8) >> 1][clip3(0, 255, b)]; }
static inline int ac_q(int bitDepth, int b) { return k_ac_qlookup[(bitDepth - 8) >> 1][clip3(0, 255, b)]; }

// the shift of a transform size's dequantized coefficients (7.12.3)
static inline int dq_shift(int txSz) {
    if (txSz == TX_32X32 || txSz == TX_16X32 || txSz == TX_32X16 || txSz == TX_16X64 || txSz == TX_64X16) return 1;
    if (txSz == TX_64X64 || txSz == TX_32X64 || txSz == TX_64X32) return 2;
    return 0;
}

// 7.12.3: the coefficients of a tw x th block (row by row) from their
// quantized levels, with a quantizer matrix or none
static inline void dequantize(const int32_t* quant, int32_t* coef, int tw, int th, int dcQ, int acQ,
                              int shift, const uint8_t* qm, int bitDepth) {
    int maxC = (1 << (7 + bitDepth)) - 1, minC = -(1 << (7 + bitDepth));
    for (int i = 0; i < th; i++) for (int j = 0; j < tw; j++) {
        int pos = i * tw + j;
        int32_t q = quant[pos];
        if (!q) { coef[pos] = 0; continue; }
        int dqv = pos == 0 ? dcQ : acQ;
        if (qm) dqv = (qm[pos] * dqv + 16) >> 5;
        int64_t a = std::abs((int64_t)q);
        int64_t dq = ((a * dqv) & 0xFFFFFF) >> shift;
        if (q < 0) dq = -dq;
        coef[pos] = (int32_t)std::max<int64_t>(minC, std::min<int64_t>(maxC, dq));
    }
}

// the scan of a transform size under a 2-D transform type (a 64-sample
// side codes only its first 32)
static inline const int16_t* default_scan(int txSz) {
    static int offsets[19] = {-1};
    if (offsets[0] == -1) {
        int off = 0;
        for (int t = 0; t < 19; t++) {
            if (kTxW[t] == 64 || kTxH[t] == 64) { offsets[t] = -2; continue; }
            offsets[t] = off; off += kTxW[t] * kTxH[t];
        }
    }
    int t = txSz;
    if (t == TX_16X64) t = TX_16X32;
    else if (t == TX_64X16) t = TX_32X16;
    else if (tx_sqr_up(t) == TX_64X64) t = TX_32X32;
    return k_default_scan + offsets[t];
}

// the all_zero context of a transform block at (x4, y4), in 4-sample units
// of its plane, from the levels and DC categories above and to the left
static inline int txb_skip_ctx(int plane, int txSz, int bsize, const uint8_t* aboveLevel,
                               const uint8_t* aboveDc, const uint8_t* leftLevel, const uint8_t* leftDc,
                               int x4, int y4, int maxX4, int maxY4) {
    int w4 = kTxW[txSz] >> 2, h4 = kTxH[txSz] >> 2, w = kTxW[txSz], h = kTxH[txSz];
    int ctx;
    if (plane == 0) {
        int top = 0, left = 0;
        for (int k = 0; k < w4; k++) if (x4 + k < maxX4) top = std::max(top, (int)aboveLevel[x4 + k]);
        for (int k = 0; k < h4; k++) if (y4 + k < maxY4) left = std::max(left, (int)leftLevel[y4 + k]);
        top = std::min(top, 255); left = std::min(left, 255);
        if (kNum4x4W[bsize] * 4 == w && kNum4x4H[bsize] * 4 == h) ctx = 0;
        else if (top == 0 && left == 0) ctx = 1;
        else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
        else if (std::max(top, left) <= 3) ctx = 4;
        else if (std::min(top, left) <= 3) ctx = 5;
        else ctx = 6;
    } else {
        int above = 0, left = 0;
        for (int i = 0; i < w4; i++) if (x4 + i < maxX4) { above |= aboveLevel[x4 + i]; above |= aboveDc[x4 + i]; }
        for (int i = 0; i < h4; i++) if (y4 + i < maxY4) { left |= leftLevel[y4 + i]; left |= leftDc[y4 + i]; }
        ctx = (above != 0) + (left != 0) + 7;
        if (kNum4x4W[bsize] * kNum4x4H[bsize] * 16 > w * h) ctx += 3;
    }
    return ctx;
}

// the dc_sign context: the signs of the DC coefficients above and left
static inline int dc_sign_ctx(int txSz, const uint8_t* aboveDc, const uint8_t* leftDc,
                              int x4, int y4, int maxX4, int maxY4) {
    int dcSign = 0;
    for (int k = 0; k < (kTxW[txSz] >> 2); k++) if (x4 + k < maxX4) {
        int s = aboveDc[x4 + k];
        if (s == 1) dcSign--; else if (s == 2) dcSign++;
    }
    for (int k = 0; k < (kTxH[txSz] >> 2); k++) if (y4 + k < maxY4) {
        int s = leftDc[y4 + k];
        if (s == 1) dcSign--; else if (s == 2) dcSign++;
    }
    return dcSign < 0 ? 1 : dcSign > 0 ? 2 : 0;
}

// the coeff_base_eob context of the last coefficient, at scan index c
static inline int coeff_base_eob_ctx(int c, int txw, int txh) {
    return c == 0 ? 0 : (c <= (txh * txw) / 8 ? 1 : (c <= (txh * txw) / 4 ? 2 : 3));
}

// the coeff_base and coeff_br contexts from the levels coded so far
// (quant: row by row, 1 << bwl wide)
static inline int coeff_base_ctx(const int32_t* quant, int txSz, int bwl, int txh, int pos, int cls) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int idx = 0; idx < 5; idx++) {
        int rr = row + kSigRefDiff[cls][idx][0], cc = col + kSigRefDiff[cls][idx][1];
        if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
            mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
    }
    int ctx = std::min((mag + 1) >> 1, 4);
    if (cls == 0) {
        if (row == 0 && col == 0) return 0;
        int shape = kTxW[txSz] == kTxH[txSz] ? 0 : (kTxW[txSz] > kTxH[txSz] ? 1 : 2);
        return ctx + kCoeffBaseCtxOffset[shape][std::min(row, 4)][std::min(col, 4)];
    }
    int idx = cls == 2 ? row : col;
    static const int posOff[3] = {26, 31, 36};
    return ctx + posOff[std::min(idx, 2)];
}

static inline int coeff_br_ctx(const int32_t* quant, int bwl, int txh, int pos, int cls) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int idx = 0; idx < 3; idx++) {
        int rr = row + kMagRefOffset[cls][idx][0], cc = col + kMagRefOffset[cls][idx][1];
        if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
            mag += std::min(quant[rr * (1 << bwl) + cc], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == 0) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
    if (cls == 1) return col == 0 ? mag + 7 : mag + 14;
    return row == 0 ? mag + 7 : mag + 14;
}

// ---------------------------------------------------------------------------
// intra prediction (7.11.2)
// ---------------------------------------------------------------------------

static inline int edge_filter_strength(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h, s = 0;
    if (filterType == 0) {
        if (blkWh <= 8) { if (d >= 56) s = 1; }
        else if (blkWh <= 12) { if (d >= 40) s = 1; }
        else if (blkWh <= 16) { if (d >= 40) s = 1; }
        else if (blkWh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
        else if (blkWh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
        else { if (d >= 1) s = 3; }
    } else {
        if (blkWh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
        else if (blkWh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
        else if (blkWh <= 24) { if (d >= 4) s = 3; }
        else { if (d >= 1) s = 3; }
    }
    return s;
}
static inline void edge_filter(int* buf /* buf[-1..] valid */, int sz, int strength) {
    if (!strength) return;
    static const int kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) { int k = clip3(0, sz - 1, i - 2 + j); s += kernel[strength - 1][j] * edge[k]; }
        buf[i - 1] = (s + 8) >> 4;
    }
}
static inline int use_upsample(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return filterType ? blkWh <= 8 : blkWh <= 16;
}
static inline void edge_upsample(int* buf, int numPx, int bitDepth) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < numPx; i++) dup[i + 2] = buf[i];
    dup[numPx + 2] = buf[numPx - 1];
    buf[-2] = dup[0];
    int maxv = (1 << bitDepth) - 1;
    for (int i = 0; i < numPx; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        s = clip3(0, maxv, round2(s, 4));
        buf[2 * i - 1] = s;
        buf[2 * i] = dup[i + 2];
    }
}

// 7.11.2: the intra prediction of a (1 << log2W) x (1 << log2H) block at
// (x, y) of a plane whose sample (0, 0) is px; maxX, maxY: the plane's last
// column and row inside the mode info grid; edgeFilter: -1 without the
// intra edge filter, else the filter type of the neighbours (smooth or
// not); filterIntraMode: -1, or the recursive filter's mode (luma)
static inline void predict_intra(uint16_t* px, int stride, int x, int y, int maxX, int maxY,
                                 int bitDepth, int haveLeft, int haveAbove, int haveAboveRt,
                                 int haveBelowLt, int mode, int angleDelta, int log2W, int log2H,
                                 int edgeFilter, int filterIntraMode) {
    auto get = [&](int r, int c) { return (int)px[(size_t)r * stride + c]; };
    int w = 1 << log2W, h = 1 << log2H;
    int base = 1 << (bitDepth - 1);
    int aboveBuf[300], leftBuf[300];
    int* AboveRow = aboveBuf + 16;
    int* LeftCol = leftBuf + 16;
    int n = w + h;
    if (!haveAbove && haveLeft) { int v = get(y, x - 1); for (int i = -1; i < n; i++) AboveRow[i] = v; }
    else if (!haveAbove && !haveLeft) { for (int i = -1; i < n; i++) AboveRow[i] = base - 1; }
    else {
        int aboveLimit = std::min(maxX, x + (haveAboveRt ? 2 * w : w) - 1);
        for (int i = 0; i < n; i++) AboveRow[i] = get(y - 1, std::min(aboveLimit, x + i));
    }
    if (!haveLeft && haveAbove) { int v = get(y - 1, x); for (int i = -1; i < n; i++) LeftCol[i] = v; }
    else if (!haveLeft && !haveAbove) { for (int i = -1; i < n; i++) LeftCol[i] = base + 1; }
    else {
        int leftLimit = std::min(maxY, y + (haveBelowLt ? 2 * h : h) - 1);
        for (int i = 0; i < n; i++) LeftCol[i] = get(std::min(leftLimit, y + i), x - 1);
    }
    int corner;
    if (haveAbove && haveLeft) corner = get(y - 1, x - 1);
    else if (haveAbove) corner = get(y - 1, x);
    else if (haveLeft) corner = get(y, x - 1);
    else corner = base;
    AboveRow[-1] = corner; LeftCol[-1] = corner;
    int maxv = (1 << bitDepth) - 1;
    static thread_local int pred[64][64];
    if (filterIntraMode >= 0) {
        // recursive filter intra (7.11.2.3)
        int w4 = w >> 2, h2 = h >> 1;
        for (int i2 = 0; i2 < h2; i2++) for (int j4 = 0; j4 < w4; j4++) {
            int p[7];
            for (int i = 0; i < 7; i++) {
                if (i < 5) {
                    if (i2 == 0) p[i] = AboveRow[(j4 << 2) + i - 1];
                    else if (j4 == 0 && i == 0) p[i] = LeftCol[(i2 << 1) - 1];
                    else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                } else {
                    if (j4 == 0) p[i] = LeftCol[(i2 << 1) + i - 5];
                    else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                }
            }
            for (int i = 0; i < 8; i++) {
                int pr = 0;
                for (int j = 0; j < 7; j++) pr += k_filter_intra_taps[filterIntraMode][i][j] * p[j];
                pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip3(0, maxv, round2signed(pr, 4));
            }
        }
    } else if (is_directional(mode)) {
        int pAngle = kModeToAngle[mode] + angleDelta * 3;
        int upA = 0, upL = 0;
        if (edgeFilter >= 0) {
            int filterType = edgeFilter;
            if (pAngle != 90 && pAngle != 180) {
                if (pAngle > 90 && pAngle < 180 && (w + h) >= 24) {
                    int s = round2(LeftCol[0] * 5 + AboveRow[-1] * 6 + AboveRow[0] * 5, 4);
                    LeftCol[-1] = s; AboveRow[-1] = s;
                }
                if (haveAbove) {
                    int strength = edge_filter_strength(w, h, filterType, pAngle - 90);
                    int numPx = std::min(w, maxX - x + 1) + (pAngle < 90 ? h : 0) + 1;
                    edge_filter(AboveRow, numPx, strength);
                }
                if (haveLeft) {
                    int strength = edge_filter_strength(w, h, filterType, pAngle - 180);
                    int numPx = std::min(h, maxY - y + 1) + (pAngle > 180 ? w : 0) + 1;
                    edge_filter(LeftCol, numPx, strength);
                }
            }
            upA = use_upsample(w, h, filterType, pAngle - 90);
            if (upA) edge_upsample(AboveRow, w + (pAngle < 90 ? h : 0), bitDepth);
            upL = use_upsample(w, h, filterType, pAngle - 180);
            if (upL) edge_upsample(LeftCol, h + (pAngle > 180 ? w : 0), bitDepth);
        }
        int dx = 0, dy = 0;
        if (pAngle < 90) dx = k_dr_intra_derivative[pAngle];
        else if (pAngle > 90 && pAngle < 180) dx = k_dr_intra_derivative[180 - pAngle];
        if (pAngle > 90 && pAngle < 180) dy = k_dr_intra_derivative[pAngle - 90];
        else if (pAngle > 180) dy = k_dr_intra_derivative[270 - pAngle];
        if (pAngle < 90) {
            int maxBaseX = (w + h - 1) << upA;
            for (int i = 0; i < h; i++) {
                int idx = (i + 1) * dx;
                int shift = ((idx << upA) & 0x3F) >> 1;
                int b = idx >> (6 - upA);
                for (int j = 0; j < w; j++, b += 1 << upA) {
                    if (b < maxBaseX) pred[i][j] = round2(AboveRow[b] * (32 - shift) + AboveRow[b + 1] * shift, 5);
                    else pred[i][j] = AboveRow[maxBaseX];
                }
            }
        } else if (pAngle > 90 && pAngle < 180) {
            for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
                int idx = (j << 6) - (i + 1) * dx;
                int b = idx >> (6 - upA);
                if (b >= -(1 << upA)) {
                    int shift = ((idx * (1 << upA)) & 0x3F) >> 1;
                    pred[i][j] = round2(AboveRow[b] * (32 - shift) + AboveRow[b + 1] * shift, 5);
                } else {
                    idx = (i << 6) - (j + 1) * dy;
                    b = idx >> (6 - upL);
                    int shift = ((idx * (1 << upL)) & 0x3F) >> 1;
                    pred[i][j] = round2(LeftCol[b] * (32 - shift) + LeftCol[b + 1] * shift, 5);
                }
            }
        } else if (pAngle > 180) {
            int maxBaseY = (w + h - 1) << upL;
            for (int j = 0; j < w; j++) {
                int idx = (j + 1) * dy;
                int shift = ((idx << upL) & 0x3F) >> 1;
                int b = idx >> (6 - upL);
                for (int i = 0; i < h; i++, b += 1 << upL) {
                    if (b < maxBaseY) pred[i][j] = round2(LeftCol[b] * (32 - shift) + LeftCol[b + 1] * shift, 5);
                    else pred[i][j] = LeftCol[maxBaseY];
                }
            }
        } else if (pAngle == 90) {
            for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) pred[i][j] = AboveRow[j];
        } else {
            for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) pred[i][j] = LeftCol[i];
        }
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
        const uint8_t* wx = k_smooth_weights + w - 4;
        const uint8_t* wy = k_smooth_weights + h - 4;
        for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
            if (mode == SMOOTH_PRED)
                pred[i][j] = round2(wy[i] * AboveRow[j] + (256 - wy[i]) * LeftCol[h - 1] +
                                    wx[j] * LeftCol[i] + (256 - wx[j]) * AboveRow[w - 1], 9);
            else if (mode == SMOOTH_V_PRED)
                pred[i][j] = round2(wy[i] * AboveRow[j] + (256 - wy[i]) * LeftCol[h - 1], 8);
            else
                pred[i][j] = round2(wx[j] * LeftCol[i] + (256 - wx[j]) * AboveRow[w - 1], 8);
        }
    } else if (mode == DC_PRED) {
        int avg;
        if (haveAbove && haveLeft) {
            int sum = 0;
            for (int k = 0; k < h; k++) sum += LeftCol[k];
            for (int k = 0; k < w; k++) sum += AboveRow[k];
            sum += (w + h) >> 1;
            avg = sum / (w + h);
        } else if (haveLeft) {
            int sum = 0; for (int k = 0; k < h; k++) sum += LeftCol[k];
            avg = clip3(0, maxv, (sum + (h >> 1)) >> log2H);
        } else if (haveAbove) {
            int sum = 0; for (int k = 0; k < w; k++) sum += AboveRow[k];
            avg = clip3(0, maxv, (sum + (w >> 1)) >> log2W);
        } else avg = 1 << (bitDepth - 1);
        for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) pred[i][j] = avg;
    } else {  // PAETH
        for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
            int b = AboveRow[j] + LeftCol[i] - AboveRow[-1];
            int pL = std::abs(b - LeftCol[i]), pT = std::abs(b - AboveRow[j]), pTL = std::abs(b - AboveRow[-1]);
            if (pL <= pT && pL <= pTL) pred[i][j] = LeftCol[i];
            else if (pT <= pTL) pred[i][j] = AboveRow[j];
            else pred[i][j] = AboveRow[-1];
        }
    }
    for (int i = 0; i < h; i++) {
        uint16_t* row = px + (size_t)(y + i) * stride + x;
        for (int j = 0; j < w; j++) row[j] = (uint16_t)pred[i][j];
    }
}

}  // namespace av1
