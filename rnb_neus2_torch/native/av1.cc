// AV1 decoder for the port's AVIF reader (io/avif.py): the OBUs of an AVIF
// item or sample to the Y, U and V planes of the frame libaom hands libavif,
// bit for bit as the AV1 specification and libaom decode them.
//
// Follows the specification's decoding process and its names: OBU and
// header syntax (5.3-5.9), the symbol decoder with CDF adaptation (8.2),
// block syntax (5.11) with intra block copy, and prediction and
// reconstruction (7.11-7.13), then the in-loop filters in order:
// deblocking (7.14), CDEF (7.15) and loop restoration (7.17), with superres
// upscaling (7.16) between CDEF and loop restoration, then film grain
// synthesis (7.18.3, av1_grain.h) on the output as libaom's
// av1_add_film_grain applies it for libavif. Every frame of the operating
// point is decoded: key, intra-only, inter and switch frames, and frames
// shown again (show_existing_frame, 7.21), as libaom writes them for
// libavif's layers and sequences and in its plain multi-frame streams with
// look-ahead: the reference slots and their saved state (7.20: CDFs, loop
// filter deltas, segmentation features and ids, global motion, film
// grain); the inter frame header with the skip mode's references (5.9.22)
// and global motion models coded against the primary reference's
// (5.9.24-5.9.25); segmentation in inter frames with map and temporal
// updates (5.11.19); one or two references per block (5.11.25, with
// libaom's neighbour contexts) and the skip mode; motion vector prediction
// for both with its temporal candidates from the motion field (7.9-7.10);
// translation at any reference scale, global and local warped motion,
// OBMC, smooth and wedge inter-intra, and compound prediction averaged,
// weighted by frame distance, or blended by a wedge or a difference mask
// (7.11.3) with libaom's roundings; variable inter transforms; the loop
// filter's reference and mode deltas; superres and film grain in any
// frame. Where libaom differs from the specification this follows libaom
// (warp samples stepped by each neighbour's size, a missing temporal
// candidate making the zero-MV context 1, the compound extra search). The
// output is the last shown frame, or the first one of a chosen spatial
// layer. The tools libaom's encoder never writes (see Tool) are refused
// with ERR_TOOL; large-scale tile has its own code; so has what libaom
// rejects (a tile whose symbols overrun it or end without the trailing
// bits, an invalid segment id, a reference that was never decoded, a slot
// shown again that holds no showable frame, ...).
//
// C interface (ctypes, io/native.py):
//   av1_decode(obus, n, info[32], planes, cap, census[192], op, layer)
//     -> 0 or < 0
// info receives the sequence header's and the output frame's values (see
// INFO_*); planes receives Y, then U, then V (uint16, each plane's width x
// height, row by row) when cap (in samples) is large enough for the
// sequence's largest frame; otherwise the call returns -(samples needed) -
// 1000 after the first frame header and decodes nothing. op is the
// operating point (one the stream lacks is point 0, as libaom takes it);
// layer is -1 for the last shown frame, else a spatial id. census counts
// the coding tools the frames used (see CENSUS_*).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>

#include "av1_common.h"
#include "av1_dsp.h"
#include "av1_grain.h"
#include "av1_tables.h"

using namespace av1;

namespace {

enum Err {
    ERR_BITSTREAM = -1,      // malformed or truncated: libaom fails too
    ERR_LARGE_SCALE_TILE = -4,
    ERR_NO_FRAME = -8,
    ERR_TOOL = -9,           // an inter tool the port does not decode (INFO_TOOL)
};

enum Info {
    INFO_WIDTH, INFO_HEIGHT, INFO_BITDEPTH, INFO_MONO, INFO_SSX, INFO_SSY,
    INFO_CP, INFO_TC, INFO_MC, INFO_RANGE, INFO_PROFILE, INFO_STILL,
    INFO_REDUCED, INFO_CSP, INFO_FRAME_TYPE, INFO_OPERATING_POINTS, INFO_LEVEL, INFO_TIER,
    INFO_TOOL, INFO_FRAMES, INFO_SPATIAL_ID, INFO_BASE_Q_IDX,
};

// the inter tools refused by name (ERR_TOOL; io/avif.py names them): those
// no setting of libaom's encoder writes (its sequence headers never enable
// dual filters, it picks no bilinear filter, updates no loop filter delta
// in an inter frame and never signals references short); numbers 1-5, 10
// and 11 named tools decoded since
enum Tool { TOOL_FRAME_REFS_SHORT = 6, TOOL_BILINEAR = 7, TOOL_DUAL_FILTER = 8, TOOL_LF_DELTAS = 9 };

enum Census {
    C_PARTITION = 0,      // 10 partition kinds
    C_YMODE = 10,         // 13 luma modes
    C_UVMODE = 23,        // 14 chroma modes (13 = CFL)
    C_PALETTE_Y = 37, C_PALETTE_UV = 38, C_FILTER_INTRA = 39, C_INTRABC = 40,
    C_TXTYPE = 41,        // 16 transform types
    C_TXSIZE = 57,        // 19 transform sizes
    C_DEBLOCK = 76, C_CDEF = 77, C_LR_WIENER = 78, C_LR_SGRPROJ = 79,
    C_LR_SWITCHABLE = 80, C_SEGMENTATION = 81, C_DELTA_Q = 82, C_DELTA_LF = 83,
    C_TILES = 84, C_SB128 = 85, C_QMATRIX = 86, C_LOSSLESS = 87,
    C_SEGMENT_IDS = 94, C_SUPERRES = 95, C_FILM_GRAIN = 96,
    // inter frames: frames, blocks, intra blocks among them, the four
    // single-reference modes, a DRL index read, scaled references (block
    // predictions), the regular, smooth and sharp filters, wedge inter-intra,
    // split inter transforms, extra MV searches, high-precision MV frames,
    // switchable filter frames, CDFs loaded from a reference, local warps
    // that fall back to translation, inter frames with loop restoration,
    // sub-8x8 chroma from several blocks, frames above spatial layer 0,
    // skipped inter blocks, deblocked inter frames, temporal MV candidates,
    // motion modes read, frames with reference MVs, OBMC, local warps,
    // inter frames with CDEF, smooth or wedge inter-intra
    C_INTER_FRAMES = 97, C_INTER_BLOCKS = 98, C_INTRA_IN_INTER = 99,
    C_NEARESTMV = 100, C_NEARMV = 101, C_GLOBALMV = 102, C_NEWMV = 103, C_DRL = 104,
    C_SCALED_REF = 105, C_FILTER = 106, C_WEDGE_INTERINTRA = 109, C_VAR_TX = 110,
    C_EXTRA_SEARCH = 111, C_HP_MV = 112, C_SWITCHABLE = 113, C_PRIMARY_REF = 114,
    C_LOCALWARP_INVALID = 115, C_INTER_LR = 116, C_CHROMA_SUB8X8 = 117, C_SPATIAL_LAYERS = 118,
    C_INTER_SKIP = 119, C_INTER_DEBLOCK = 120, C_TEMPORAL_MV = 121, C_MOTION_MODE_READ = 122,
    C_REF_FRAME_MVS = 123, C_OBMC = 124, C_LOCALWARP = 125, C_INTER_CDEF = 126, C_INTERINTRA = 127,
    // the tools of libaom's plain multi-frame streams: compound blocks, by
    // type (average, distance weights, wedge, difference weights),
    // skip-mode blocks, unidirectional compound references, the eight
    // compound modes; global motion models per reference (translation,
    // rotation-zoom, affine), blocks warped by one, models whose shear
    // leaves them translations; shown-existing frames (of a key frame);
    // inter frames with segmentation, their map updates, temporal updates,
    // predicted segment ids, blocks under the reference, skip and global
    // motion features, features loaded from a reference; inter frames with
    // superres, with film grain (loaded from a reference); switch frames
    C_COMPOUND = 128, C_COMP_AVERAGE = 129, C_COMP_DISTANCE = 130, C_COMP_WEDGE = 131,
    C_COMP_DIFFWTD = 132, C_SKIP_MODE = 133, C_UNIDIR_COMP = 134, C_COMPOUND_MODE = 135,
    C_GM_TRANSLATION = 143, C_GM_ROTZOOM = 144, C_GM_AFFINE = 145, C_GM_WARP = 146, C_GM_INVALID = 147,
    C_SHOW_EXISTING = 148, C_SHOW_EXISTING_KEY = 149,
    C_INTER_SEG = 150, C_SEG_UPDATE_MAP = 151, C_SEG_TEMPORAL = 152, C_SEG_PREDICTED = 153,
    C_SEG_REF_FRAME = 154, C_SEG_SKIP = 155, C_SEG_GLOBALMV = 156, C_SEG_FROM_REF = 157,
    C_SUPERRES_INTER = 161, C_GRAIN_INTER = 162, C_GRAIN_FROM_REF = 163, C_SWITCH_FRAME = 164,
    C_COUNT = 192,
};

enum { INTRA_FRAME = 0, LAST_FRAME = 1, GOLDEN_FRAME = 4, BWDREF_FRAME = 5, ALTREF2_FRAME = 6,
       ALTREF_FRAME = 7, NONE_FRAME = -1 };
enum { KEY_FRAME = 0, INTER_FRAME = 1, INTRA_ONLY_FRAME = 2, SWITCH_FRAME = 3 };
enum { NEARESTMV = 13, NEARMV = 14, GLOBALMV = 15, NEWMV = 16, NEAREST_NEARESTMV = 17,
       NEAR_NEARMV = 18, NEAREST_NEWMV = 19, NEW_NEARESTMV = 20, NEAR_NEWMV = 21, NEW_NEARMV = 22,
       GLOBAL_GLOBALMV = 23, NEW_NEWMV = 24 };
enum { COMPOUND_WEDGE, COMPOUND_DIFFWTD, COMPOUND_AVERAGE, COMPOUND_DISTANCE };
enum { IDENTITY, TRANSLATION, ROTZOOM, AFFINE };
enum { SEG_LVL_REF_FRAME = 5, SEG_LVL_SKIP = 6, SEG_LVL_GLOBALMV = 7 };
enum { EIGHTTAP = 0, EIGHTTAP_SMOOTH = 1, EIGHTTAP_SHARP = 2, BILINEAR = 3, SWITCHABLE = 4 };
const int kSizeGroup[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2};

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};
const int kWienerTapsMin[3] = {-5, -23, -17};
const int kWienerTapsMax[3] = {10, 8, 46};
const int kWienerTapsK[3] = {1, 2, 3};
const int kWienerTapsMid[3] = {3, -7, 15};
const int kSgrprojXqdMin[2] = {-96, -32};
const int kSgrprojXqdMax[2] = {31, 95};
const int kSgrprojXqdMid[2] = {-32, 31};

struct Bits {
    const uint8_t* d; size_t n; size_t pos = 0;
    uint32_t f(int k) {
        uint32_t x = 0;
        for (int i = 0; i < k; i++) {
            size_t byte = pos >> 3;
            if (byte >= n) throw (int)ERR_BITSTREAM;
            x = (x << 1) | ((d[byte] >> (7 - (pos & 7))) & 1);
            pos++;
        }
        return x;
    }
    int su(int k) { int v = (int)f(k); int m = 1 << (k - 1); return (v & m) ? v - 2 * m : v; }
    uint32_t uvlc() {
        int lz = 0;
        while (!f(1)) { if (++lz >= 32) throw (int)ERR_BITSTREAM; }
        return f(lz) + (1u << lz) - 1;
    }
    uint32_t ns(uint32_t n) {
        int w = floor_log2(n) + 1; uint32_t m = (1u << w) - n;
        uint32_t v = f(w - 1);
        if (v < m) return v;
        return (v << 1) - m + f(1);
    }
    uint32_t le(int k) { uint32_t x = 0; for (int i = 0; i < k; i++) x |= f(8) << (8 * i); return x; }
    uint32_t literal(int k) { return f(k); }
    void align() { pos = (pos + 7) & ~(size_t)7; }
};

// 8.2: the symbol decoder
struct SymDec {
    const uint8_t* d = nullptr; size_t n = 0, bitpos = 0;
    uint32_t val = 0, rng = 0; int64_t maxBits = 0, shifts = 0; bool update = true;
    uint32_t readbits(int k) {
        uint32_t x = 0;
        for (int i = 0; i < k; i++) {
            size_t byte = bitpos >> 3;
            uint32_t b = byte < n ? (d[byte] >> (7 - (bitpos & 7))) & 1 : 0;
            x = (x << 1) | b; bitpos++;
        }
        return x;
    }
    void init(const uint8_t* data, size_t sz, bool disableUpdate) {
        if (sz == 0) throw (int)ERR_BITSTREAM;
        d = data; n = sz; bitpos = 0; update = !disableUpdate;
        int numBits = (int)std::min<size_t>(sz * 8, 15);
        uint32_t buf = readbits(numBits);
        uint32_t padded = buf << (15 - numBits);
        val = ((1u << 15) - 1) ^ padded;
        rng = 1u << 15;
        maxBits = (int64_t)8 * sz - 15;
        shifts = 0;
    }
    void renorm() {
        int bits = 15 - floor_log2(rng);
        shifts += bits;
        rng <<= bits;
        int numBits = (int)std::min<int64_t>(bits, std::max<int64_t>(0, maxBits));
        uint32_t newData = readbits(numBits);
        uint32_t padded = newData << (bits - numBits);
        val = padded ^ (((val + 1) << bits) - 1);
        maxBits -= bits;
    }
    int decode(const uint16_t* cdf, int N) {
        uint32_t cur = rng, prev; int sym = -1;
        do {
            sym++; prev = cur;
            uint32_t f = cdf[sym];
            cur = (((rng >> 8) * (f >> 6)) >> 1) + 4 * (uint32_t)(N - sym - 1);
        } while (val < cur);
        rng = prev - cur; val -= cur;
        renorm();
        return sym;
    }
    int symbol(uint16_t* cdf, int N) {
        int s = decode(cdf, N);
        if (update) {
            int rate = 3 + (cdf[N] > 15) + (cdf[N] > 31) + std::min(floor_log2(N), 2);
            int tmp = 32768;
            for (int i = 0; i < N - 1; i++) {
                tmp = (i == s) ? 0 : tmp;
                if (tmp < cdf[i]) cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
                else cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
            }
            cdf[N] += (cdf[N] < 32);
        }
        return s;
    }
    // libaom's od_ec_dec_tell: the bits the symbols have used
    int64_t tell() const { return 1 + shifts; }
    bool overflowed() const { return ((tell() + 7) >> 3) > (int64_t)n; }
    // check_trailing_bits_after_symbol_coder: a 1 after the last used bit,
    // then zeros to the end of the tile
    bool trailing_ok() const {
        if (overflowed()) return false;
        int64_t nb = tell(), bytes = (nb + 7) >> 3;
        uint8_t last = d[bytes - 1], pattern = (uint8_t)(128 >> ((nb - 1) & 7));
        if ((last & (2 * pattern - 1)) != pattern) return false;
        for (size_t i = (size_t)bytes; i < n; i++) if (d[i]) return false;
        return true;
    }
    int bit() { static const uint16_t c[3] = {16384, 0, 0}; return decode(c, 2); }
    int literal(int k) { int x = 0; for (int i = 0; i < k; i++) x = 2 * x + bit(); return x; }
    int ns(int n) {
        int w = floor_log2(n) + 1, m = (1 << w) - n;
        int v = literal(w - 1);
        if (v < m) return v;
        return (v << 1) - m + literal(1);
    }
};

// what a reference slot keeps of a decoded frame (7.20)
struct RefSlot {
    bool valid = false;
    int frameType = 0, orderHint = 0, savedOrderHints[8] = {0};
    int frameWidth = 0, frameHeight = 0, upscaledWidth = 0, renderWidth = 0, renderHeight = 0;
    int miCols = 0, miRows = 0, bitDepth = 8, ssx = 1, ssy = 1, mono = 0;
    Plane planes[3];
    Cdfs cdf;
    int lfRefDeltas[8] = {0}, lfModeDeltas[2] = {0};
    int featEn[8][8] = {{0}}, featData[8][8] = {{0}};
    FilmGrain grain;
    std::vector<int8_t> mfRef;     // per 8x8: the reference of a backward motion vector, or -1
    std::vector<int16_t> mfMv;     // and that vector (row, col)
    int showable = 0, gm[8][6];    // showable_frame; SavedGmParams
    std::vector<uint8_t> segIds;   // SavedSegmentIds, miRows x miCols
};

struct Decoder {
    // ---- sequence header
    int seqSeen = 0, profile = 0, stillPicture = 0, reducedStill = 0;
    int timingInfo = 0, decoderModelInfo = 0, equalPictureInterval = 0;
    int bufferRemovalTimeLen = 0, framePresentationTimeLen = 0, opCount = 1;
    int opIdc[32] = {0}, opDecoderModel[32] = {0}, level0 = 0, tier0 = 0;
    int frameWidthBits = 0, frameHeightBits = 0, maxW = 0, maxH = 0;
    int frameIdPresent = 0, idLen = 0, sb128 = 0, enFilterIntra = 0, enIntraEdge = 0;
    int enOrderHint = 0, orderHintBits = 0, forceSct = 0, forceIntMv = 0;
    int enInterintra = 0, enMaskedCompound = 0, enWarped = 0, enDualFilter = 0, enRefFrameMvs = 0, enJntComp = 0;
    int enSuperres = 0, enCdef = 0, enRestoration = 0, filmGrainPresent = 0;
    int bitDepth = 8, mono = 0, ssx = 1, ssy = 1, cp = 2, tc = 2, mc = 2, colorRange = 0;
    int csp = 0, sepUvDelta = 0, numPlanes = 3;
    // ---- frame header
    int frameType = 0, showFrame = 1, errorResilient = 1, allowSct = 0, allowIntrabc = 0, disableCdfUpdate = 0;
    int showableFrame = 0, frameIsIntra = 1, primaryRefFrame = 7, refreshFlags = 0, orderHint = 0;
    int refFrameIdx[7] = {0}, orderHints[8] = {0}, refFrameSignBias[8] = {0};
    int allowHp = 0, forceIntegerMv = 0, interpFilter = 0, motionSwitchable = 0, useRefFrameMvs = 0;
    int referenceSelect = 0, allowWarped = 0, disableFrameEndUpdateCdf = 1, contextUpdateTileId = 0;
    int RenderWidth = 0, RenderHeight = 0, refusedTool = 0, deltaFrameIdLen = 0;
    int showExistingFrame = 0, frameToShow = 0, skipModePresent = 0, SkipModeFrame[2] = {0, 0};
    // global motion (5.9.24): gm_params per reference, its type, and
    // whether its shear allows a warp (setupShear, 7.11.3.6)
    int gmParams[8][6], gmType[8] = {0}, gmValid[8] = {0}, gmShear[8][4];
    int segUpdateMap = 0, segTemporalUpdate = 0;
    std::vector<uint8_t> prevSegIds;    // PrevSegmentIds, MiRows x MiCols (empty: all 0)
    RefSlot refs[8];
    Cdfs frameCdf, savedCdf;
    int FrameWidth = 0, FrameHeight = 0, MiCols = 0, MiRows = 0;
    int SuperresDenom = 8, UpscaledWidth = 0;
    int baseQ = 0, dqYDc = 0, dqUDc = 0, dqUAc = 0, dqVDc = 0, dqVAc = 0;
    int usingQm = 0, qmY = 15, qmU = 15, qmV = 15;
    int segEnabled = 0, featEn[8][8] = {{0}}, featData[8][8] = {{0}}, segIdPreSkip = 0, lastActiveSegId = 0;
    int deltaQPresent = 0, deltaQRes = 0, deltaLfPresent = 0, deltaLfRes = 0, deltaLfMulti = 0;
    int codedLossless = 0, allLossless = 0, losslessArr[8] = {0}, segQmLevel[3][8] = {{0}};
    int lfLevel[4] = {0}, lfSharp = 0, lfDeltaEnabled = 0;
    int lfRefDeltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lfModeDeltas[2] = {0, 0};
    int cdefDamping = 3, cdefBits = 0, cdefYPri[8] = {0}, cdefYSec[8] = {0}, cdefUvPri[8] = {0}, cdefUvSec[8] = {0};
    int frameRestType[3] = {0}, lrSize[3] = {256, 256, 256}, usesLr = 0;
    int txModeSelect = 0, reducedTxSet = 0;
    FilmGrain grain;
    int tileColsLog2 = 0, tileRowsLog2 = 0, tileCols = 1, tileRows = 1;
    int miColStarts[65], miRowStarts[65], tileSizeBytes = 4;
    int headerDone = 0, tilesDone = 0;
    // ---- frame state
    int miStride = 0, miAllocRows = 0;
    std::vector<uint8_t> miSize, yMode, uvMode, skip, isInter, segId, txSizeMi, palSize0, palSize1, lossMi, written;
    std::vector<int8_t> refFrame0;      // RefFrames[][][0]: INTRA_FRAME or LAST_FRAME..ALTREF_FRAME
    std::vector<int8_t> refFrame1;      // RefFrames[][][1]: NONE, or INTRA_FRAME for inter-intra
    std::vector<uint8_t> filt0, filt1;  // InterpFilters: vertical, horizontal
    std::vector<int16_t> mvRow, mvCol, mvRow1, mvCol1;   // Mvs[][][0] and [1]
    std::vector<uint8_t> skipModeMi, compGroupIdxMi, compoundIdxMi, segPredMi;
    std::vector<int8_t> deltaLFs;       // 4 per mi
    std::vector<uint16_t> palColors;    // 2 planes x 8 per mi
    std::vector<uint8_t> txTypes;       // luma, per 4x4
    std::vector<uint8_t> lfTx[3];       // per 4x4 of each plane
    std::vector<int8_t> cdefIdx;        // per 64x64
    int cdefStride = 0;
    Plane frame[3], cdefFrame[3], lrFrame[3];
    // loop restoration units
    std::vector<uint8_t> lrType[3];
    std::vector<int16_t> lrWiener[3];   // 2 passes x 3 per unit
    std::vector<int16_t> lrSgr[3];      // set, xqd0, xqd1 per unit
    int lrUnitRows[3] = {0}, lrUnitCols[3] = {0};
    int64_t* census = nullptr;
    // ---- tile state
    int MiRowStart = 0, MiRowEnd = 0, MiColStart = 0, MiColEnd = 0;
    Cdfs cdf;
    SymDec sd;
    std::vector<uint8_t> aboveLevel[3], aboveDc[3], leftLevel[3], leftDc[3];
    int currentQIndex = 0, deltaLF[4] = {0}, readDeltas = 0;
    int refSgrXqd[3][2], refLrWiener[3][2][3];
    uint8_t blockDecoded[3][35][35];
    // ---- block state
    int MiRow = 0, MiCol = 0, MiSize = 0, bw4 = 0, bh4 = 0, HasChroma = 0;
    int AvailU = 0, AvailL = 0, AvailUChroma = 0, AvailLChroma = 0;
    int Skip = 0, segment_id = 0, Lossless = 0, use_intrabc = 0, Mv[2] = {0, 0}, Mv1[2] = {0, 0};
    int is_inter = 0, RefFrame0 = 0, RefFrame1 = -1, interpF[2] = {0, 0}, RefMvIdx = 0, motionMode = 0;
    int interintra = 0, interintraMode = 0, wedgeInterintra = 0, wedgeIndex = 0;
    int skipMode = 0, compoundType = COMPOUND_AVERAGE, compGroupIdx = 0, compoundIdx = 1, wedgeSign = 0, maskType = 0;
    int AboveRefFrame0 = 0, LeftRefFrame0 = 0, AboveRefFrame1 = -1, LeftRefFrame1 = -1;
    uint16_t ndvc[143];
    int YMode = 0, UVMode = 0, AngleDeltaY = 0, AngleDeltaUV = 0, CflAlphaU = 0, CflAlphaV = 0;
    int PaletteSizeY = 0, PaletteSizeUV = 0, use_filter_intra = 0, filter_intra_mode = 0;
    int TxSize = 0, MaxLumaW = 0, MaxLumaH = 0, PlaneTxType = 0;
    uint16_t paletteColors[3][8];
    uint8_t colorMapY[128][128], colorMapUV[128][128];
    int32_t quant[1024];

    size_t mi(int r, int c) const { return (size_t)r * miStride + c; }

    // ================================================================ headers
    void color_config(Bits& b) {
        int high = b.f(1);
        if (profile == 2 && high) bitDepth = b.f(1) ? 12 : 10;
        else bitDepth = high ? 10 : 8;
        mono = profile == 1 ? 0 : b.f(1);
        numPlanes = mono ? 1 : 3;
        if (b.f(1)) { cp = b.f(8); tc = b.f(8); mc = b.f(8); }
        else { cp = 2; tc = 2; mc = 2; }
        if (mono) { colorRange = b.f(1); ssx = 1; ssy = 1; csp = 0; sepUvDelta = 0; return; }
        if (cp == 1 && tc == 13 && mc == 0) { colorRange = 1; ssx = 0; ssy = 0; }
        else {
            colorRange = b.f(1);
            if (profile == 0) { ssx = 1; ssy = 1; }
            else if (profile == 1) { ssx = 0; ssy = 0; }
            else if (bitDepth == 12) { ssx = b.f(1); ssy = ssx ? b.f(1) : 0; }
            else { ssx = 1; ssy = 0; }
            if (ssx && ssy) csp = b.f(2);
        }
        sepUvDelta = b.f(1);
    }

    void sequence_header(Bits& b) {
        profile = b.f(3);
        if (profile > 2) throw (int)ERR_BITSTREAM;
        stillPicture = b.f(1); reducedStill = b.f(1);
        if (reducedStill) { timingInfo = 0; decoderModelInfo = 0; opCount = 1; opIdc[0] = 0; level0 = b.f(5); }
        else {
            timingInfo = b.f(1);
            if (timingInfo) {
                b.f(32); b.f(32);
                equalPictureInterval = b.f(1);
                if (equalPictureInterval) b.uvlc();
                decoderModelInfo = b.f(1);
                if (decoderModelInfo) {
                    bufferRemovalTimeLen = 0;
                    int bufferDelayLen = b.f(5) + 1;
                    b.f(32);
                    bufferRemovalTimeLen = b.f(5) + 1;
                    framePresentationTimeLen = b.f(5) + 1;
                    decoderModelInfo = bufferDelayLen;  // keep the length, non-zero
                }
            } else decoderModelInfo = 0;
            int initialDisplayDelay = b.f(1);
            opCount = b.f(5) + 1;
            for (int i = 0; i < opCount; i++) {
                opIdc[i] = b.f(12);
                int level = b.f(5), tier = level > 7 ? b.f(1) : 0;
                if (i == 0) { level0 = level; tier0 = tier; }
                if (decoderModelInfo) {
                    opDecoderModel[i] = b.f(1);
                    if (opDecoderModel[i]) { b.f(decoderModelInfo); b.f(decoderModelInfo); b.f(1); }
                } else opDecoderModel[i] = 0;
                if (initialDisplayDelay && b.f(1)) b.f(4);
            }
        }
        frameWidthBits = b.f(4) + 1; frameHeightBits = b.f(4) + 1;
        maxW = b.f(frameWidthBits) + 1; maxH = b.f(frameHeightBits) + 1;
        frameIdPresent = reducedStill ? 0 : b.f(1);
        if (frameIdPresent) { int d = b.f(4) + 2; int a = b.f(3) + 1; idLen = a + d; deltaFrameIdLen = d; }
        sb128 = b.f(1); enFilterIntra = b.f(1); enIntraEdge = b.f(1);
        if (reducedStill) { forceSct = 2; forceIntMv = 2; enOrderHint = 0; orderHintBits = 0; }
        else {
            enInterintra = b.f(1); enMaskedCompound = b.f(1); enWarped = b.f(1); enDualFilter = b.f(1);
            enOrderHint = b.f(1);
            if (enOrderHint) { enJntComp = b.f(1); enRefFrameMvs = b.f(1); }
            forceSct = b.f(1) ? 2 : b.f(1);
            if (forceSct > 0) forceIntMv = b.f(1) ? 2 : b.f(1);
            else forceIntMv = 2;
            orderHintBits = enOrderHint ? b.f(3) + 1 : 0;
        }
        enSuperres = b.f(1); enCdef = b.f(1); enRestoration = b.f(1);
        color_config(b);
        filmGrainPresent = b.f(1);
        seqSeen = 1;
    }

    static int tile_log2(int blk, int target) { int k = 0; while ((blk << k) < target) k++; return k; }

    void tile_info(Bits& b) {
        int sbCols = sb128 ? (MiCols + 31) >> 5 : (MiCols + 15) >> 4;
        int sbRows = sb128 ? (MiRows + 31) >> 5 : (MiRows + 15) >> 4;
        int sbShift = sb128 ? 5 : 4, sbSize = sbShift + 2;
        int maxTileWidthSb = 4096 >> sbSize;
        int maxTileAreaSb = (4096 * 2304) >> (2 * sbSize);
        int minLog2TileCols = tile_log2(maxTileWidthSb, sbCols);
        int maxLog2TileCols = tile_log2(1, std::min(sbCols, 64));
        int maxLog2TileRows = tile_log2(1, std::min(sbRows, 64));
        int minLog2Tiles = std::max(minLog2TileCols, tile_log2(maxTileAreaSb, sbRows * sbCols));
        if (b.f(1)) {
            tileColsLog2 = minLog2TileCols;
            while (tileColsLog2 < maxLog2TileCols && b.f(1)) tileColsLog2++;
            int tileWidthSb = (sbCols + (1 << tileColsLog2) - 1) >> tileColsLog2;
            int i = 0;
            for (int s = 0; s < sbCols; s += tileWidthSb) miColStarts[i++] = s << sbShift;
            miColStarts[i] = MiCols; tileCols = i;
            int minLog2TileRows = std::max(minLog2Tiles - tileColsLog2, 0);
            tileRowsLog2 = minLog2TileRows;
            while (tileRowsLog2 < maxLog2TileRows && b.f(1)) tileRowsLog2++;
            int tileHeightSb = (sbRows + (1 << tileRowsLog2) - 1) >> tileRowsLog2;
            i = 0;
            for (int s = 0; s < sbRows; s += tileHeightSb) miRowStarts[i++] = s << sbShift;
            miRowStarts[i] = MiRows; tileRows = i;
        } else {
            int widest = 0, s = 0, i = 0;
            for (; s < sbCols; i++) {
                if (i >= 64) throw (int)ERR_BITSTREAM;
                miColStarts[i] = s << sbShift;
                int maxWidth = std::min(sbCols - s, maxTileWidthSb);
                int size = (int)b.ns(maxWidth) + 1;
                widest = std::max(size, widest);
                s += size;
            }
            miColStarts[i] = MiCols; tileCols = i; tileColsLog2 = tile_log2(1, tileCols);
            int maxArea = minLog2Tiles > 0 ? (sbRows * sbCols) >> (minLog2Tiles + 1) : sbRows * sbCols;
            int maxHeight = std::max(maxArea / widest, 1);
            s = 0; i = 0;
            for (; s < sbRows; i++) {
                if (i >= 64) throw (int)ERR_BITSTREAM;
                miRowStarts[i] = s << sbShift;
                int mh = std::min(sbRows - s, maxHeight);
                s += (int)b.ns(mh) + 1;
            }
            miRowStarts[i] = MiRows; tileRows = i; tileRowsLog2 = tile_log2(1, tileRows);
        }
        contextUpdateTileId = 0;
        if (tileColsLog2 > 0 || tileRowsLog2 > 0) {
            contextUpdateTileId = b.f(tileRowsLog2 + tileColsLog2);
            tileSizeBytes = b.f(2) + 1;
        }
    }

    int read_delta_q(Bits& b) { return b.f(1) ? b.su(7) : 0; }

    int get_qidx(int ignoreDeltaQ, int seg) const {
        if (segEnabled && featEn[seg][0]) {
            int q = baseQ + featData[seg][0];
            if (!ignoreDeltaQ && deltaQPresent) q = currentQIndex + featData[seg][0];
            return clip3(0, 255, q);
        }
        if (!ignoreDeltaQ && deltaQPresent) return currentQIndex;
        return baseQ;
    }

    [[noreturn]] void refuse(int tool) { refusedTool = tool; throw (int)ERR_TOOL; }

    int relative_dist(int a, int b) const {
        if (!enOrderHint) return 0;
        int diff = a - b, m = 1 << (orderHintBits - 1);
        return (diff & (m - 1)) - (diff & m);
    }

    // frame_size, superres_params and compute_image_size (5.9.5-5.9.9)
    void frame_size(Bits& b, int overrideSize) {
        if (overrideSize) { FrameWidth = b.f(frameWidthBits) + 1; FrameHeight = b.f(frameHeightBits) + 1; }
        else { FrameWidth = maxW; FrameHeight = maxH; }
        superres_params(b);
    }
    void superres_params(Bits& b) {
        // the frame is coded SuperresDenom / 8 narrower and upscaled after
        // CDEF (7.16)
        int useSuperres = enSuperres ? b.f(1) : 0;
        SuperresDenom = useSuperres ? b.f(3) + 9 : 8;
        UpscaledWidth = FrameWidth;
        if (useSuperres)   // at least 16 wide (or as wide as the image), as libaom
            FrameWidth = std::max((UpscaledWidth * 8 + SuperresDenom / 2) / SuperresDenom,
                                  std::min(16, UpscaledWidth));
        MiCols = 2 * ((FrameWidth + 7) >> 3); MiRows = 2 * ((FrameHeight + 7) >> 3);
    }
    void render_size(Bits& b) {
        RenderWidth = UpscaledWidth; RenderHeight = FrameHeight;
        if (b.f(1)) { RenderWidth = b.f(16) + 1; RenderHeight = b.f(16) + 1; }
    }

    void frame_header(Bits& b, int temporalId, int spatialId) {
        showExistingFrame = 0;
        if (reducedStill) { frameType = KEY_FRAME; showFrame = 1; showableFrame = 0; }
        else {
            if (b.f(1)) {
                // show_existing_frame: a saved frame shown again, with its
                // film grain (load_grain_params); libaom fails on a slot
                // that holds no showable frame
                frameToShow = b.f(3);
                if (decoderModelInfo && !equalPictureInterval) b.f(framePresentationTimeLen);
                if (frameIdPresent) b.f(idLen);
                const RefSlot& r = refs[frameToShow];
                if (!r.valid || !r.showable) throw (int)ERR_BITSTREAM;
                showExistingFrame = 1; showFrame = 1; frameType = r.frameType;
                return;
            }
            frameType = b.f(2); showFrame = b.f(1);
            if (frameType == SWITCH_FRAME) census[C_SWITCH_FRAME]++;
            if (showFrame && decoderModelInfo && !equalPictureInterval) b.f(framePresentationTimeLen);
            showableFrame = showFrame ? frameType != KEY_FRAME : b.f(1);
            errorResilient = (frameType == SWITCH_FRAME || (frameType == KEY_FRAME && showFrame)) ? 1 : b.f(1);
        }
        frameIsIntra = frameType == KEY_FRAME || frameType == INTRA_ONLY_FRAME;
        if (frameType == KEY_FRAME && showFrame) {
            for (int i = 0; i < 8; i++) { refs[i].valid = false; refs[i].orderHint = 0; }
            for (int i = 0; i < 8; i++) orderHints[i] = 0;
        }
        disableCdfUpdate = b.f(1);
        allowSct = forceSct == 2 ? b.f(1) : forceSct;
        forceIntegerMv = allowSct ? (forceIntMv == 2 ? (int)b.f(1) : forceIntMv) : 0;
        if (frameIsIntra) forceIntegerMv = 1;
        if (frameIdPresent) b.f(idLen);
        int overrideSize = frameType == SWITCH_FRAME ? 1 : reducedStill ? 0 : b.f(1);
        orderHint = b.f(orderHintBits);
        primaryRefFrame = (frameIsIntra || errorResilient) ? 7 : b.f(3);
        if (!reducedStill && decoderModelInfo) {
            if (b.f(1)) {
                for (int op = 0; op < opCount; op++) {
                    if (!opDecoderModel[op]) continue;
                    int idc = opIdc[op];
                    int inT = (idc >> temporalId) & 1, inS = (idc >> (spatialId + 8)) & 1;
                    if (idc == 0 || (inT && inS)) b.f(bufferRemovalTimeLen);
                }
            }
        }
        allowHp = 0; useRefFrameMvs = 0; allowIntrabc = 0;
        refreshFlags = (frameType == SWITCH_FRAME || (frameType == KEY_FRAME && showFrame)) ? 0xFF : b.f(8);
        if (frameType == INTRA_ONLY_FRAME && refreshFlags == 0xFF) throw (int)ERR_BITSTREAM;
        if ((!frameIsIntra || refreshFlags != 0xFF) && errorResilient && enOrderHint)
            for (int i = 0; i < 8; i++) {
                int hint = b.f(orderHintBits);
                if (hint != refs[i].orderHint || !refs[i].valid) refs[i].valid = false;
            }
        if (frameIsIntra) {
            frame_size(b, overrideSize);
            render_size(b);
            if (allowSct && UpscaledWidth == FrameWidth) allowIntrabc = b.f(1);
        } else {
            census[C_INTER_FRAMES]++;
            if (spatialId > 0) census[C_SPATIAL_LAYERS]++;
            if (enOrderHint && b.f(1)) refuse(TOOL_FRAME_REFS_SHORT);
            for (int i = 0; i < 7; i++) {
                refFrameIdx[i] = b.f(3);
                if (frameIdPresent) b.f(deltaFrameIdLen);   // delta_frame_id_minus_1
                if (!refs[refFrameIdx[i]].valid) throw (int)ERR_BITSTREAM;
            }
            if (overrideSize && !errorResilient) {
                int found = 0;
                for (int i = 0; i < 7 && !found; i++) {
                    if (b.f(1)) {
                        const RefSlot& r = refs[refFrameIdx[i]];
                        UpscaledWidth = r.upscaledWidth; FrameWidth = UpscaledWidth; FrameHeight = r.frameHeight;
                        RenderWidth = r.renderWidth; RenderHeight = r.renderHeight;
                        found = 1;
                    }
                }
                if (!found) { frame_size(b, overrideSize); render_size(b); }
                else superres_params(b);
            } else { frame_size(b, overrideSize); render_size(b); }
            // libaom: every reference of this frame's format, at most twice its
            // size and at least a sixteenth of it
            for (int i = 0; i < 7; i++) {
                const RefSlot& r = refs[refFrameIdx[i]];
                if (r.bitDepth != bitDepth || r.ssx != ssx || r.ssy != ssy || r.mono != mono)
                    throw (int)ERR_BITSTREAM;
                if (2 * FrameWidth < r.upscaledWidth || 2 * FrameHeight < r.frameHeight ||
                    FrameWidth > 16 * r.upscaledWidth || FrameHeight > 16 * r.frameHeight)
                    throw (int)ERR_BITSTREAM;
            }
            allowHp = forceIntegerMv ? 0 : b.f(1);
            if (allowHp) census[C_HP_MV]++;
            interpFilter = b.f(1) ? SWITCHABLE : b.f(2);
            if (interpFilter == SWITCHABLE) census[C_SWITCHABLE]++;
            motionSwitchable = b.f(1);
            useRefFrameMvs = (errorResilient || !enRefFrameMvs) ? 0 : b.f(1);
            for (int i = 0; i < 7; i++) {
                int hint = refs[refFrameIdx[i]].orderHint;
                orderHints[LAST_FRAME + i] = hint;
                refFrameSignBias[LAST_FRAME + i] = enOrderHint ? relative_dist(hint, orderHint) > 0 : 0;
            }
        }
        disableFrameEndUpdateCdf = (reducedStill || disableCdfUpdate) ? 1 : b.f(1);
        // init_non_coeff_cdfs / setup_past_independence, or load_cdfs /
        // load_previous from the primary reference frame
        lfRefDeltas[0] = 1; lfRefDeltas[1] = 0; lfRefDeltas[2] = 0; lfRefDeltas[3] = 0;
        lfRefDeltas[4] = -1; lfRefDeltas[5] = 0; lfRefDeltas[6] = -1; lfRefDeltas[7] = -1;
        lfModeDeltas[0] = lfModeDeltas[1] = 0;
        memset(featEn, 0, sizeof(featEn)); memset(featData, 0, sizeof(featData));
        for (int r = 0; r < 8; r++) for (int i = 0; i < 6; i++) prevGm[r][i] = i % 3 == 2 ? 1 << 16 : 0;
        prevSegIds.clear();
        if (primaryRefFrame != 7) {
            // load_previous: the loop filter deltas, segmentation features,
            // global motion and segment ids of the primary reference
            const RefSlot& r = refs[refFrameIdx[primaryRefFrame]];
            memcpy(lfRefDeltas, r.lfRefDeltas, sizeof(lfRefDeltas));
            memcpy(lfModeDeltas, r.lfModeDeltas, sizeof(lfModeDeltas));
            memcpy(featEn, r.featEn, sizeof(featEn)); memcpy(featData, r.featData, sizeof(featData));
            memcpy(prevGm, r.gm, sizeof(prevGm));
            if (r.miRows == MiRows && r.miCols == MiCols) prevSegIds = r.segIds;
            census[C_PRIMARY_REF]++;
        }
        tile_info(b);
        // quantization_params
        baseQ = b.f(8);
        dqYDc = read_delta_q(b);
        dqUDc = dqUAc = dqVDc = dqVAc = 0;
        if (numPlanes > 1) {
            int diffUv = sepUvDelta ? b.f(1) : 0;
            dqUDc = read_delta_q(b); dqUAc = read_delta_q(b);
            if (diffUv) { dqVDc = read_delta_q(b); dqVAc = read_delta_q(b); }
            else { dqVDc = dqUDc; dqVAc = dqUAc; }
        }
        usingQm = b.f(1);
        if (usingQm) { qmY = b.f(4); qmU = b.f(4); qmV = sepUvDelta ? b.f(4) : qmU; }
        // segmentation_params
        segEnabled = b.f(1);
        segUpdateMap = segTemporalUpdate = 0;
        if (!segEnabled) { memset(featEn, 0, sizeof(featEn)); memset(featData, 0, sizeof(featData)); }
        else {
            int updateData = 1;
            if (primaryRefFrame == 7) segUpdateMap = 1;
            else {
                segUpdateMap = b.f(1);
                if (segUpdateMap) segTemporalUpdate = b.f(1);
                updateData = b.f(1);
            }
            if (!frameIsIntra) {
                census[C_INTER_SEG]++;
                census[C_SEG_UPDATE_MAP] += segUpdateMap; census[C_SEG_TEMPORAL] += segTemporalUpdate;
                census[C_SEG_FROM_REF] += !updateData;
            }
            if (updateData) {
                memset(featEn, 0, sizeof(featEn)); memset(featData, 0, sizeof(featData));
                for (int i = 0; i < 8; i++) for (int j = 0; j < 8; j++) {
                    if (b.f(1)) {
                        featEn[i][j] = 1;
                        int bits = kSegFeatureBits[j], lim = kSegFeatureMax[j];
                        if (kSegFeatureSigned[j]) featData[i][j] = clip3(-lim, lim, b.su(1 + bits));
                        else featData[i][j] = clip3(0, lim, (int)b.f(bits));
                    }
                }
            }
        }
        segIdPreSkip = 0; lastActiveSegId = 0;
        for (int i = 0; i < 8; i++) for (int j = 0; j < 8; j++)
            if (featEn[i][j]) { lastActiveSegId = i; if (j >= 5) segIdPreSkip = 1; }
        // delta_q_params, delta_lf_params
        deltaQRes = 0; deltaQPresent = 0;
        if (baseQ > 0) deltaQPresent = b.f(1);
        if (deltaQPresent) deltaQRes = b.f(2);
        deltaLfPresent = 0; deltaLfRes = 0; deltaLfMulti = 0;
        if (deltaQPresent) {
            if (!allowIntrabc) deltaLfPresent = b.f(1);
            if (deltaLfPresent) { deltaLfRes = b.f(2); deltaLfMulti = b.f(1); }
        }
        if (primaryRefFrame == 7) frameCdf.init(baseQ);
        else frameCdf = refs[refFrameIdx[primaryRefFrame]].cdf;
        codedLossless = 1;
        for (int s = 0; s < 8; s++) {
            int q = get_qidx(1, s);
            losslessArr[s] = q == 0 && dqYDc == 0 && dqUAc == 0 && dqUDc == 0 && dqVAc == 0 && dqVDc == 0;
            if (!losslessArr[s]) codedLossless = 0;
            if (usingQm) {
                if (losslessArr[s]) { segQmLevel[0][s] = segQmLevel[1][s] = segQmLevel[2][s] = 15; }
                else { segQmLevel[0][s] = qmY; segQmLevel[1][s] = qmU; segQmLevel[2][s] = qmV; }
            }
        }
        allLossless = codedLossless;
        // loop_filter_params
        lfDeltaEnabled = 1;
        if (codedLossless || allowIntrabc) {
            lfLevel[0] = lfLevel[1] = lfLevel[2] = lfLevel[3] = 0;
            lfRefDeltas[0] = 1; lfRefDeltas[1] = 0; lfRefDeltas[2] = 0; lfRefDeltas[3] = 0;
            lfRefDeltas[4] = -1; lfRefDeltas[5] = 0; lfRefDeltas[6] = -1; lfRefDeltas[7] = -1;
            lfModeDeltas[0] = lfModeDeltas[1] = 0;
        } else {
            lfLevel[0] = b.f(6); lfLevel[1] = b.f(6);
            lfLevel[2] = lfLevel[3] = 0;
            if (numPlanes > 1 && (lfLevel[0] || lfLevel[1])) { lfLevel[2] = b.f(6); lfLevel[3] = b.f(6); }
            lfSharp = b.f(3);
            lfDeltaEnabled = b.f(1);
            if (lfDeltaEnabled && b.f(1)) {
                if (!frameIsIntra) refuse(TOOL_LF_DELTAS);   // no libaom setting writes one
                for (int i = 0; i < 8; i++) if (b.f(1)) lfRefDeltas[i] = b.su(7);
                for (int i = 0; i < 2; i++) if (b.f(1)) lfModeDeltas[i] = b.su(7);
            }
        }
        // cdef_params
        cdefBits = 0; cdefDamping = 3;
        memset(cdefYPri, 0, sizeof(cdefYPri)); memset(cdefYSec, 0, sizeof(cdefYSec));
        memset(cdefUvPri, 0, sizeof(cdefUvPri)); memset(cdefUvSec, 0, sizeof(cdefUvSec));
        if (!(codedLossless || allowIntrabc || !enCdef)) {
            cdefDamping = b.f(2) + 3; cdefBits = b.f(2);
            for (int i = 0; i < (1 << cdefBits); i++) {
                cdefYPri[i] = b.f(4); cdefYSec[i] = b.f(2); if (cdefYSec[i] == 3) cdefYSec[i]++;
                if (numPlanes > 1) { cdefUvPri[i] = b.f(4); cdefUvSec[i] = b.f(2); if (cdefUvSec[i] == 3) cdefUvSec[i]++; }
            }
        }
        // lr_params
        usesLr = 0; frameRestType[0] = frameRestType[1] = frameRestType[2] = RESTORE_NONE;
        if (!(allLossless || allowIntrabc || !enRestoration)) {
            static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
            int usesChroma = 0;
            for (int i = 0; i < numPlanes; i++) {
                frameRestType[i] = remap[b.f(2)];
                if (frameRestType[i] != RESTORE_NONE) { usesLr = 1; if (i > 0) usesChroma = 1; }
            }
            if (usesLr) {
                int shift;
                if (sb128) shift = b.f(1) + 1;
                else { shift = b.f(1); if (shift) shift += b.f(1); }
                lrSize[0] = 256 >> (2 - shift);
                int uvShift = (ssx && ssy && usesChroma) ? b.f(1) : 0;
                lrSize[1] = lrSize[2] = lrSize[0] >> uvShift;
            }
        }
        // read_tx_mode, frame_reference_mode, skip_mode_params, warped motion
        txModeSelect = codedLossless ? 0 : b.f(1);
        referenceSelect = frameIsIntra ? 0 : b.f(1);
        skip_mode_params(b);
        allowWarped = (frameIsIntra || errorResilient || !enWarped) ? 0 : b.f(1);
        reducedTxSet = b.f(1);
        global_motion_params(b);
        if (useRefFrameMvs) { census[C_REF_FRAME_MVS]++; motion_field(); }
        if (filmGrainPresent && (showFrame || showableFrame)) film_grain_params(b);
        else grain = FilmGrain();
        headerDone = 1;
    }

    // skip_mode_params (5.9.22): the nearest forward and backward
    // references, or the two nearest forward ones
    void skip_mode_params(Bits& b) {
        skipModePresent = 0;
        if (frameIsIntra || !referenceSelect || !enOrderHint) return;
        int fwd = -1, bwd = -1, fwdHint = 0, bwdHint = 0;
        for (int i = 0; i < 7; i++) {
            int h = refs[refFrameIdx[i]].orderHint;
            if (relative_dist(h, orderHint) < 0) {
                if (fwd < 0 || relative_dist(h, fwdHint) > 0) { fwd = i; fwdHint = h; }
            } else if (relative_dist(h, orderHint) > 0) {
                if (bwd < 0 || relative_dist(h, bwdHint) < 0) { bwd = i; bwdHint = h; }
            }
        }
        int other = bwd;
        if (fwd < 0) return;
        if (bwd < 0) {
            int fwd2Hint = 0;
            for (int i = 0; i < 7; i++) {
                int h = refs[refFrameIdx[i]].orderHint;
                if (relative_dist(h, fwdHint) < 0 && (other < 0 || relative_dist(h, fwd2Hint) > 0)) { other = i; fwd2Hint = h; }
            }
            if (other < 0) return;
        }
        SkipModeFrame[0] = LAST_FRAME + std::min(fwd, other);
        SkipModeFrame[1] = LAST_FRAME + std::max(fwd, other);
        skipModePresent = b.f(1);
    }

    // global_motion_params (5.9.24-5.9.25): each reference's model coded
    // against PrevGmParams (the primary reference's, or the defaults), and
    // whether libaom's av1_get_shear_params lets it warp
    int prevGm[8][6];
    void read_global_param(Bits& b, int type, int ref, int idx) {
        int absBits = 12, precBits = 15;
        if (idx < 2) {
            if (type == TRANSLATION) { absBits = 9 - !allowHp; precBits = 3 - !allowHp; }
            else { absBits = 12; precBits = 6; }
        }
        int precDiff = 16 - precBits, round = idx % 3 == 2 ? 1 << 16 : 0, sub = idx % 3 == 2 ? 1 << precBits : 0;
        int mx = 1 << absBits, r = (prevGm[ref][idx] >> precDiff) - sub;
        gmParams[ref][idx] = signed_subexp_with_ref(b, -mx, mx + 1, 3, r) * (1 << precDiff) + round;
    }
    void global_motion_params(Bits& b) {
        for (int r = 0; r < 8; r++) {
            gmType[r] = IDENTITY; gmValid[r] = 1;
            for (int i = 0; i < 6; i++) gmParams[r][i] = i % 3 == 2 ? 1 << 16 : 0;
            for (int i = 0; i < 4; i++) gmShear[r][i] = 0;
        }
        if (frameIsIntra) return;
        for (int r = LAST_FRAME; r <= ALTREF_FRAME; r++) {
            int type = IDENTITY;
            if (b.f(1)) type = b.f(1) ? ROTZOOM : b.f(1) ? TRANSLATION : AFFINE;
            gmType[r] = type;
            if (type >= ROTZOOM) {
                read_global_param(b, type, r, 2); read_global_param(b, type, r, 3);
                if (type == AFFINE) { read_global_param(b, type, r, 4); read_global_param(b, type, r, 5); }
                else { gmParams[r][4] = -gmParams[r][3]; gmParams[r][5] = gmParams[r][2]; }
            }
            if (type >= TRANSLATION) { read_global_param(b, type, r, 0); read_global_param(b, type, r, 1); }
            if (type) census[C_GM_TRANSLATION + type - 1]++;
            int64_t m[6];
            for (int i = 0; i < 6; i++) m[i] = gmParams[r][i];
            gmValid[r] = shear_params(m, gmShear[r]);
            if (!gmValid[r]) census[C_GM_INVALID]++;
        }
    }

    // ---- the motion field (7.9) as libaom's av1_setup_motion_field keeps
    // it: per 8x8, a backward motion vector of a reference projected onto
    // this frame, with that vector's own frame distance
    std::vector<int16_t> tplMv;
    std::vector<int8_t> tplOff;
    std::vector<uint8_t> tplValid;
    int tplStride = 0;

    static void mv_projection(int* out, const int* mv, int num, int den) {
        den = std::min(den, 31);
        num = num > 0 ? std::min(num, 31) : std::max(num, -31);
        for (int i = 0; i < 2; i++) {
            int v = mv[i] * num * k_div_mult[den];
            v = v >= 0 ? (v + (1 << 13)) >> 14 : -((-v + (1 << 13)) >> 14);
            out[i] = clip3(-(1 << 14) + 1, (1 << 14) - 1, v);
        }
    }

    int project(int src, int dir) {
        const RefSlot& r = refs[refFrameIdx[src - LAST_FRAME]];
        if (r.frameType == KEY_FRAME || r.frameType == INTRA_ONLY_FRAME) return 0;
        if (r.miRows != MiRows || r.miCols != MiCols) return 0;
        int startToCur = relative_dist(r.orderHint, orderHint), refOffset[8] = {0};
        for (int rf = LAST_FRAME; rf <= ALTREF_FRAME; rf++) refOffset[rf] = relative_dist(r.orderHint, r.savedOrderHints[rf]);
        if (dir == 2) startToCur = -startToCur;
        int rows = (MiRows + 1) >> 1, cols = (MiCols + 1) >> 1;
        for (int br = 0; br < rows; br++)
            for (int bc = 0; bc < cols; bc++) {
                size_t k = (size_t)br * cols + bc;
                int ref = r.mfRef[k];
                if (ref <= INTRA_FRAME) continue;
                int off = refOffset[ref];
                if (std::abs(off) > 31 || off <= 0 || std::abs(startToCur) > 31) continue;
                int fwd[2] = {r.mfMv[2 * k], r.mfMv[2 * k + 1]}, mv[2];
                mv_projection(mv, fwd, startToCur, off);
                int ro = mv[0] >= 0 ? mv[0] >> 6 : -((-mv[0]) >> 6);
                int co = mv[1] >= 0 ? mv[1] >> 6 : -((-mv[1]) >> 6);
                int row = dir == 2 ? br - ro : br + ro, col = dir == 2 ? bc - co : bc + co;
                int baseR = (br >> 3) << 3, baseC = (bc >> 3) << 3;
                if (row < 0 || row >= (MiRows >> 1) || col < 0 || col >= (MiCols >> 1)) continue;
                if (row < baseR || row >= baseR + 8 || col < baseC - 8 || col >= baseC + 16) continue;
                size_t t = (size_t)row * tplStride + col;
                tplMv[2 * t] = (int16_t)fwd[0]; tplMv[2 * t + 1] = (int16_t)fwd[1];
                tplOff[t] = (int8_t)off; tplValid[t] = 1;
            }
        return 1;
    }

    void motion_field() {
        tplStride = (MiCols >> 1) + 1;
        size_t n = (size_t)((MiRows >> 1) + 1) * tplStride;
        tplMv.assign(2 * n, 0); tplOff.assign(n, 0); tplValid.assign(n, 0);
        int refStamp = 2;
        if (refs[refFrameIdx[0]].savedOrderHints[ALTREF_FRAME] != orderHints[GOLDEN_FRAME]) project(LAST_FRAME, 2);
        refStamp--;
        if (relative_dist(orderHints[BWDREF_FRAME], orderHint) > 0 && project(BWDREF_FRAME, 0)) refStamp--;
        if (relative_dist(orderHints[ALTREF2_FRAME], orderHint) > 0 && project(ALTREF2_FRAME, 0)) refStamp--;
        if (relative_dist(orderHints[ALTREF_FRAME], orderHint) > 0 && refStamp >= 0 && project(ALTREF_FRAME, 0)) refStamp--;
        if (refStamp >= 0) project(2, 2);   // LAST2_FRAME
    }

    // film_grain_params (5.9.30) of an intra frame (update_grain = 1), with
    // the checks libaom makes (av1_read_film_grain_params)
    void film_grain_params(Bits& b) {
        FilmGrain& g = grain;
        g = FilmGrain();
        g.apply = b.f(1);
        if (!g.apply) return;
        g.seed = b.f(16);
        if (frameType == INTER_FRAME && !b.f(1)) {   // update_grain = 0: a reference's, with this seed
            int seed = g.seed, idx = b.f(3), found = 0;
            for (int i = 0; i < 7; i++) found |= refFrameIdx[i] == idx;
            if (!found) throw (int)ERR_BITSTREAM;   // as libaom
            g = refs[idx].grain;
            g.seed = seed;
            census[C_GRAIN_FROM_REF]++;
            return;
        }
        auto points = [&](int n, int (*pt)[2]) {
            for (int i = 0; i < n; i++) {
                pt[i][0] = b.f(8); pt[i][1] = b.f(8);
                if (i && pt[i][0] <= pt[i - 1][0]) throw (int)ERR_BITSTREAM;
            }
        };
        g.numY = b.f(4);
        if (g.numY > 14) throw (int)ERR_BITSTREAM;
        points(g.numY, g.pointY);
        g.chromaFromLuma = mono ? 0 : b.f(1);
        if (!(mono || g.chromaFromLuma || (ssx == 1 && ssy == 1 && g.numY == 0))) {
            g.numCb = b.f(4);
            if (g.numCb > 10) throw (int)ERR_BITSTREAM;
            points(g.numCb, g.pointCb);
            g.numCr = b.f(4);
            if (g.numCr > 10) throw (int)ERR_BITSTREAM;
            points(g.numCr, g.pointCr);
            if (ssx == 1 && ssy == 1 && ((g.numCb == 0) != (g.numCr == 0))) throw (int)ERR_BITSTREAM;
        }
        g.scalingMinus8 = b.f(2);
        g.arLag = b.f(2);
        int numPosLuma = 2 * g.arLag * (g.arLag + 1), numPosChroma = numPosLuma;
        if (g.numY) {
            numPosChroma = numPosLuma + 1;
            for (int i = 0; i < numPosLuma; i++) g.arY[i] = (int)b.f(8) - 128;
        }
        if (g.chromaFromLuma || g.numCb)
            for (int i = 0; i < numPosChroma; i++) g.arCb[i] = (int)b.f(8) - 128;
        if (g.chromaFromLuma || g.numCr)
            for (int i = 0; i < numPosChroma; i++) g.arCr[i] = (int)b.f(8) - 128;
        g.arShiftMinus6 = b.f(2);
        g.scaleShift = b.f(2);
        if (g.numCb) { g.cbMult = b.f(8); g.cbLumaMult = b.f(8); g.cbOffset = b.f(9); }
        if (g.numCr) { g.crMult = b.f(8); g.crLumaMult = b.f(8); g.crOffset = b.f(9); }
        g.overlap = b.f(1);
        g.clipRestricted = b.f(1);
    }

    // ================================================================ frame state
    void alloc() {
        int sbMi = sb128 ? 32 : 16;
        int rows = (MiRows + sbMi - 1) / sbMi * sbMi + 32, cols = (MiCols + sbMi - 1) / sbMi * sbMi + 32;
        miStride = cols; miAllocRows = rows;
        size_t n = (size_t)rows * cols;
        miSize.assign(n, 0); yMode.assign(n, 0); uvMode.assign(n, 0); skip.assign(n, 0);
        isInter.assign(n, 0); segId.assign(n, 0); txSizeMi.assign(n, 0); palSize0.assign(n, 0);
        palSize1.assign(n, 0); lossMi.assign(n, 0); written.assign(n, 0); mvRow.assign(n, 0); mvCol.assign(n, 0); deltaLFs.assign(n * 4, 0); palColors.assign(n * 16, 0);
        mvRow1.assign(n, 0); mvCol1.assign(n, 0); skipModeMi.assign(n, 0); compGroupIdxMi.assign(n, 0);
        compoundIdxMi.assign(n, 1); segPredMi.assign(n, 0);
        txTypes.assign(n, 0); refFrame0.assign(n, 0); refFrame1.assign(n, -1); filt0.assign(n, 0); filt1.assign(n, 0);
        for (int p = 0; p < 3; p++) lfTx[p].assign(n, 0);
        cdefStride = cols / 16 + 2;
        cdefIdx.assign((size_t)(rows / 16 + 2) * cdefStride, -1);
        for (int p = 0; p < numPlanes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            Plane& f = frame[p];
            f.w = ((cols * 4) >> sx) + 80; f.h = ((rows * 4) >> sy) + 80; f.stride = f.w;
            f.px.assign((size_t)f.w * f.h, 0);
            aboveLevel[p].assign(f.w / 4 + 32, 0); aboveDc[p].assign(f.w / 4 + 32, 0);
            leftLevel[p].assign(f.h / 4 + 32, 0); leftDc[p].assign(f.h / 4 + 32, 0);
        }
        for (int p = 0; p < numPlanes; p++) {
            lrUnitRows[p] = lrUnitCols[p] = 0;
            if (frameRestType[p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int unitSize = lrSize[p];
            lrUnitRows[p] = count_units(unitSize, round2(FrameHeight, sy));
            lrUnitCols[p] = count_units(unitSize, round2(UpscaledWidth, sx));
            size_t units = (size_t)lrUnitRows[p] * lrUnitCols[p];
            lrType[p].assign(units, 0); lrWiener[p].assign(units * 6, 0); lrSgr[p].assign(units * 3, 0);
        }
    }
    static int count_units(int unitSize, int frameSize) { return std::max((frameSize + (unitSize >> 1)) / unitSize, 1); }

    int is_inside(int r, int c) const { return c >= MiColStart && c < MiColEnd && r >= MiRowStart && r < MiRowEnd; }

    // ================================================================ tiles
    void decode_tile() {
        for (int p = 0; p < numPlanes; p++) {
            std::fill(aboveLevel[p].begin(), aboveLevel[p].end(), 0);
            std::fill(aboveDc[p].begin(), aboveDc[p].end(), 0);
        }
        for (int i = 0; i < 4; i++) deltaLF[i] = 0;
        for (int p = 0; p < numPlanes; p++) {
            refSgrXqd[p][0] = kSgrprojXqdMid[0]; refSgrXqd[p][1] = kSgrprojXqdMid[1];
            for (int pass = 0; pass < 2; pass++) for (int i = 0; i < 3; i++) refLrWiener[p][pass][i] = kWienerTapsMid[i];
        }
        int sbSize = sb128 ? BLOCK_128X128 : BLOCK_64X64, sbSize4 = kNum4x4W[sbSize];
        for (int r = MiRowStart; r < MiRowEnd; r += sbSize4) {
            for (int p = 0; p < numPlanes; p++) {
                std::fill(leftLevel[p].begin(), leftLevel[p].end(), 0);
                std::fill(leftDc[p].begin(), leftDc[p].end(), 0);
            }
            for (int c = MiColStart; c < MiColEnd; c += sbSize4) {
                readDeltas = deltaQPresent;
                // clear_cdef
                cdefIdx[(size_t)(r >> 4) * cdefStride + (c >> 4)] = -1;
                if (sb128) {
                    cdefIdx[(size_t)(r >> 4) * cdefStride + (c >> 4) + 1] = -1;
                    cdefIdx[(size_t)((r >> 4) + 1) * cdefStride + (c >> 4)] = -1;
                    cdefIdx[(size_t)((r >> 4) + 1) * cdefStride + (c >> 4) + 1] = -1;
                }
                clear_block_decoded_flags(r, c, sbSize4);
                read_lr(r, c, sbSize);
                decode_partition(r, c, sbSize);
                if (sd.overflowed()) throw (int)ERR_BITSTREAM;
            }
        }
        if (!sd.trailing_ok()) throw (int)ERR_BITSTREAM;
    }

    void clear_block_decoded_flags(int r, int c, int sbSize4) {
        for (int p = 0; p < numPlanes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int sbW4 = (MiColEnd - c) >> sx, sbH4 = (MiRowEnd - r) >> sy;
            for (int y = -1; y <= (sbSize4 >> sy); y++)
                for (int x = -1; x <= (sbSize4 >> sx); x++) {
                    uint8_t v;
                    if (y < 0 && x < sbW4) v = 1;
                    else if (x < 0 && y < sbH4) v = 1;
                    else v = 0;
                    blockDecoded[p][y + 1][x + 1] = v;
                }
            blockDecoded[p][(sbSize4 >> sy) + 1][0] = 0;
        }
    }

    // ---- loop restoration coefficients (5.11.57)
    void read_lr(int r, int c, int bSize) {
        if (allowIntrabc) return;
        int w = kNum4x4W[bSize], h = kNum4x4H[bSize];
        for (int p = 0; p < numPlanes; p++) {
            if (frameRestType[p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int unitSize = lrSize[p];
            int unitRows = lrUnitRows[p], unitCols = lrUnitCols[p];
            int rs = (r * (4 >> sy) + unitSize - 1) / unitSize;
            int re = std::min(unitRows, ((r + h) * (4 >> sy) + unitSize - 1) / unitSize);
            // units are counted in the upscaled width
            int scaled = UpscaledWidth != FrameWidth;
            int num = (4 >> sx) * (scaled ? SuperresDenom : 8), den = unitSize * 8;
            int cs = (c * num + den - 1) / den;
            int ce = std::min(unitCols, ((c + w) * num + den - 1) / den);
            for (int ur = rs; ur < re; ur++) for (int uc = cs; uc < ce; uc++) read_lr_unit(p, ur, uc);
        }
    }

    static int inverse_recenter(int r, int v) {
        if (v > 2 * r) return v;
        if (v & 1) return r - ((v + 1) >> 1);
        return r + (v >> 1);
    }
    // decode_signed_subexp_with_ref (5.11.58 on symbols, 5.9.26-5.9.28 on
    // header bits: either reader's ns and literal)
    template <typename R> static int signed_subexp_with_ref(R& rd, int low, int high, int k, int r) {
        int mx = high - low, i = 0, mk = 0, v;
        r -= low;
        while (true) {
            int b2 = i ? k + i - 1 : k, a = 1 << b2;
            if (mx <= mk + 3 * a) { v = (int)rd.ns(mx - mk) + mk; break; }
            if (rd.literal(1)) { i++; mk += a; }
            else { v = (int)rd.literal(b2) + mk; break; }
        }
        int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
        return x + low;
    }

    void read_lr_unit(int p, int ur, int uc) {
        int type = RESTORE_NONE;
        if (frameRestType[p] == RESTORE_WIENER) type = sd.symbol(cdf.wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
        else if (frameRestType[p] == RESTORE_SGRPROJ) type = sd.symbol(cdf.sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
        else type = sd.symbol(cdf.switchable_restore, 3);  // 0 none, 1 wiener, 2 sgrproj
        size_t u = (size_t)ur * lrUnitCols[p] + uc;
        lrType[p][u] = (uint8_t)type;
        if (type == RESTORE_WIENER) {
            census[C_LR_WIENER]++;
            for (int pass = 0; pass < 2; pass++) {
                int first = 0;
                if (p) { first = 1; lrWiener[p][u * 6 + pass * 3] = 0; }
                for (int j = first; j < 3; j++) {
                    int v = signed_subexp_with_ref(sd, kWienerTapsMin[j], kWienerTapsMax[j] + 1, kWienerTapsK[j], refLrWiener[p][pass][j]);
                    lrWiener[p][u * 6 + pass * 3 + j] = (int16_t)v;
                    refLrWiener[p][pass][j] = v;
                }
            }
        } else if (type == RESTORE_SGRPROJ) {
            census[C_LR_SGRPROJ]++;
            int set = sd.literal(4);
            lrSgr[p][u * 3] = (int16_t)set;
            for (int i = 0; i < 2; i++) {
                int radius = k_sgr_params[set][i];
                int v;
                if (radius) v = signed_subexp_with_ref(sd, kSgrprojXqdMin[i], kSgrprojXqdMax[i] + 1, 4, refSgrXqd[p][i]);
                else { v = 0; if (i == 1) v = clip3(kSgrprojXqdMin[i], kSgrprojXqdMax[i], (1 << 7) - refSgrXqd[p][0]); }
                lrSgr[p][u * 3 + 1 + i] = (int16_t)v;
                refSgrXqd[p][i] = v;
            }
        }
    }

    // ---- partitions (5.11.4)
    void decode_partition(int r, int c, int bSize) {
        if (r >= MiRows || c >= MiCols) return;
        int availU = is_inside(r - 1, c), availL = is_inside(r, c - 1);
        int num4x4 = kNum4x4W[bSize], half = num4x4 >> 1, quarter = half >> 1;
        int hasRows = (r + half) < MiRows, hasCols = (c + half) < MiCols;
        int partition;
        if (bSize < BLOCK_8X8) partition = PARTITION_NONE;
        else {
            int bsl = kMiWLog2[bSize];
            int above = availU && kMiWLog2[miSize[mi(r - 1, c)]] < bsl;
            int left = availL && kMiHLog2[miSize[mi(r, c - 1)]] < bsl;
            int ctx = left * 2 + above;
            int grp = bsl - 1;
            uint16_t* pc = cdf.partition[grp * 4 + ctx];
            int N = bSize == BLOCK_8X8 ? 4 : bSize == BLOCK_128X128 ? 8 : 10;
            auto prob = [&](int e) { return (e > 0 ? pc[e - 1] : 32768) - pc[e]; };
            if (hasRows && hasCols) partition = sd.symbol(pc, N);
            else if (hasCols) {
                // split_or_horz: the vertical-alike probabilities
                int s2 = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                         prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B);
                if (bSize != BLOCK_128X128) s2 += prob(PARTITION_VERT_4);
                uint16_t c2[3] = {(uint16_t)s2, 0, 0};
                partition = sd.decode(c2, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
            } else if (hasRows) {
                // split_or_vert: the horizontal-alike probabilities
                int s2 = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                         prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A);
                if (bSize != BLOCK_128X128) s2 += prob(PARTITION_HORZ_4);
                uint16_t c2[3] = {(uint16_t)s2, 0, 0};
                partition = sd.decode(c2, 2) ? PARTITION_SPLIT : PARTITION_VERT;
            } else partition = PARTITION_SPLIT;
        }
        census[C_PARTITION + partition]++;
        int w4 = kNum4x4W[bSize], h4 = kNum4x4H[bSize];
        int subSize, splitSize = block_from_wh(w4 / 2, h4 / 2);
        switch (partition) {
            case PARTITION_NONE: subSize = bSize; break;
            case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B: subSize = block_from_wh(w4, h4 / 2); break;
            case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B: subSize = block_from_wh(w4 / 2, h4); break;
            case PARTITION_SPLIT: subSize = splitSize; break;
            case PARTITION_HORZ_4: subSize = block_from_wh(w4, h4 / 4); break;
            default: subSize = block_from_wh(w4 / 4, h4); break;
        }
        if (subSize == BLOCK_INVALID) throw (int)ERR_BITSTREAM;
        switch (partition) {
            case PARTITION_NONE: decode_block(r, c, subSize); break;
            case PARTITION_HORZ:
                decode_block(r, c, subSize);
                if (hasRows) decode_block(r + half, c, subSize);
                break;
            case PARTITION_VERT:
                decode_block(r, c, subSize);
                if (hasCols) decode_block(r, c + half, subSize);
                break;
            case PARTITION_SPLIT:
                decode_partition(r, c, subSize); decode_partition(r, c + half, subSize);
                decode_partition(r + half, c, subSize); decode_partition(r + half, c + half, subSize);
                break;
            case PARTITION_HORZ_A:
                decode_block(r, c, splitSize); decode_block(r, c + half, splitSize);
                decode_block(r + half, c, subSize);
                break;
            case PARTITION_HORZ_B:
                decode_block(r, c, subSize); decode_block(r + half, c, splitSize);
                decode_block(r + half, c + half, splitSize);
                break;
            case PARTITION_VERT_A:
                decode_block(r, c, splitSize); decode_block(r + half, c, splitSize);
                decode_block(r, c + half, subSize);
                break;
            case PARTITION_VERT_B:
                decode_block(r, c, subSize); decode_block(r, c + half, splitSize);
                decode_block(r + half, c + half, splitSize);
                break;
            case PARTITION_HORZ_4:
                for (int i = 0; i < 4; i++) {
                    if (i > 0 && r + quarter * i >= MiRows) break;
                    decode_block(r + quarter * i, c, subSize);
                }
                break;
            case PARTITION_VERT_4:
                for (int i = 0; i < 4; i++) {
                    if (i > 0 && c + quarter * i >= MiCols) break;
                    decode_block(r, c + quarter * i, subSize);
                }
                break;
        }
    }

    // ---- blocks (5.11.5)
    int plane_residual_size(int bsize, int plane) const {
        if (!plane) return bsize;
        return k_ss_size_lookup[bsize][ssx][ssy];
    }

    void decode_block(int r, int c, int subSize) {
        MiRow = r; MiCol = c; MiSize = subSize;
        bw4 = kNum4x4W[subSize]; bh4 = kNum4x4H[subSize];
        if (bh4 == 1 && ssy && (MiRow & 1) == 0) HasChroma = 0;
        else if (bw4 == 1 && ssx && (MiCol & 1) == 0) HasChroma = 0;
        else HasChroma = numPlanes > 1;
        AvailU = is_inside(r - 1, c); AvailL = is_inside(r, c - 1);
        AvailUChroma = AvailU; AvailLChroma = AvailL;
        if (HasChroma) {
            if (ssy && bh4 == 1) AvailUChroma = is_inside(r - 2, c);
            if (ssx && bw4 == 1) AvailLChroma = is_inside(r, c - 2);
        } else AvailUChroma = AvailLChroma = 0;
        if (frameIsIntra) intra_frame_mode_info();
        else inter_frame_mode_info();
        palette_tokens();
        read_block_tx_size();
        if (Skip) reset_block_context();
        if (use_intrabc) census[C_INTRABC]++;
        if (!frameIsIntra) {
            census[is_inter ? C_INTER_BLOCKS : C_INTRA_IN_INTER]++;
            if (is_inter && Skip) census[C_INTER_SKIP]++;
        }
        for (int y = 0; y < bh4; y++) for (int x = 0; x < bw4; x++) {
            size_t m = mi(r + y, c + x);
            yMode[m] = (uint8_t)YMode; uvMode[m] = (uint8_t)UVMode;
            isInter[m] = (uint8_t)is_inter; skip[m] = (uint8_t)Skip; written[m] = 1;
            refFrame0[m] = (int8_t)RefFrame0; filt0[m] = (uint8_t)interpF[0]; filt1[m] = (uint8_t)interpF[1];
            refFrame1[m] = (int8_t)(RefFrame1 > INTRA_FRAME ? RefFrame1 : interintra ? INTRA_FRAME : NONE_FRAME);
            mvRow[m] = (int16_t)Mv[0]; mvCol[m] = (int16_t)Mv[1]; mvRow1[m] = (int16_t)Mv1[0]; mvCol1[m] = (int16_t)Mv1[1];
            skipModeMi[m] = (uint8_t)skipMode; compGroupIdxMi[m] = (uint8_t)compGroupIdx;
            compoundIdxMi[m] = (uint8_t)compoundIdx; segPredMi[m] = (uint8_t)segIdPredicted;
            miSize[m] = (uint8_t)MiSize; segId[m] = (uint8_t)segment_id;
            palSize0[m] = (uint8_t)PaletteSizeY; palSize1[m] = (uint8_t)PaletteSizeUV;
            lossMi[m] = (uint8_t)Lossless;
            for (int i = 0; i < 8; i++) {
                palColors[m * 16 + i] = paletteColors[0][i];
                palColors[m * 16 + 8 + i] = paletteColors[1][i];
            }
            for (int i = 0; i < 4; i++) deltaLFs[m * 4 + i] = (int8_t)deltaLF[i];
        }
        if (!is_inter || use_intrabc) {
            census[C_YMODE + YMode]++;
            if (HasChroma) census[C_UVMODE + UVMode]++;
        } else {
            if (YMode < NEAREST_NEARESTMV) census[C_NEARESTMV + YMode - NEARESTMV]++;
            if (interpF[0] < BILINEAR) census[C_FILTER + interpF[0]]++;
        }
        if (Lossless) census[C_LOSSLESS]++;
        if (use_intrabc) predict_intrabc();
        else if (is_inter) predict_inter_block();
        residual();
    }

    void intra_segment_id() {
        if (segEnabled) read_segment_id();
        else segment_id = 0;
        Lossless = losslessArr[segment_id];
    }

    void read_segment_id() {
        int prevUL = -1, prevU = -1, prevL = -1;
        if (AvailU && AvailL) prevUL = segId[mi(MiRow - 1, MiCol - 1)];
        if (AvailU) prevU = segId[mi(MiRow - 1, MiCol)];
        if (AvailL) prevL = segId[mi(MiRow, MiCol - 1)];
        int ctx;
        if (prevUL < 0) ctx = 0;
        else if (prevUL == prevU && prevUL == prevL) ctx = 2;
        else if (prevUL == prevU || prevUL == prevL || prevU == prevL) ctx = 1;
        else ctx = 0;
        int pred;
        if (prevU == -1) pred = prevL == -1 ? 0 : prevL;
        else if (prevL == -1) pred = prevU;
        else pred = prevUL == prevU ? prevU : prevL;
        if (Skip) { segment_id = pred; return; }
        int coded = sd.symbol(cdf.seg[ctx], 8);
        int max = lastActiveSegId + 1, v;
        if (!pred) v = coded;
        else if (pred >= max - 1) v = max - coded - 1;
        else if (2 * pred < max) {
            if (coded <= 2 * pred) v = (coded & 1) ? pred + ((coded + 1) >> 1) : pred - (coded >> 1);
            else v = coded;
        } else {
            if (coded <= 2 * (max - pred - 1)) v = (coded & 1) ? pred + ((coded + 1) >> 1) : pred - (coded >> 1);
            else v = max - (coded + 1);
        }
        if (v < 0 || v > lastActiveSegId) throw (int)ERR_BITSTREAM;
        segment_id = v;
        census[C_SEGMENT_IDS]++;
    }

    void intra_frame_mode_info() {
        Skip = 0;
        if (segIdPreSkip) intra_segment_id();
        // read_skip
        if (segIdPreSkip && segEnabled && featEn[segment_id][6]) Skip = 1;
        else {
            int ctx = 0;
            if (AvailU) ctx += skip[mi(MiRow - 1, MiCol)];
            if (AvailL) ctx += skip[mi(MiRow, MiCol - 1)];
            Skip = sd.symbol(cdf.skip[ctx], 2);
        }
        if (!segIdPreSkip) intra_segment_id();
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        readDeltas = 0;
        use_intrabc = 0; Mv[0] = Mv[1] = 0; Mv1[0] = Mv1[1] = 0; skipMode = 0; segIdPredicted = 0;
        is_inter = 0; RefFrame0 = INTRA_FRAME; RefFrame1 = NONE_FRAME; interpF[0] = interpF[1] = 0; interintra = 0;
        compGroupIdx = 0; compoundIdx = 1; compoundType = COMPOUND_AVERAGE;
        PaletteSizeY = PaletteSizeUV = 0; use_filter_intra = 0;
        memset(paletteColors, 0, sizeof(paletteColors));
        if (allowIntrabc) {
            use_intrabc = sd.symbol(cdf.intrabc, 2);
            if (use_intrabc) {
                is_inter = 1; interpF[0] = interpF[1] = BILINEAR;
                YMode = DC_PRED; UVMode = DC_PRED; AngleDeltaY = AngleDeltaUV = 0;
                CflAlphaU = CflAlphaV = 0;
                read_intrabc_mv();
                return;
            }
        }
        // intra_frame_y_mode
        int aboveMode = AvailU ? yMode[mi(MiRow - 1, MiCol)] : DC_PRED;
        int leftMode = AvailL ? yMode[mi(MiRow, MiCol - 1)] : DC_PRED;
        YMode = sd.symbol(cdf.kf_y_mode[kIntraModeContext[aboveMode]][kIntraModeContext[leftMode]], 13);
        intra_modes_after_y();
    }

    // intra_angle_info_y onwards: the chroma mode, CfL, palette and filter
    // intra of an intra block (in any frame)
    void intra_modes_after_y() {
        AngleDeltaY = 0;
        if (MiSize >= BLOCK_8X8 && is_directional(YMode)) {
            AngleDeltaY = sd.symbol(cdf.angle_delta[YMode - V_PRED], 7) - 3;
        }
        UVMode = DC_PRED; AngleDeltaUV = 0; CflAlphaU = CflAlphaV = 0;
        if (HasChroma) {
            int cflAllowed;
            if (Lossless && plane_residual_size(MiSize, 1) == BLOCK_4X4) cflAllowed = 1;
            else if (!Lossless && std::max(bw4, bh4) * 4 <= 32) cflAllowed = 1;
            else cflAllowed = 0;
            UVMode = sd.symbol(cdf.uv_mode[cflAllowed][YMode], 13 + cflAllowed);
            if (UVMode == UV_CFL_PRED) read_cfl_alphas();
            if (MiSize >= BLOCK_8X8 && is_directional(UVMode)) {
                AngleDeltaUV = sd.symbol(cdf.angle_delta[UVMode - V_PRED], 7) - 3;
            }
        }
        PaletteSizeY = PaletteSizeUV = 0;
        memset(paletteColors, 0, sizeof(paletteColors));
        if (MiSize >= BLOCK_8X8 && bw4 * 4 <= 64 && bh4 * 4 <= 64 && allowSct) palette_mode_info();
        // filter_intra_mode_info
        use_filter_intra = 0;
        if (enFilterIntra && YMode == DC_PRED && PaletteSizeY == 0 && std::max(bw4, bh4) * 4 <= 32) {
            use_filter_intra = sd.symbol(cdf.filter_intra[MiSize], 2);
            if (use_filter_intra) { filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5); census[C_FILTER_INTRA]++; }
        }
    }

    void read_cfl_alphas() {
        int signs = sd.symbol(cdf.cfl_sign, 8);
        int signU = (signs + 1) / 3, signV = (signs + 1) % 3;
        if (signU) {
            int ctx = (signU - 1) * 3 + signV;
            CflAlphaU = 1 + sd.symbol(cdf.cfl_alpha[ctx], 16);
            if (signU == 1) CflAlphaU = -CflAlphaU;
        } else CflAlphaU = 0;
        if (signV) {
            int ctx = (signV - 1) * 3 + signU;
            CflAlphaV = 1 + sd.symbol(cdf.cfl_alpha[ctx], 16);
            if (signV == 1) CflAlphaV = -CflAlphaV;
        } else CflAlphaV = 0;
    }

    void read_cdef() {
        if (Skip || codedLossless || !enCdef || allowIntrabc) return;
        int r = MiRow & ~15, c = MiCol & ~15;
        int8_t& idx = cdefIdx[(size_t)(r >> 4) * cdefStride + (c >> 4)];
        if (idx == -1) {
            idx = (int8_t)sd.literal(cdefBits);
            int w4 = bw4, h4 = bh4;
            for (int y = r; y < r + h4; y += 16)
                for (int x = c; x < c + w4; x += 16)
                    cdefIdx[(size_t)(y >> 4) * cdefStride + (x >> 4)] = idx;
        }
    }

    void read_delta_qindex() {
        int sbSize = sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (MiSize == sbSize && Skip) return;
        if (readDeltas) {
            int abs = sd.symbol(cdf.delta_q, 4);
            if (abs == 3) { int rem = sd.literal(3) + 1; abs = sd.literal(rem) + (1 << rem) + 1; }
            if (abs) {
                int sign = sd.literal(1);
                int reduced = sign ? -abs : abs;
                currentQIndex = clip3(1, 255, currentQIndex + (reduced << deltaQRes));
            }
        }
    }

    void read_delta_lf() {
        int sbSize = sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (MiSize == sbSize && Skip) return;
        if (readDeltas && deltaLfPresent) {
            int count = 1;
            if (deltaLfMulti) count = numPlanes > 1 ? 4 : 2;
            for (int i = 0; i < count; i++) {
                uint16_t* c = deltaLfMulti ? cdf.delta_lf_multi[i] : cdf.delta_lf;
                int abs = sd.symbol(c, 4);
                if (abs == 3) { int n = sd.literal(3) + 1; abs = sd.literal(n) + (1 << n) + 1; }
                if (abs) {
                    int sign = sd.literal(1);
                    int reduced = sign ? -abs : abs;
                    deltaLF[i] = clip3(-63, 63, deltaLF[i] + (reduced << deltaLfRes));
                }
            }
        }
    }

    // ---- palette (5.11.46)
    int get_palette_cache(int plane, uint16_t* cache) {
        int aboveN = 0, leftN = 0;
        if (((MiRow * 4) % 64) && AvailU) aboveN = plane ? palSize1[mi(MiRow - 1, MiCol)] : palSize0[mi(MiRow - 1, MiCol)];
        if (AvailL) leftN = plane ? palSize1[mi(MiRow, MiCol - 1)] : palSize0[mi(MiRow, MiCol - 1)];
        const uint16_t* ac = aboveN ? &palColors[mi(MiRow - 1, MiCol) * 16 + plane * 8] : nullptr;
        const uint16_t* lc = leftN ? &palColors[mi(MiRow, MiCol - 1) * 16 + plane * 8] : nullptr;
        int ai = 0, li = 0, n = 0;
        while (ai < aboveN && li < leftN) {
            int aboveC = ac[ai], leftC = lc[li];
            if (leftC < aboveC) { if (n == 0 || leftC != cache[n - 1]) cache[n++] = (uint16_t)leftC; li++; }
            else {
                if (n == 0 || aboveC != cache[n - 1]) cache[n++] = (uint16_t)aboveC;
                ai++;
                if (leftC == aboveC) li++;
            }
        }
        while (ai < aboveN) { int v = ac[ai++]; if (n == 0 || v != cache[n - 1]) cache[n++] = (uint16_t)v; }
        while (li < leftN) { int v = lc[li++]; if (n == 0 || v != cache[n - 1]) cache[n++] = (uint16_t)v; }
        return n;
    }

    void read_palette_colors(int plane, int size, uint16_t* colors, int deltaPlus1) {
        uint16_t cache[16];
        int cacheN = get_palette_cache(plane, cache);
        int idx = 0;
        for (int i = 0; i < cacheN && idx < size; i++) if (sd.literal(1)) colors[idx++] = cache[i];
        if (idx < size) { colors[idx++] = (uint16_t)sd.literal(bitDepth); }
        int paletteBits = 0;
        if (idx < size) { int minBits = bitDepth - 3; paletteBits = minBits + sd.literal(2); }
        while (idx < size) {
            int delta = sd.literal(paletteBits);
            if (deltaPlus1) delta++;
            colors[idx] = (uint16_t)clip3(0, (1 << bitDepth) - 1, colors[idx - 1] + delta);
            int range = (1 << bitDepth) - colors[idx] - deltaPlus1;
            paletteBits = std::min(paletteBits, ceil_log2(range));
            idx++;
        }
        std::sort(colors, colors + size);
    }

    void palette_mode_info() {
        int bsizeCtx = kMiWLog2[MiSize] + kMiHLog2[MiSize] - 2;
        if (YMode == DC_PRED) {
            int ctx = (AvailU && palSize0[mi(MiRow - 1, MiCol)] > 0) + (AvailL && palSize0[mi(MiRow, MiCol - 1)] > 0);
            if (sd.symbol(cdf.pal_y_mode[bsizeCtx][ctx], 2)) {
                PaletteSizeY = sd.symbol(cdf.pal_y_size[bsizeCtx], 7) + 2;
                read_palette_colors(0, PaletteSizeY, paletteColors[0], 1);
                census[C_PALETTE_Y]++;
            }
        }
        if (HasChroma && UVMode == DC_PRED) {
            int ctx = PaletteSizeY > 0;
            if (sd.symbol(cdf.pal_uv_mode[ctx], 2)) {
                PaletteSizeUV = sd.symbol(cdf.pal_uv_size[bsizeCtx], 7) + 2;
                read_palette_colors(1, PaletteSizeUV, paletteColors[1], 0);
                if (sd.literal(1)) {
                    int minBits = bitDepth - 4, maxVal = 1 << bitDepth;
                    int bits = minBits + sd.literal(2);
                    paletteColors[2][0] = (uint16_t)sd.literal(bitDepth);
                    for (int idx = 1; idx < PaletteSizeUV; idx++) {
                        int delta = sd.literal(bits);
                        if (delta && sd.literal(1)) delta = -delta;
                        int val = paletteColors[2][idx - 1] + delta;
                        if (val < 0) val += maxVal;
                        if (val >= maxVal) val -= maxVal;
                        paletteColors[2][idx] = (uint16_t)clip3(0, (1 << bitDepth) - 1, val);
                    }
                } else {
                    for (int idx = 0; idx < PaletteSizeUV; idx++) paletteColors[2][idx] = (uint16_t)sd.literal(bitDepth);
                }
                census[C_PALETTE_UV]++;
            }
        }
    }

    int palette_color_context(uint8_t (*map)[128], int r, int c, int n, int* order) {
        int scores[8] = {0};
        for (int i = 0; i < 8; i++) order[i] = i;
        if (c > 0) scores[map[r][c - 1]] += 2;
        if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
        if (r > 0) scores[map[r - 1][c]] += 2;
        for (int i = 0; i < 3; i++) {
            int maxScore = scores[i], maxIdx = i;
            for (int j = i + 1; j < n; j++) if (scores[j] > maxScore) { maxScore = scores[j]; maxIdx = j; }
            if (maxIdx != i) {
                maxScore = scores[maxIdx]; int maxOrder = order[maxIdx];
                for (int k = maxIdx; k > i; k--) { scores[k] = scores[k - 1]; order[k] = order[k - 1]; }
                scores[i] = maxScore; order[i] = maxOrder;
            }
        }
        int hash = scores[0] * 1 + scores[1] * 2 + scores[2] * 2;
        return k_palette_color_context[hash];
    }

    void read_color_map(uint8_t (*map)[128], int n, uint16_t (*cdfs)[9], int blockW, int blockH, int onW, int onH) {
        map[0][0] = (uint8_t)sd.ns(n);
        int order[8];
        for (int i = 1; i < onH + onW - 1; i++)
            for (int j = std::min(i, onW - 1); j >= std::max(0, i - onH + 1); j--) {
                int ctx = palette_color_context(map, i - j, j, n, order);
                int idx = sd.symbol(cdfs[ctx], n);
                map[i - j][j] = (uint8_t)order[idx];
            }
        for (int i = 0; i < onH; i++) for (int j = onW; j < blockW; j++) map[i][j] = map[i][onW - 1];
        for (int i = onH; i < blockH; i++) for (int j = 0; j < blockW; j++) map[i][j] = map[onH - 1][j];
    }

    void palette_tokens() {
        int blockH = bh4 * 4, blockW = bw4 * 4;
        int onH = std::min(blockH, (MiRows - MiRow) * 4), onW = std::min(blockW, (MiCols - MiCol) * 4);
        if (PaletteSizeY) read_color_map(colorMapY, PaletteSizeY, cdf.pal_y_color[PaletteSizeY - 2], blockW, blockH, onW, onH);
        if (PaletteSizeUV) {
            blockH >>= ssy; blockW >>= ssx; onH >>= ssy; onW >>= ssx;
            if (blockW < 4) { blockW += 2; onW += 2; }
            if (blockH < 4) { blockH += 2; onH += 2; }
            read_color_map(colorMapUV, PaletteSizeUV, cdf.pal_uv_color[PaletteSizeUV - 2], blockW, blockH, onW, onH);
        }
    }

    // ---- transform size (5.11.15-17)
    int above_tx_width(int row, int col) const {
        if (row == MiRow) {
            if (!AvailU) return 64;
            size_t m = mi(row - 1, col);
            if (skip[m] && isInter[m]) return kNum4x4W[miSize[m]] * 4;
        }
        return kTxW[txSizeMi[mi(row - 1, col)]];
    }
    int left_tx_height(int row, int col) const {
        if (col == MiCol) {
            if (!AvailL) return 64;
            size_t m = mi(row, col - 1);
            if (skip[m] && isInter[m]) return kNum4x4H[miSize[m]] * 4;
        }
        return kTxH[txSizeMi[mi(row, col - 1)]];
    }

    // InterTxSizes live in txSizeMi
    void read_block_tx_size() {
        if (txModeSelect && MiSize > BLOCK_4X4 && is_inter && !Skip && !Lossless) {
            int maxTx = kMaxTxRect[MiSize];
            int txW4 = kTxW[maxTx] / 4, txH4 = kTxH[maxTx] / 4;
            for (int row = MiRow; row < MiRow + bh4; row += txH4)
                for (int col = MiCol; col < MiCol + bw4; col += txW4) read_var_tx_size(row, col, maxTx, 0);
            return;
        }
        read_tx_size(!Skip || !is_inter);
        for (int y = 0; y < bh4; y++) for (int x = 0; x < bw4; x++) txSizeMi[mi(MiRow + y, MiCol + x)] = (uint8_t)TxSize;
    }

    void read_var_tx_size(int row, int col, int txSz, int depth) {
        if (row >= MiRows || col >= MiCols) return;
        int split;
        if (txSz == TX_4X4 || depth == 2) split = 0;
        else {
            int above = above_tx_width(row, col) < kTxW[txSz];
            int left = left_tx_height(row, col) < kTxH[txSz];
            int size = std::min(64, std::max(bw4, bh4) * 4);
            int maxTxSz = tx_from_wh(size, size);
            int ctx = (tx_sqr_up(txSz) != maxTxSz) * 3 + (4 - maxTxSz) * 6 + above + left;
            split = sd.symbol(cdf.txfm_part[ctx], 2);
        }
        int w4 = kTxW[txSz] / 4, h4 = kTxH[txSz] / 4;
        if (split && !use_intrabc) census[C_VAR_TX]++;
        if (split) {
            int sub = kSplitTx[txSz], sw = kTxW[sub] / 4, sh = kTxH[sub] / 4;
            for (int i = 0; i < h4; i += sh) for (int j = 0; j < w4; j += sw) read_var_tx_size(row + i, col + j, sub, depth + 1);
        } else {
            for (int i = 0; i < h4; i++) for (int j = 0; j < w4; j++) txSizeMi[mi(row + i, col + j)] = (uint8_t)txSz;
            TxSize = txSz;
        }
    }

    void read_tx_size(int allowSelect) {
        if (Lossless) { TxSize = TX_4X4; return; }
        int maxRect = kMaxTxRect[MiSize];
        TxSize = maxRect;
        if (MiSize > BLOCK_4X4 && allowSelect && txModeSelect) {
            int depthTo4 = 0; for (int t = maxRect; t != TX_4X4; t = kSplitTx[t]) depthTo4++;
            int maxDepth = std::min(depthTo4, 2), cat = depthTo4 - 1;
            int maxW = kTxW[maxRect], maxH = kTxH[maxRect];
            int aboveW = 0, leftH = 0;
            if (AvailU) {
                size_t m = mi(MiRow - 1, MiCol);
                aboveW = isInter[m] ? kNum4x4W[miSize[m]] * 4 : above_tx_width(MiRow, MiCol);
            }
            if (AvailL) {
                size_t m = mi(MiRow, MiCol - 1);
                leftH = isInter[m] ? kNum4x4H[miSize[m]] * 4 : left_tx_height(MiRow, MiCol);
            }
            int ctx = (AvailU && aboveW >= maxW) + (AvailL && leftH >= maxH);
            int depth = sd.symbol(cdf.tx_size[cat][ctx], maxDepth + 1);
            for (int i = 0; i < depth; i++) TxSize = kSplitTx[TxSize];
        }
    }

    void reset_block_context() {
        for (int p = 0; p < 1 + 2 * HasChroma; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            for (int i = MiCol >> sx; i < ((MiCol + bw4 - 1) >> sx) + 1; i++) { aboveLevel[p][i] = 0; aboveDc[p][i] = 0; }
            for (int i = MiRow >> sy; i < ((MiRow + bh4 - 1) >> sy) + 1; i++) { leftLevel[p][i] = 0; leftDc[p][i] = 0; }
        }
    }

    // ---- residual (5.11.34)
    int get_tx_size(int plane, int txSz) const {
        if (!plane) return txSz;
        int uvTx = kMaxTxRect[plane_residual_size(MiSize, plane)];
        if (kTxW[uvTx] == 64 || kTxH[uvTx] == 64) {
            if (kTxW[uvTx] == 16) return TX_16X32;
            if (kTxH[uvTx] == 16) return TX_32X16;
            return TX_32X32;
        }
        return uvTx;
    }

    void residual() {
        int widthChunks = std::max(1, bw4 >> 4), heightChunks = std::max(1, bh4 >> 4);
        for (int cy = 0; cy < heightChunks; cy++)
            for (int cx = 0; cx < widthChunks; cx++) {
                int miRowChunk = MiRow + (cy << 4), miColChunk = MiCol + (cx << 4);
                for (int p = 0; p < 1 + HasChroma * 2; p++) {
                    int txSz = Lossless ? TX_4X4 : get_tx_size(p, TxSize);
                    int stepX = kTxW[txSz] >> 2, stepY = kTxH[txSz] >> 2;
                    int planeSz = plane_residual_size(MiSize, p);
                    int n4w = kNum4x4W[planeSz], n4h = kNum4x4H[planeSz];
                    int sx = p ? ssx : 0, sy = p ? ssy : 0;
                    int baseX = (MiCol >> sx) * 4, baseY = (MiRow >> sy) * 4;
                    if (is_inter && !Lossless && p == 0) {
                        // each 64x64 chunk as trees of the largest transform
                        transform_tree((miColChunk >> sx) * 4, (miRowChunk >> sy) * 4,
                                       std::min(64, n4w * 4), std::min(64, n4h * 4));
                        continue;
                    }
                    for (int y = 0; y < std::min(n4h, 16 >> sy); y += stepY)
                        for (int x = 0; x < std::min(n4w, 16 >> sx); x += stepX)
                            transform_block(p, baseX, baseY, txSz, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
                }
            }
    }

    void transform_tree(int startX, int startY, int w, int h) {
        if (startX >= MiCols * 4 || startY >= MiRows * 4) return;
        int txSz = txSizeMi[mi(startY >> 2, startX >> 2)];
        if (w <= kTxW[txSz] && h <= kTxH[txSz]) { transform_block(0, startX, startY, txSz, 0, 0); return; }
        if (w > h) { transform_tree(startX, startY, w / 2, h); transform_tree(startX + w / 2, startY, w / 2, h); }
        else if (w < h) { transform_tree(startX, startY, w, h / 2); transform_tree(startX, startY + h / 2, w, h / 2); }
        else {
            transform_tree(startX, startY, w / 2, h / 2); transform_tree(startX + w / 2, startY, w / 2, h / 2);
            transform_tree(startX, startY + h / 2, w / 2, h / 2); transform_tree(startX + w / 2, startY + h / 2, w / 2, h / 2);
        }
    }

    void transform_block(int plane, int baseX, int baseY, int txSz, int x, int y) {
        int startX = baseX + 4 * x, startY = baseY + 4 * y;
        int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        int row = (startY << sy) >> 2, col = (startX << sx) >> 2;
        int sbMask = sb128 ? 31 : 15;
        int sbRow = row & sbMask, sbCol = col & sbMask;
        int stepX = kTxW[txSz] >> 2, stepY = kTxH[txSz] >> 2;
        int maxX = (MiCols * 4) >> sx, maxY = (MiRows * 4) >> sy;
        if (startX >= maxX || startY >= maxY) return;
        if (is_inter) {}
        else if ((plane == 0 && PaletteSizeY) || (plane != 0 && PaletteSizeUV)) predict_palette(plane, startX, startY, x, y, txSz);
        else {
            int isCfl = plane > 0 && UVMode == UV_CFL_PRED;
            int mode = plane == 0 ? YMode : (isCfl ? DC_PRED : UVMode);
            int log2W = floor_log2(kTxW[txSz]), log2H = floor_log2(kTxH[txSz]);
            int haveLeft = (plane == 0 ? AvailL : AvailLChroma) || x > 0;
            int haveAbove = (plane == 0 ? AvailU : AvailUChroma) || y > 0;
            int haveAboveRt = blockDecoded[plane][(sbRow >> sy) - 1 + 1][(sbCol >> sx) + stepX + 1];
            int haveBelowLt = blockDecoded[plane][(sbRow >> sy) + stepY + 1][(sbCol >> sx) - 1 + 1];
            predict_intra(plane, startX, startY, haveLeft, haveAbove, haveAboveRt, haveBelowLt, mode, log2W, log2H);
            if (isCfl) predict_cfl(plane, startX, startY, txSz);
        }
        if (plane == 0) { MaxLumaW = startX + stepX * 4; MaxLumaH = startY + stepY * 4; }
        if (!Skip) {
            int eob = coeffs(startX, startY, plane, txSz);
            if (eob > 0) reconstruct(plane, startX, startY, txSz);
        }
        for (int i = 0; i < stepY; i++) for (int j = 0; j < stepX; j++) {
            lfTx[plane][mi((row >> sy) + i, (col >> sx) + j)] = (uint8_t)txSz;
            blockDecoded[plane][(sbRow >> sy) + i + 1][(sbCol >> sx) + j + 1] = 1;
        }
    }

    // ---- coefficients (5.11.39)
    // intra: 0 DCT only, 1 INTRA_1, 2 INTRA_2; intra block copy: 0, 3 INTER_1, 4 INTER_2, 5 INTER_3
    int get_tx_set(int txSz) const {
        int sq = tx_sqr(txSz), up = tx_sqr_up(txSz);
        if (up > TX_32X32) return 0;
        if (is_inter) {
            if (reducedTxSet || up == TX_32X32) return 5;
            if (sq == TX_16X16) return 4;
            return 3;
        }
        if (up == TX_32X32) return 0;
        if (reducedTxSet) return 2;
        if (sq == TX_16X16) return 2;
        return 1;
    }

    int compute_tx_type(int plane, int txSz, int blockX, int blockY) const {
        if (Lossless || tx_sqr_up(txSz) > TX_32X32) return DCT_DCT;
        int set = get_tx_set(txSz);
        if (plane == 0) return txTypes[mi(blockY, blockX)];
        static const uint8_t inSet[6][16] = {
            {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
            {1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0},
            {1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0},
            {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
            {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0},
            {1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0}};
        int t;
        if (is_inter) t = txTypes[mi(std::max(MiRow, blockY << ssy), std::max(MiCol, blockX << ssx))];
        else t = kModeToTxfm[UVMode];
        if (!inSet[set][t]) return DCT_DCT;
        return t;
    }

    int coeffs(int startX, int startY, int plane, int txSz) {
        int x4 = startX >> 2, y4 = startY >> 2, w4 = kTxW[txSz] >> 2, h4 = kTxH[txSz] >> 2;
        int txSzCtx = (tx_sqr(txSz) + tx_sqr_up(txSz) + 1) >> 1;
        int ptype = plane > 0;
        int segEob = (txSz == TX_16X64 || txSz == TX_64X16) ? 512 : std::min(1024, kTxW[txSz] * kTxH[txSz]);
        for (int i = 0; i < segEob; i++) quant[i] = 0;
        int eob = 0, culLevel = 0, dcCategory = 0;
        int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        int maxX4 = MiCols >> sx, maxY4 = MiRows >> sy;
        int w = kTxW[txSz], h = kTxH[txSz];
        int bsize = plane_residual_size(MiSize, plane);
        int ctx = txb_skip_ctx(plane, txSz, bsize, aboveLevel[plane].data(), aboveDc[plane].data(),
                               leftLevel[plane].data(), leftDc[plane].data(), x4, y4, maxX4, maxY4);
        int allZero = sd.symbol(cdf.txb_skip[txSzCtx][ctx], 2);
        if (allZero) {
            if (plane == 0)
                for (int i = 0; i < w4; i++) for (int j = 0; j < h4; j++) txTypes[mi(y4 + j, x4 + i)] = DCT_DCT;
        } else {
            if (plane == 0) transform_type(x4, y4, txSz);
            PlaneTxType = compute_tx_type(plane, txSz, x4, y4);
            census[C_TXTYPE + PlaneTxType]++;
            census[C_TXSIZE + txSz]++;
            const int16_t* scan = default_scan(txSz);
            // mrow / mcol scans for 1-D transforms
            int adj = adjusted_tx(txSz);
            int bwl = floor_log2(kTxW[adj]), txw = kTxW[adj], txh = kTxH[adj];
            int cls = tx_class(PlaneTxType);
            static thread_local int16_t lineScan[1024];
            if (PlaneTxType == V_DCT || PlaneTxType == V_ADST || PlaneTxType == V_FLIPADST) {
                for (int i = 0; i < txw * txh; i++) lineScan[i] = (int16_t)i;  // mrow: row by row
                scan = lineScan;
            } else if (PlaneTxType == H_DCT || PlaneTxType == H_ADST || PlaneTxType == H_FLIPADST) {
                for (int i = 0; i < txw * txh; i++) lineScan[i] = (int16_t)((i % txh) * txw + i / txh);  // mcol
                scan = lineScan;
            }
            int eobMultisize = std::min(floor_log2(w), 5) + std::min(floor_log2(h), 5) - 4;
            int ectx = cls == 0 ? 0 : 1;
            int eobPt;
            switch (eobMultisize) {
                case 0: eobPt = sd.symbol(cdf.eob16[ptype][ectx], 5); break;
                case 1: eobPt = sd.symbol(cdf.eob32[ptype][ectx], 6); break;
                case 2: eobPt = sd.symbol(cdf.eob64[ptype][ectx], 7); break;
                case 3: eobPt = sd.symbol(cdf.eob128[ptype][ectx], 8); break;
                case 4: eobPt = sd.symbol(cdf.eob256[ptype][ectx], 9); break;
                case 5: eobPt = sd.symbol(cdf.eob512[ptype][0], 10); break;
                default: eobPt = sd.symbol(cdf.eob1024[ptype][0], 11); break;
            }
            eobPt += 1;
            eob = eobPt < 2 ? eobPt : (1 << (eobPt - 2)) + 1;
            int eobShift = eobPt - 3;
            if (eobShift >= 0) {
                if (sd.symbol(cdf.eob_extra[txSzCtx][ptype][eobPt - 3], 2)) eob += 1 << eobShift;
                for (int i = 1; i < std::max(1, eobPt - 2); i++) {
                    eobShift = std::max(1, eobPt - 2) - 1 - i;
                    if (sd.literal(1)) eob += 1 << eobShift;
                }
            }
            for (int c = eob - 1; c >= 0; c--) {
                int pos = scan[c];
                int level;
                if (c == eob - 1) {
                    level = sd.symbol(cdf.base_eob[txSzCtx][ptype][coeff_base_eob_ctx(c, txw, txh)], 3) + 1;
                } else {
                    int cctx = coeff_base_ctx(quant, txSz, bwl, txh, pos, cls);
                    level = sd.symbol(cdf.base[txSzCtx][ptype][cctx], 4);
                }
                if (level > 2) {
                    int bctx = coeff_br_ctx(quant, bwl, txh, pos, cls);
                    for (int idx = 0; idx < 4; idx++) {
                        int br = sd.symbol(cdf.br[std::min(txSzCtx, 3)][ptype][bctx], 4);
                        level += br;
                        if (br < 3) break;
                    }
                }
                quant[pos] = level;
            }
            for (int c = 0; c < eob; c++) {
                int pos = scan[c];
                int sign = 0;
                if (quant[pos] != 0) {
                    if (c == 0) {
                        int dctx = dc_sign_ctx(txSz, aboveDc[plane].data(), leftDc[plane].data(), x4, y4, maxX4, maxY4);
                        sign = sd.symbol(cdf.dc_sign[ptype][dctx], 2);
                    } else sign = sd.literal(1);
                }
                if (quant[pos] > 14) {
                    int length = 0, bit;
                    do {
                        length++; bit = sd.literal(1);
                        if (length > 32) throw (int)ERR_BITSTREAM;
                    } while (!bit);
                    int xg = 1;
                    for (int i = length - 2; i >= 0; i--) xg = (xg << 1) | sd.literal(1);
                    quant[pos] = xg + 14;
                }
                if (pos == 0 && quant[pos] > 0) dcCategory = sign ? 1 : 2;
                quant[pos] &= 0xFFFFF;
                culLevel += quant[pos];
                if (sign) quant[pos] = -quant[pos];
            }
            culLevel = std::min(63, culLevel);
        }
        for (int i = 0; i < w4; i++) { aboveLevel[plane][x4 + i] = (uint8_t)culLevel; aboveDc[plane][x4 + i] = (uint8_t)dcCategory; }
        for (int i = 0; i < h4; i++) { leftLevel[plane][y4 + i] = (uint8_t)culLevel; leftDc[plane][y4 + i] = (uint8_t)dcCategory; }
        return eob;
    }

    void transform_type(int x4, int y4, int txSz) {
        int set = get_tx_set(txSz);
        int txType = DCT_DCT;
        if (set > 0 && (segEnabled ? get_qidx(1, segment_id) : baseQ) > 0) {
            int intraDir = use_filter_intra ? kFilterIntraDir[filter_intra_mode] : YMode;
            int sq = tx_sqr(txSz);
            if (set == 1) txType = k_ext_tx_inv[3][sd.symbol(cdf.intra_tx[1][sq][intraDir], 7)];
            else if (set == 2) txType = k_ext_tx_inv[2][sd.symbol(cdf.intra_tx[2][sq][intraDir], 5)];
            else if (set == 3) txType = k_ext_tx_inv[5][sd.symbol(cdf.inter_tx[1][sq], 16)];
            else if (set == 4) txType = k_ext_tx_inv[4][sd.symbol(cdf.inter_tx[2][sq], 12)];
            else txType = k_ext_tx_inv[1][sd.symbol(cdf.inter_tx[3][sq], 2)];
        }
        for (int i = 0; i < (kTxW[txSz] >> 2); i++)
            for (int j = 0; j < (kTxH[txSz] >> 2); j++) txTypes[mi(y4 + j, x4 + i)] = (uint8_t)txType;
    }

    // ---- reconstruction (7.12.3)
    int dc_q(int b) const { return av1::dc_q(bitDepth, b); }
    int ac_q(int b) const { return av1::ac_q(bitDepth, b); }

    void reconstruct(int plane, int x, int y, int txSz) {
        int log2W = floor_log2(kTxW[txSz]), log2H = floor_log2(kTxH[txSz]);
        int tw = std::min(32, 1 << log2W), th = std::min(32, 1 << log2H);
        int qidx = get_qidx(0, segment_id);
        int dcQ, acQ;
        if (plane == 0) { dcQ = dc_q(qidx + dqYDc); acQ = ac_q(qidx); }
        else if (plane == 1) { dcQ = dc_q(qidx + dqUDc); acQ = ac_q(qidx + dqUAc); }
        else { dcQ = dc_q(qidx + dqVDc); acQ = ac_q(qidx + dqVAc); }
        const uint8_t* qm = nullptr;
        int qmLevel = usingQm && !Lossless ? segQmLevel[plane][segment_id] : 15;
        if (qmLevel < 15 && PlaneTxType < IDTX) {
            int adj = tx_from_wh(tw, th);
            int off = 0;
            for (int t = 0; t < adj; t++) if (kTxW[t] != 64 && kTxH[t] != 64) off += kTxW[t] * kTxH[t];
            qm = &k_iwt_matrix[qmLevel][plane > 0][off];
            census[C_QMATRIX]++;
        }
        static thread_local int32_t coef[32 * 32];
        dequantize(quant, coef, tw, th, dcQ, acQ, dq_shift(txSz), qm, bitDepth);
        Plane& f = frame[plane];
        inverse_transform_add(coef, log2W, log2H, PlaneTxType, Lossless, kRowShift[txSz], bitDepth,
                              f.at(y, x), f.stride);
    }

    // ---- intra block copy (5.11.26, 7.10.2, 7.11.3)
    int numMvFound = 0, stackMv[8][2][2], weightStack[8];   // RefStackMv[idx][list][comp]

    void add_candidate(int r, int c, int weight) {
        size_t m = mi(r, c);
        if (isInter[m]) add_ref_mv_candidate(m, weight);
    }
    void scan_row(int deltaRow) {
        int end4 = std::min(std::min(bw4, MiCols - MiCol), 16), deltaCol = 0, step16 = bw4 >= 16;
        if (std::abs(deltaRow) > 1) { deltaRow += MiRow & 1; deltaCol = 1 - (MiCol & 1); }
        for (int i = 0; i < end4;) {
            int r = MiRow + deltaRow, c = MiCol + deltaCol + i;
            if (!is_inside(r, c)) break;
            int len = std::min(bw4, kNum4x4W[miSize[mi(r, c)]]);
            if (std::abs(deltaRow) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, c, len * 2);
            i += len;
        }
    }
    void scan_col(int deltaCol) {
        int end4 = std::min(std::min(bh4, MiRows - MiRow), 16), deltaRow = 0, step16 = bh4 >= 16;
        if (std::abs(deltaCol) > 1) { deltaRow = 1 - (MiRow & 1); deltaCol += MiCol & 1; }
        for (int i = 0; i < end4;) {
            int r = MiRow + deltaRow + i, c = MiCol + deltaCol;
            if (!is_inside(r, c)) break;
            int len = std::min(bh4, kNum4x4H[miSize[mi(r, c)]]);
            if (std::abs(deltaCol) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, c, len * 2);
            i += len;
        }
    }
    void scan_point(int dr, int dc) {
        int r = MiRow + dr, c = MiCol + dc;
        if (is_inside(r, c) && written[mi(r, c)]) add_candidate(r, c, 4);
    }
    void sort_stack(int start, int end) {
        while (end > start) {
            int newEnd = start;
            for (int idx = start + 1; idx < end; idx++)
                if (weightStack[idx - 1] < weightStack[idx]) {
                    std::swap(weightStack[idx - 1], weightStack[idx]);
                    std::swap(stackMv[idx - 1], stackMv[idx]);
                    newEnd = idx;
                }
            end = newEnd;
        }
    }


    void read_intrabc_mv() {
        // the stack of a block whose reference is this frame (its
        // neighbours' vectors are whole samples already)
        RefFrame0 = INTRA_FRAME;
        find_mv_stack(0);
        int nearest[2] = {stackMv[0][0][0], stackMv[0][0][1]}, near[2] = {stackMv[1][0][0], stackMv[1][0][1]};
        int ref[2];
        if (nearest[0] || nearest[1]) { ref[0] = nearest[0]; ref[1] = nearest[1]; }
        else { ref[0] = near[0]; ref[1] = near[1]; }
        if (!ref[0] && !ref[1]) {
            int sbSize4 = sb128 ? 32 : 16;
            if (MiRow - sbSize4 < MiRowStart) { ref[0] = 0; ref[1] = (-4 * sbSize4 - 256) * 8; }
            else { ref[0] = -4 * sbSize4 * 8; ref[1] = 0; }
        }
        ref[0] = (ref[0] >> 3) * 8; ref[1] = (ref[1] >> 3) * 8;
        int joint = sd.symbol(ndvc, 4);
        int diff0 = 0, diff1 = 0;
        if (joint == 2 || joint == 3) diff0 = read_mv_comp(ndvc, 0);
        if (joint == 1 || joint == 3) diff1 = read_mv_comp(ndvc, 1);
        Mv[0] = ((ref[0] + diff0) >> 3) * 8;
        Mv[1] = ((ref[1] + diff1) >> 3) * 8;
    }

    // the whole block (and its chroma, in one piece) from already decoded
    // samples of this frame; the 2-tap filter at chroma half-sample offsets
    void predict_intrabc() {
        for (int plane = 0; plane < 1 + 2 * HasChroma; plane++) {
            int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
            int planeSz = plane_residual_size(MiSize, plane);
            int w = kNum4x4W[planeSz] * 4, h = kNum4x4H[planeSz] * 4;
            int baseX = (MiCol >> sx) * 4, baseY = (MiRow >> sy) * 4;
            int px = (2 * Mv[1]) >> sx, py = (2 * Mv[0]) >> sy;  // 1/16 sample
            int ix = baseX + (px >> 4), iy = baseY + (py >> 4), fx = px & 15, fy = py & 15;
            int lastX = ((FrameWidth + sx) >> sx) - 1, lastY = ((FrameHeight + sy) >> sy) - 1;
            Plane& f = frame[plane];
            static thread_local uint16_t pred[128 * 128];
            auto ref = [&](int y, int x) { return (int)f.get(clip3(0, lastY, y), clip3(0, lastX, x)); };
            for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
                int y = iy + i, x = ix + j, v;
                if (!fx && !fy) v = ref(y, x);
                else if (fx && !fy) v = (ref(y, x) + ref(y, x + 1) + 1) >> 1;
                else if (!fx && fy) v = (ref(y, x) + ref(y + 1, x) + 1) >> 1;
                else v = (ref(y, x) + ref(y, x + 1) + ref(y + 1, x) + ref(y + 1, x + 1) + 2) >> 2;
                pred[i * w + j] = (uint16_t)v;
            }
            for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) *f.at(baseY + i, baseX + j) = pred[i * w + j];
        }
    }


    // ================================================================ inter blocks
    // inter_frame_mode_info (5.11.18): segment ids (5.11.19), the skip
    // mode (5.11.10), then an intra block or inter_block_mode_info
    int seg_feature_active(int f) const { return segEnabled && featEn[segment_id][f]; }
    int segIdPredicted = 0;

    void inter_frame_mode_info() {
        use_intrabc = 0; Mv[0] = Mv[1] = 0; Mv1[0] = Mv1[1] = 0;
        size_t a = AvailU ? mi(MiRow - 1, MiCol) : 0, l = AvailL ? mi(MiRow, MiCol - 1) : 0;
        AboveRefFrame0 = AvailU ? refFrame0[a] : INTRA_FRAME; AboveRefFrame1 = AvailU ? refFrame1[a] : NONE_FRAME;
        LeftRefFrame0 = AvailL ? refFrame0[l] : INTRA_FRAME; LeftRefFrame1 = AvailL ? refFrame1[l] : NONE_FRAME;
        int leftIntra = LeftRefFrame0 <= INTRA_FRAME, aboveIntra = AboveRefFrame0 <= INTRA_FRAME;
        Skip = 0; skipMode = 0; segIdPredicted = 0;
        inter_segment_id(1);
        // read_skip_mode
        if (!seg_feature_active(SEG_LVL_SKIP) && !seg_feature_active(SEG_LVL_REF_FRAME) &&
            !seg_feature_active(SEG_LVL_GLOBALMV) && skipModePresent && bw4 >= 2 && bh4 >= 2) {
            int ctx = (AvailU && skipModeMi[a]) + (AvailL && skipModeMi[l]);
            skipMode = sd.symbol(cdf.skip_mode[ctx], 2);
        }
        if (skipMode) Skip = 1;
        else if (segIdPreSkip && seg_feature_active(SEG_LVL_SKIP)) Skip = 1;
        else {
            int ctx = 0;
            if (AvailU) ctx += skip[a];
            if (AvailL) ctx += skip[l];
            Skip = sd.symbol(cdf.skip[ctx], 2);
        }
        if (!segIdPreSkip) inter_segment_id(0);
        Lossless = losslessArr[segment_id];
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        readDeltas = 0;
        // read_is_inter
        if (skipMode) is_inter = 1;
        else if (seg_feature_active(SEG_LVL_REF_FRAME)) is_inter = featData[segment_id][SEG_LVL_REF_FRAME] != INTRA_FRAME;
        else if (seg_feature_active(SEG_LVL_GLOBALMV)) is_inter = 1;
        else {
            int ictx;
            if (AvailU && AvailL) ictx = (leftIntra && aboveIntra) ? 3 : (leftIntra || aboveIntra);
            else if (AvailU || AvailL) ictx = 2 * (AvailU ? aboveIntra : leftIntra);
            else ictx = 0;
            is_inter = sd.symbol(cdf.intra_inter[ictx], 2);
        }
        interintra = 0; compoundType = COMPOUND_AVERAGE; compGroupIdx = 0; compoundIdx = 1;
        PaletteSizeY = PaletteSizeUV = 0; use_filter_intra = 0;
        memset(paletteColors, 0, sizeof(paletteColors));
        if (is_inter) {
            AngleDeltaY = AngleDeltaUV = 0;   // an inter-intra block's intra half has none
            inter_block_mode_info();
            return;
        }
        RefFrame0 = INTRA_FRAME; RefFrame1 = NONE_FRAME; interpF[0] = interpF[1] = 0;
        YMode = sd.symbol(cdf.y_mode[kSizeGroup[MiSize]], 13);
        intra_modes_after_y();
    }

    // get_segment_id: the smallest of PrevSegmentIds under the block
    int predicted_segment_id() const {
        if (prevSegIds.empty()) return 0;
        int seg = 7;
        for (int y = 0; y < std::min(MiRows - MiRow, bh4); y++)
            for (int x = 0; x < std::min(MiCols - MiCol, bw4); x++)
                seg = std::min(seg, (int)prevSegIds[(size_t)(MiRow + y) * MiCols + MiCol + x]);
        return seg;
    }

    void inter_segment_id(int preSkip) {
        if (!segEnabled) { segment_id = 0; return; }
        if (!segUpdateMap) { segment_id = predicted_segment_id(); return; }
        if (preSkip && !segIdPreSkip) { segment_id = 0; return; }
        segIdPredicted = 0;
        if (!preSkip && Skip) { read_segment_id(); return; }   // the spatial prediction
        if (segTemporalUpdate) {
            int ctx = (AvailU && segPredMi[mi(MiRow - 1, MiCol)]) + (AvailL && segPredMi[mi(MiRow, MiCol - 1)]);
            segIdPredicted = sd.symbol(cdf.seg_pred[ctx], 2);
            if (segIdPredicted) { segment_id = predicted_segment_id(); census[C_SEG_PREDICTED]++; }
            else read_segment_id();
        } else read_segment_id();
    }

    // read_ref_frames (5.11.25) with libaom's contexts (av1_collect_
    // neighbors_ref_counts counts both references of an inter neighbour)
    int has_uni_comp(int r0, int r1) const { return r1 > INTRA_FRAME && (r0 >= BWDREF_FRAME) == (r1 >= BWDREF_FRAME); }
    int comp_ref_type_ctx() const {
        int aIntra = AboveRefFrame0 <= INTRA_FRAME, lIntra = LeftRefFrame0 <= INTRA_FRAME;
        if (AvailU && AvailL) {
            if (aIntra && lIntra) return 2;
            if (aIntra || lIntra) {
                int r0 = aIntra ? LeftRefFrame0 : AboveRefFrame0, r1 = aIntra ? LeftRefFrame1 : AboveRefFrame1;
                return r1 <= INTRA_FRAME ? 2 : 1 + 2 * has_uni_comp(r0, r1);
            }
            int aSingle = AboveRefFrame1 <= INTRA_FRAME, lSingle = LeftRefFrame1 <= INTRA_FRAME;
            int sameDir = (AboveRefFrame0 >= BWDREF_FRAME) == (LeftRefFrame0 >= BWDREF_FRAME);
            if (aSingle && lSingle) return 1 + 2 * sameDir;
            if (aSingle || lSingle) {
                int uni = aSingle ? has_uni_comp(LeftRefFrame0, LeftRefFrame1) : has_uni_comp(AboveRefFrame0, AboveRefFrame1);
                return uni ? 3 + sameDir : 1;
            }
            int aUni = has_uni_comp(AboveRefFrame0, AboveRefFrame1), lUni = has_uni_comp(LeftRefFrame0, LeftRefFrame1);
            if (!aUni && !lUni) return 0;
            if (!aUni || !lUni) return 2;
            return 3 + ((AboveRefFrame0 == BWDREF_FRAME) == (LeftRefFrame0 == BWDREF_FRAME));
        }
        if (AvailU || AvailL) {
            int r0 = AvailU ? AboveRefFrame0 : LeftRefFrame0, r1 = AvailU ? AboveRefFrame1 : LeftRefFrame1;
            if (r0 <= INTRA_FRAME || r1 <= INTRA_FRAME) return 2;
            return 4 * has_uni_comp(r0, r1);
        }
        return 2;
    }
    int comp_mode_ctx() const {
        auto bwd = [](int r) { return r >= BWDREF_FRAME; };
        int aSingle = AboveRefFrame1 <= INTRA_FRAME, lSingle = LeftRefFrame1 <= INTRA_FRAME;
        if (AvailU && AvailL) {
            if (aSingle && lSingle) return bwd(AboveRefFrame0) ^ bwd(LeftRefFrame0);
            if (aSingle) return 2 + (bwd(AboveRefFrame0) || AboveRefFrame0 <= INTRA_FRAME);
            if (lSingle) return 2 + (bwd(LeftRefFrame0) || LeftRefFrame0 <= INTRA_FRAME);
            return 4;
        }
        if (AvailU || AvailL) {
            int r0 = AvailU ? AboveRefFrame0 : LeftRefFrame0;
            return (AvailU ? aSingle : lSingle) ? bwd(r0) : 3;
        }
        return 1;
    }

    void read_ref_frames() {
        RefFrame1 = NONE_FRAME;
        if (skipMode) { RefFrame0 = SkipModeFrame[0]; RefFrame1 = SkipModeFrame[1]; return; }
        if (seg_feature_active(SEG_LVL_REF_FRAME)) {
            RefFrame0 = featData[segment_id][SEG_LVL_REF_FRAME]; census[C_SEG_REF_FRAME]++; return;
        }
        if (seg_feature_active(SEG_LVL_SKIP) || seg_feature_active(SEG_LVL_GLOBALMV)) { RefFrame0 = LAST_FRAME; return; }
        int c[8] = {0};
        if (AvailU && AboveRefFrame0 > INTRA_FRAME) { c[AboveRefFrame0]++; if (AboveRefFrame1 > INTRA_FRAME) c[AboveRefFrame1]++; }
        if (AvailL && LeftRefFrame0 > INTRA_FRAME) { c[LeftRefFrame0]++; if (LeftRefFrame1 > INTRA_FRAME) c[LeftRefFrame1]++; }
        auto ctx = [](int a, int b) { return a < b ? 0 : a == b ? 1 : 2; };
        int compound = 0;
        if (referenceSelect && std::min(bw4, bh4) >= 2) compound = sd.symbol(cdf.comp_inter[comp_mode_ctx()], 2);
        if (compound) {
            if (!sd.symbol(cdf.comp_ref_type[comp_ref_type_ctx()], 2)) {   // UNIDIR_COMP_REFERENCE
                census[C_UNIDIR_COMP]++;
                if (sd.symbol(cdf.uni_comp_ref[ctx(c[1] + c[2] + c[3] + c[4], c[5] + c[6] + c[7])][0], 2)) {
                    RefFrame0 = BWDREF_FRAME; RefFrame1 = ALTREF_FRAME;
                } else if (sd.symbol(cdf.uni_comp_ref[ctx(c[2], c[3] + c[4])][1], 2)) {
                    RefFrame0 = LAST_FRAME;
                    RefFrame1 = sd.symbol(cdf.uni_comp_ref[ctx(c[3], c[4])][2], 2) ? GOLDEN_FRAME : 3;
                } else { RefFrame0 = LAST_FRAME; RefFrame1 = 2; }
                return;
            }
            if (!sd.symbol(cdf.comp_ref[ctx(c[1] + c[2], c[3] + c[4])][0], 2))
                RefFrame0 = sd.symbol(cdf.comp_ref[ctx(c[1], c[2])][1], 2) ? 2 : LAST_FRAME;
            else RefFrame0 = sd.symbol(cdf.comp_ref[ctx(c[3], c[4])][2], 2) ? GOLDEN_FRAME : 3;
            if (!sd.symbol(cdf.comp_bwdref[ctx(c[5] + c[6], c[7])][0], 2))
                RefFrame1 = sd.symbol(cdf.comp_bwdref[ctx(c[5], c[6])][1], 2) ? ALTREF2_FRAME : BWDREF_FRAME;
            else RefFrame1 = ALTREF_FRAME;
            return;
        }
        if (sd.symbol(cdf.single_ref[ctx(c[1] + c[2] + c[3] + c[4], c[5] + c[6] + c[7])][0], 2)) {
            if (!sd.symbol(cdf.single_ref[ctx(c[5] + c[6], c[7])][1], 2))
                RefFrame0 = sd.symbol(cdf.single_ref[ctx(c[5], c[6])][5], 2) ? ALTREF2_FRAME : BWDREF_FRAME;
            else RefFrame0 = ALTREF_FRAME;
        } else {
            if (sd.symbol(cdf.single_ref[ctx(c[1] + c[2], c[3] + c[4])][2], 2))
                RefFrame0 = sd.symbol(cdf.single_ref[ctx(c[3], c[4])][4], 2) ? GOLDEN_FRAME : 3;
            else RefFrame0 = sd.symbol(cdf.single_ref[ctx(c[1], c[2])][3], 2) ? 2 : LAST_FRAME;
        }
    }

    // the single-reference mode of each list of a compound mode (get_mode)
    static int list_mode(int yMode, int list) {
        if (yMode < NEAREST_NEARESTMV) return yMode;
        static const int modes[8][2] = {
            {NEARESTMV, NEARESTMV}, {NEARMV, NEARMV}, {NEARESTMV, NEWMV}, {NEWMV, NEARESTMV},
            {NEARMV, NEWMV}, {NEWMV, NEARMV}, {GLOBALMV, GLOBALMV}, {NEWMV, NEWMV}};
        return modes[yMode - NEAREST_NEARESTMV][list];
    }
    static int has_newmv(int mode) { return list_mode(mode, 0) == NEWMV || list_mode(mode, 1) == NEWMV; }

    void inter_block_mode_info() {
        read_ref_frames();
        int isCompound = RefFrame1 > INTRA_FRAME;
        find_mv_stack(isCompound);
        if (skipMode) { YMode = NEAREST_NEARESTMV; census[C_SKIP_MODE]++; }
        else if (seg_feature_active(SEG_LVL_SKIP) || seg_feature_active(SEG_LVL_GLOBALMV)) {
            YMode = GLOBALMV;
            census[seg_feature_active(SEG_LVL_SKIP) ? C_SEG_SKIP : C_SEG_GLOBALMV]++;
        } else if (isCompound) {
            static const int ctxMap[3][5] = {{0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};
            YMode = NEAREST_NEARESTMV + sd.symbol(cdf.compound_mode[ctxMap[RefMvContext >> 1][std::min(NewMvContext, 4)]], 8);
        } else if (!sd.symbol(cdf.newmv[NewMvContext], 2)) YMode = NEWMV;
        else if (!sd.symbol(cdf.zeromv[ZeroMvContext], 2)) YMode = GLOBALMV;
        else YMode = sd.symbol(cdf.refmv[RefMvContext], 2) ? NEARMV : NEARESTMV;
        RefMvIdx = 0;
        int m0 = list_mode(YMode, 0), m1 = list_mode(YMode, isCompound);
        if (!skipMode && (YMode == NEWMV || YMode == NEW_NEWMV || m0 == NEARMV || m1 == NEARMV)) {
            int first = YMode == NEWMV || YMode == NEW_NEWMV ? 0 : 1;
            RefMvIdx = first;
            for (int idx = first; idx < first + 2; idx++) {
                if (numMvFound <= idx + 1) continue;
                census[C_DRL]++;
                if (!sd.symbol(cdf.drl[DrlCtxStack[idx]], 2)) { RefMvIdx = idx; break; }
                RefMvIdx = idx + 1;
            }
        }
        // assign_mv
        for (int list = 0; list < 1 + isCompound; list++) {
            int mode = list_mode(YMode, list), pred[2];
            if (mode == GLOBALMV) { pred[0] = GlobalMvs[list][0]; pred[1] = GlobalMvs[list][1]; }
            else {
                int pos = mode == NEARESTMV ? 0 : RefMvIdx;
                if (mode == NEWMV && !isCompound && numMvFound <= 1) pos = 0;
                pred[0] = stackMv[pos][list][0]; pred[1] = stackMv[pos][list][1];
            }
            if (mode == NEWMV) {
                int joint = sd.symbol(cdf.nmv, 4);
                if (joint == 2 || joint == 3) pred[0] += read_mv_comp(cdf.nmv, 0);
                if (joint == 1 || joint == 3) pred[1] += read_mv_comp(cdf.nmv, 1);
            }
            int* mv = list ? Mv1 : Mv;
            mv[0] = pred[0]; mv[1] = pred[1];
        }
        if (isCompound) {
            census[C_COMPOUND]++;
            census[C_COMPOUND_MODE + YMode - NEAREST_NEARESTMV]++;
        }
        // read_interintra_mode (every size it allows has wedges)
        if (!skipMode && enInterintra && !isCompound && MiSize >= BLOCK_8X8 && MiSize <= BLOCK_32X32 &&
            sd.symbol(cdf.interintra[kSizeGroup[MiSize]], 2)) {
            interintra = 1;
            interintraMode = sd.symbol(cdf.interintra_mode[kSizeGroup[MiSize]], 4);
            census[C_INTERINTRA]++;
            wedgeInterintra = sd.symbol(cdf.wedge_interintra[MiSize], 2);
            if (wedgeInterintra) { wedgeIndex = sd.symbol(cdf.wedge_idx[MiSize], 16); census[C_WEDGE_INTERINTRA]++; }
        }
        // read_motion_mode
        motionMode = 0;
        int nonTransGlobal = (YMode == GLOBALMV || YMode == GLOBAL_GLOBALMV) && gmType[RefFrame0] > TRANSLATION;
        if (!skipMode && motionSwitchable && std::min(bw4, bh4) >= 2 && !(!forceIntegerMv && nonTransGlobal) &&
            !isCompound && !interintra && has_overlappable_candidates()) {
            int mode;
            find_warp_samples();
            if (forceIntegerMv || !allowWarped || ref_is_scaled(RefFrame0) || !numSamples)
                mode = sd.symbol(cdf.obmc[MiSize], 2);
            else mode = sd.symbol(cdf.motion_mode[MiSize], 3);
            motionMode = mode;
            census[C_MOTION_MODE_READ]++;
            if (mode == 1) census[C_OBMC]++;
            if (mode == 2) { census[C_LOCALWARP]++; warp_estimation(); }
        }
        // read_compound_type (5.11.27)
        if (isCompound && !skipMode) {
            int wedgeBits = (MiSize >= BLOCK_8X8 && MiSize <= BLOCK_32X32) || MiSize == BLOCK_8X32 || MiSize == BLOCK_32X8;
            if (enMaskedCompound) compGroupIdx = sd.symbol(cdf.comp_group_idx[comp_group_idx_ctx()], 2);
            if (!compGroupIdx) {
                if (enJntComp) {
                    compoundIdx = sd.symbol(cdf.compound_idx[compound_idx_ctx()], 2);
                    compoundType = compoundIdx ? COMPOUND_AVERAGE : COMPOUND_DISTANCE;
                }
            } else {
                compoundType = wedgeBits ? sd.symbol(cdf.compound_type[MiSize], 2) : COMPOUND_DIFFWTD;
                if (compoundType == COMPOUND_WEDGE) { wedgeIndex = sd.symbol(cdf.wedge_idx[MiSize], 16); wedgeSign = sd.literal(1); }
                else maskType = sd.literal(1);
            }
        }
        if (isCompound) census[compoundType == COMPOUND_AVERAGE ? C_COMP_AVERAGE : compoundType == COMPOUND_DISTANCE
                              ? C_COMP_DISTANCE : compoundType == COMPOUND_WEDGE ? C_COMP_WEDGE : C_COMP_DIFFWTD]++;
        // interpolation filters: vertical, then horizontal; none for the
        // skip mode, a local warp, or a large GLOBALMV block whose models
        // are none of them translations (libaom's av1_is_interp_needed)
        int needs = !skipMode && motionMode != 2;
        if (needs && (YMode == GLOBALMV || YMode == GLOBAL_GLOBALMV) && std::min(bw4, bh4) >= 2) {
            int anyTranslation = gmType[RefFrame0] == TRANSLATION || (isCompound && gmType[RefFrame1] == TRANSLATION);
            needs = anyTranslation;
        }
        if (interpFilter == SWITCHABLE) {
            for (int dir = 0; dir < (enDualFilter ? 2 : 1); dir++)
                interpF[dir] = needs ? sd.symbol(cdf.interp[interp_ctx(dir)], 3) : EIGHTTAP;
            if (!enDualFilter) interpF[1] = interpF[0];
        } else interpF[0] = interpF[1] = interpFilter;
        // libaom's encoder writes neither (its sequence headers never enable
        // dual filters)
        if (interpF[0] == BILINEAR || interpF[1] == BILINEAR) refuse(TOOL_BILINEAR);
        if (interpF[0] != interpF[1]) refuse(TOOL_DUAL_FILTER);
    }

    int comp_group_idx_ctx() const {
        auto side = [&](int avail, size_t m) {
            if (!avail) return 0;
            if (refFrame1[m] > INTRA_FRAME) return (int)compGroupIdxMi[m];
            return refFrame0[m] == ALTREF_FRAME ? 3 : 0;
        };
        return std::min(5, side(AvailU, AvailU ? mi(MiRow - 1, MiCol) : 0) + side(AvailL, AvailL ? mi(MiRow, MiCol - 1) : 0));
    }
    int compound_idx_ctx() const {
        int fwd = std::abs(relative_dist(refs[refFrameIdx[RefFrame1 - LAST_FRAME]].orderHint, orderHint));
        int bck = std::abs(relative_dist(orderHint, refs[refFrameIdx[RefFrame0 - LAST_FRAME]].orderHint));
        auto side = [&](int avail, size_t m) {
            if (!avail) return 0;
            if (refFrame1[m] > INTRA_FRAME) return (int)compoundIdxMi[m];
            return refFrame0[m] == ALTREF_FRAME ? 1 : 0;
        };
        return side(AvailU, AvailU ? mi(MiRow - 1, MiCol) : 0) + side(AvailL, AvailL ? mi(MiRow, MiCol - 1) : 0) +
               3 * (fwd == bck);
    }

    int interp_ctx(int dir) const {
        int ctx = ((dir & 1) * 2 + (RefFrame1 > INTRA_FRAME)) * 4, leftType = 3, aboveType = 3;
        if (AvailL) {
            size_t m = mi(MiRow, MiCol - 1);
            if (refFrame0[m] == RefFrame0 || refFrame1[m] == RefFrame0) leftType = dir ? filt1[m] : filt0[m];
        }
        if (AvailU) {
            size_t m = mi(MiRow - 1, MiCol);
            if (refFrame0[m] == RefFrame0 || refFrame1[m] == RefFrame0) aboveType = dir ? filt1[m] : filt0[m];
        }
        if (leftType == aboveType) ctx += leftType;
        else if (leftType == 3) ctx += aboveType;
        else if (aboveType == 3) ctx += leftType;
        else ctx += 3;
        return ctx;
    }

    int has_overlappable_candidates() const {
        if (AvailU)
            for (int x4 = MiCol; x4 < std::min(MiCols, MiCol + bw4); x4 += 2) {
                int x5 = std::min(x4 | 1, MiCols - 1);
                if (refFrame0[mi(MiRow - 1, x5)] > INTRA_FRAME) return 1;
            }
        if (AvailL)
            for (int y4 = MiRow; y4 < std::min(MiRows, MiRow + bh4); y4 += 2) {
                int y5 = std::min(y4 | 1, MiRows - 1);
                if (refFrame0[mi(y5, MiCol - 1)] > INTRA_FRAME) return 1;
            }
        return 0;
    }

    // read_mv_component (5.11.32) on an nmv context (joints, then per
    // component classes, class0_fr, fr, sign, class0_hp, hp, class0, bits);
    // an intra frame's force_integer_mv leaves no fraction (intra block copy)
    int read_mv_comp(uint16_t* nmv, int comp) {
        uint16_t* c = nmv + 5 + 69 * comp;
        int sign = sd.symbol(c + 27, 2);
        int cls = sd.symbol(c, 11);
        int d, mag;
        if (cls == 0) { d = sd.symbol(c + 36, 2); mag = 0; }
        else {
            d = 0;
            for (int i = 0; i < cls; i++) d |= sd.symbol(c + 39 + 3 * i, 2) << i;
            mag = 2 << (cls + 2);
        }
        int fr = forceIntegerMv ? 3 : sd.symbol(cls == 0 ? c + 12 + 5 * d : c + 22, 4);
        int hp = allowHp ? sd.symbol(cls == 0 ? c + 30 : c + 33, 2) : 1;
        mag += ((d << 3) | (fr << 1) | hp) + 1;
        return sign ? -mag : mag;
    }

    // ---- motion vector prediction (7.10.2) for one or two references
    int GlobalMvs[2][2] = {{0, 0}, {0, 0}}, NewMvContext = 0, RefMvContext = 0, ZeroMvContext = 0, DrlCtxStack[8];
    int newMvCount = 0, foundMatch = 0, stackCompound = 0;

    void lower_mv_precision(int* mv) const {
        if (allowHp) return;
        for (int i = 0; i < 2; i++) {
            if (forceIntegerMv) {
                int a = std::abs(mv[i]), aInt = (a + 3) >> 3;
                mv[i] = mv[i] > 0 ? aInt << 3 : -(aInt << 3);
            } else if (mv[i] & 1) mv[i] += mv[i] > 0 ? -1 : 1;
        }
    }

    // setup_global_mv (7.10.2.1), as libaom's gm_get_motion_vector (a
    // translation's offsets go to row and column swapped, as the
    // specification has them)
    void setup_global_mv(int list) {
        int ref = list ? RefFrame1 : RefFrame0, mv[2] = {0, 0};
        int typ = ref > INTRA_FRAME ? gmType[ref] : IDENTITY;
        if (typ == TRANSLATION) { mv[0] = gmParams[ref][0] >> 13; mv[1] = gmParams[ref][1] >> 13; }
        else if (typ != IDENTITY) {
            const int* g = gmParams[ref];
            int x = MiCol * 4 + bw4 * 2 - 1, y = MiRow * 4 + bh4 * 2 - 1;
            int xc = (g[2] - (1 << 16)) * x + g[3] * y + g[0];
            int yc = g[4] * x + (g[5] - (1 << 16)) * y + g[1];
            if (allowHp) { mv[0] = round2signed(yc, 13); mv[1] = round2signed(xc, 13); }
            else { mv[0] = round2signed(yc, 14) * 2; mv[1] = round2signed(xc, 14) * 2; }
        }
        lower_mv_precision(mv);
        GlobalMvs[list][0] = mv[0]; GlobalMvs[list][1] = mv[1];
    }

    void push_stack(const int (*mv)[2], int weight) {
        int idx;
        for (idx = 0; idx < numMvFound; idx++)
            if (stackMv[idx][0][0] == mv[0][0] && stackMv[idx][0][1] == mv[0][1] &&
                (!stackCompound || (stackMv[idx][1][0] == mv[1][0] && stackMv[idx][1][1] == mv[1][1]))) break;
        if (idx < numMvFound) weightStack[idx] += weight;
        else if (numMvFound < 8) {
            memcpy(stackMv[numMvFound], mv, sizeof(stackMv[0]));
            weightStack[numMvFound] = weight; numMvFound++;
        }
    }

    // add_ref_mv_candidate (7.10.2.7): search_stack for each list of the
    // candidate that uses this block's reference, or compound_search_stack
    void add_ref_mv_candidate(size_t m, int weight) {
        int candMode = yMode[m], candSize = miSize[m];
        int globalCand = (candMode == GLOBALMV || candMode == GLOBAL_GLOBALMV) &&
                         std::min(kNum4x4W[candSize], kNum4x4H[candSize]) >= 2;
        int mvs[2][2] = {{mvRow[m], mvCol[m]}, {mvRow1[m], mvCol1[m]}};
        if (!stackCompound) {
            for (int list = 0; list < 2; list++) {
                if ((list ? refFrame1[m] : refFrame0[m]) != RefFrame0) continue;
                int mv[2][2] = {{mvs[list][0], mvs[list][1]}, {0, 0}};
                if (globalCand && gmType[RefFrame0] > TRANSLATION) { mv[0][0] = GlobalMvs[0][0]; mv[0][1] = GlobalMvs[0][1]; }
                lower_mv_precision(mv[0]);
                if (has_newmv(candMode)) newMvCount++;
                foundMatch = 1;
                push_stack(mv, weight);
            }
            return;
        }
        if (refFrame0[m] != RefFrame0 || refFrame1[m] != RefFrame1) return;
        for (int list = 0; list < 2; list++) {
            if (globalCand && gmType[list ? RefFrame1 : RefFrame0] > TRANSLATION) {
                mvs[list][0] = GlobalMvs[list][0]; mvs[list][1] = GlobalMvs[list][1];
            }
            lower_mv_precision(mvs[list]);
        }
        foundMatch = 1;
        push_stack(mvs, weight);
        if (has_newmv(candMode)) newMvCount++;
    }

    void find_mv_stack(int isCompound) {
        numMvFound = 0; newMvCount = 0; stackCompound = isCompound;
        setup_global_mv(0);
        if (isCompound) setup_global_mv(1);
        foundMatch = 0;
        scan_row(-1);
        int foundAbove = foundMatch;
        foundMatch = 0;
        scan_col(-1);
        int foundLeft = foundMatch;
        foundMatch = 0;
        if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
        if (foundMatch) foundAbove = 1;
        int closeMatches = foundAbove + foundLeft;
        int numNearest = numMvFound, numNew = newMvCount;
        for (int i = 0; i < numNearest; i++) weightStack[i] += 640;
        ZeroMvContext = 0;
        if (useRefFrameMvs) temporal_scan();
        foundMatch = 0;
        scan_point(-1, -1);
        if (foundMatch) foundAbove = 1;
        foundMatch = 0;
        scan_row(-3);
        if (foundMatch) foundAbove = 1;
        foundMatch = 0;
        scan_col(-3);
        if (foundMatch) foundLeft = 1;
        foundMatch = 0;
        if (bh4 > 1) scan_row(-5);
        if (foundMatch) foundAbove = 1;
        foundMatch = 0;
        if (bw4 > 1) scan_col(-5);
        if (foundMatch) foundLeft = 1;
        int totalMatches = foundAbove + foundLeft;
        sort_stack(0, numNearest);
        sort_stack(numNearest, numMvFound);
        if (numMvFound < 2) { if (isCompound) compound_extra_search(); else extra_search(); }
        for (int idx = 0; idx < numMvFound; idx++) {
            int z = 0;
            if (idx + 1 < numMvFound) {
                int w0 = weightStack[idx], w1 = weightStack[idx + 1];
                if (w0 >= 640) { if (w1 < 640) z = 1; }
                else z = 2;
            }
            DrlCtxStack[idx] = z;
        }
        for (int i = 0; i < numMvFound; i++)
            for (int list = 0; list < 1 + isCompound; list++) {
                int bh = bh4 * 4, bw = bw4 * 4;
                int top = -(MiRow * 4 * 8), bottom = (MiRows - bh4 - MiRow) * 4 * 8;
                int left = -(MiCol * 4 * 8), right = (MiCols - bw4 - MiCol) * 4 * 8;
                stackMv[i][list][0] = clip3(top - (128 + bh * 8), bottom + (128 + bh * 8), stackMv[i][list][0]);
                stackMv[i][list][1] = clip3(left - (128 + bw * 8), right + (128 + bw * 8), stackMv[i][list][1]);
            }
        if (closeMatches == 0) { NewMvContext = std::min(totalMatches, 1); RefMvContext = totalMatches; }
        else if (closeMatches == 1) { NewMvContext = 3 - std::min(numNew, 1); RefMvContext = 2 + totalMatches; }
        else { NewMvContext = 5 - std::min(numNew, 1); RefMvContext = 5; }
        // past the stack, the global motion vector (av1_get_ref_mv_from_stack)
        for (int idx = numMvFound; idx < 2; idx++) { stackMv[idx][0][0] = GlobalMvs[0][0]; stackMv[idx][0][1] = GlobalMvs[0][1]; }
    }

    void temporal_scan() {
        int stepW4 = bw4 >= 16 ? 4 : 2, stepH4 = bh4 >= 16 ? 4 : 2, available = 0;
        for (int dr = 0; dr < std::min(bh4, 16); dr += stepH4)
            for (int dc = 0; dc < std::min(bw4, 16); dc += stepW4) {
                int ret = add_tpl_ref_mv(dr, dc);
                if (dr == 0 && dc == 0) available = ret;
            }
        if (!available) ZeroMvContext = 1;
        if (bh4 >= 2 && bh4 < 16 && bw4 >= 2 && bw4 < 16) {
            const int pos[3][2] = {{bh4, -2}, {bh4, bw4}, {bh4 - 2, bw4}};
            for (int i = 0; i < 3; i++) {
                int row = (MiRow & 15) + pos[i][0], col = (MiCol & 15) + pos[i][1];
                if (row < 0 || row >= 16 || col < 0 || col >= 16) continue;   // check_sb_border
                add_tpl_ref_mv(pos[i][0], pos[i][1]);
            }
        }
    }

    // add_tpl_ref_mv (7.10.2.6): the motion field's vector projected onto
    // each of the block's references
    int add_tpl_ref_mv(int dr, int dc) {
        int r = MiRow + ((MiRow & 1) ? dr : dr + 1), c = MiCol + ((MiCol & 1) ? dc : dc + 1);
        if (!is_inside(r, c)) return 0;
        size_t t = (size_t)(r >> 1) * tplStride + (c >> 1);
        if (!tplValid[t]) return 0;
        int fwd[2] = {tplMv[2 * t], tplMv[2 * t + 1]}, mv[2][2] = {{0, 0}, {0, 0}};
        for (int list = 0; list < 1 + stackCompound; list++) {
            int ref = list ? RefFrame1 : RefFrame0;
            int curOff = relative_dist(orderHint, refs[refFrameIdx[ref - LAST_FRAME]].orderHint);
            mv_projection(mv[list], fwd, curOff, tplOff[t]);
            lower_mv_precision(mv[list]);
            if (dr == 0 && dc == 0 && (std::abs(mv[list][0] - GlobalMvs[list][0]) >= 16 ||
                                       std::abs(mv[list][1] - GlobalMvs[list][1]) >= 16))
                ZeroMvContext = 1;
        }
        census[C_TEMPORAL_MV]++;
        push_stack(mv, 2);
        return 1;
    }

    // find_warp_samples (7.10.4) as libaom's av1_findSamples and
    // av1_selectSamples: the centres of the neighbours that use this
    // block's reference, before and after their motion
    int numSamples = 0, candList[8][4];
    void find_warp_samples() {
        int scanned = 0, doTopLeft = 1, doTopRight = 1;
        numSamples = 0;
        int thresh = clip3(16, 112, std::max(bw4, bh4) * 4);
        auto add = [&](int dr, int dc) {
            if (scanned >= 8) return;
            int r = MiRow + dr, c = MiCol + dc;
            if (!is_inside(r, c)) return;
            size_t m = mi(r, c);
            if (!written[m] || refFrame0[m] != RefFrame0 || refFrame1[m] != NONE_FRAME) return;
            int cw4 = kNum4x4W[miSize[m]], ch4 = kNum4x4H[miSize[m]];
            int candRow = r & ~(ch4 - 1), candCol = c & ~(cw4 - 1);
            int midY = candRow * 4 + ch4 * 2 - 1, midX = candCol * 4 + cw4 * 2 - 1;
            int valid = std::abs(mvRow[m] - Mv[0]) + std::abs(mvCol[m] - Mv[1]) <= thresh;
            scanned++;
            if (!valid && scanned > 1) return;
            candList[numSamples][0] = midY * 8; candList[numSamples][1] = midX * 8;
            candList[numSamples][2] = midY * 8 + mvRow[m]; candList[numSamples][3] = midX * 8 + mvCol[m];
            if (valid) numSamples++;
        };
        if (AvailU) {
            int srcW = kNum4x4W[miSize[mi(MiRow - 1, MiCol)]];
            if (bw4 <= srcW) {
                int colOffset = -(MiCol & (srcW - 1));
                if (colOffset < 0) doTopLeft = 0;
                if (colOffset + srcW > bw4) doTopRight = 0;
                add(-1, 0);
            } else {
                for (int i = 0, step = 0; i < std::min(bw4, MiCols - MiCol); i += step) {
                    step = kNum4x4W[miSize[mi(MiRow - 1, MiCol + i)]];   // libaom steps by the neighbour
                    add(-1, i);
                }
            }
        }
        if (AvailL) {
            int srcH = kNum4x4H[miSize[mi(MiRow, MiCol - 1)]];
            if (bh4 <= srcH) {
                if (-(MiRow & (srcH - 1)) < 0) doTopLeft = 0;
                add(0, -1);
            } else {
                for (int i = 0, step = 0; i < std::min(bh4, MiRows - MiRow); i += step) {
                    step = kNum4x4H[miSize[mi(MiRow + i, MiCol - 1)]];
                    add(i, -1);
                }
            }
        }
        if (doTopLeft) add(-1, -1);
        if (doTopRight && std::max(bw4, bh4) <= 16) add(-1, bw4);
        if (numSamples == 0 && scanned > 0) numSamples = 1;
    }

    // warpEstimation (7.11.3.8) and setupShear (7.11.3.6), as libaom's
    // find_affine_int and av1_get_shear_params compute them
    int64_t localWarp[6];
    int localValid = 0, warpAlpha = 0, warpBeta = 0, warpGamma = 0, warpDelta = 0;
    static int16_t resolve_divisor(uint64_t d, int* shift) {
        int sh = 0;
        while ((d >> sh) > 1) sh++;
        int64_t e = (int64_t)(d - ((uint64_t)1 << sh)), f;
        if (sh > 8) f = (e + ((int64_t)1 << (sh - 9))) >> (sh - 8);
        else f = e << (8 - sh);
        *shift = sh + 14;
        return k_div_lut[f];
    }
    static int64_t round2signed64(int64_t v, int n) {
        if (n == 0) return v;
        return v < 0 ? -((-v + ((int64_t)1 << (n - 1))) >> n) : (v + ((int64_t)1 << (n - 1))) >> n;
    }
    void warp_estimation() {
        int64_t A[2][2] = {{0, 0}, {0, 0}}, Bx[2] = {0, 0}, By[2] = {0, 0};
        int rsuy = bh4 * 2 - 1, rsux = bw4 * 2 - 1;
        int suy = (MiRow * 4 + rsuy) * 8, sux = (MiCol * 4 + rsux) * 8;
        int duy = suy + Mv[0], dux = sux + Mv[1];
        auto sq = [](int64_t a) { return ((a * a) >> 2) + 2 * a + 8; };
        auto p1 = [](int64_t a, int64_t b) { return ((a * b) >> 2) + (a + b) + 4; };
        auto p2 = [](int64_t a, int64_t b) { return ((a * b) >> 2) + (a + b) + 8; };
        for (int i = 0; i < numSamples; i++) {
            int sy = candList[i][0] - suy, sx = candList[i][1] - sux;
            int dy = candList[i][2] - duy, dx = candList[i][3] - dux;
            if (std::abs(sx - dx) < 256 && std::abs(sy - dy) < 256) {
                A[0][0] += sq(sx); A[0][1] += p1(sx, sy); A[1][1] += sq(sy);
                Bx[0] += p2(sx, dx); Bx[1] += p1(sy, dx);
                By[0] += p1(sx, dy); By[1] += p2(sy, dy);
            }
        }
        // libaom keeps these sums in 32 bits
        for (auto* a : {&A[0][0], &A[0][1], &A[1][1], &Bx[0], &Bx[1], &By[0], &By[1]}) *a = (int32_t)*a;
        int64_t det = A[0][0] * A[1][1] - A[0][1] * A[0][1];
        localValid = 0;
        if (det == 0) { census[C_LOCALWARP_INVALID]++; return; }
        int shift;
        int16_t iDet = (int16_t)(resolve_divisor((uint64_t)(det < 0 ? -det : det), &shift) * (det < 0 ? -1 : 1));
        shift -= 16;
        if (shift < 0) { iDet = (int16_t)(iDet * (1 << -shift)); shift = 0; }
        int64_t px0 = A[1][1] * Bx[0] - A[0][1] * Bx[1], px1 = -A[0][1] * Bx[0] + A[0][0] * Bx[1];
        int64_t py0 = A[1][1] * By[0] - A[0][1] * By[1], py1 = -A[0][1] * By[0] + A[0][0] * By[1];
        const int64_t clampN = 1 << 13;
        auto diag = [&](int64_t v) { return std::max((1 << 16) - clampN + 1, std::min((1 << 16) + clampN - 1, round2signed64(v * iDet, shift))); };
        auto ndiag = [&](int64_t v) { return std::max(-clampN + 1, std::min(clampN - 1, round2signed64(v * iDet, shift))); };
        localWarp[2] = diag(px0); localWarp[3] = ndiag(px1); localWarp[4] = ndiag(py0); localWarp[5] = diag(py1);
        int64_t isuy = MiRow * 4 + rsuy, isux = MiCol * 4 + rsux;
        int64_t vx = (int64_t)Mv[1] * (1 << 13) - (isux * (localWarp[2] - (1 << 16)) + isuy * localWarp[3]);
        int64_t vy = (int64_t)Mv[0] * (1 << 13) - (isux * localWarp[4] + isuy * (localWarp[5] - (1 << 16)));
        vx = (int32_t)vx; vy = (int32_t)vy;
        localWarp[0] = std::max<int64_t>(-(1 << 23), std::min<int64_t>((1 << 23) - 1, vx));
        localWarp[1] = std::max<int64_t>(-(1 << 23), std::min<int64_t>((1 << 23) - 1, vy));
        int shear[4];
        if (!shear_params(localWarp, shear)) { census[C_LOCALWARP_INVALID]++; return; }
        warpAlpha = shear[0]; warpBeta = shear[1]; warpGamma = shear[2]; warpDelta = shear[3];
        localValid = 1;
    }

    // av1_get_shear_params: alpha, beta, gamma, delta of a model, and
    // whether the warp filter can follow its shear
    static int shear_params(const int64_t* m, int* out) {
        if (m[2] <= 0) return 0;
        auto c16 = [](int64_t v) { return (int)std::max<int64_t>(-32768, std::min<int64_t>(32767, v)); };
        int alpha = c16(m[2] - (1 << 16)), beta = c16(m[3]);
        int sh;
        int16_t y = resolve_divisor((uint64_t)m[2], &sh);
        int64_t v = (m[4] * (1 << 16)) * y;
        int gamma = c16(round2signed64(v, sh));
        v = (m[3] * m[4]) * y;
        int delta = c16(m[5] - round2signed64(v, sh) - (1 << 16));
        auto reduce = [](int x) { return (int)round2signed64(x, 6) * 64; };
        out[0] = reduce(alpha); out[1] = reduce(beta); out[2] = reduce(gamma); out[3] = reduce(delta);
        return 4 * std::abs(out[0]) + 7 * std::abs(out[1]) < (1 << 16) &&
               4 * std::abs(out[2]) + 4 * std::abs(out[3]) < (1 << 16);
    }

    int ref_is_scaled(int refFrame) const {
        const RefSlot& r = refs[refFrameIdx[refFrame - LAST_FRAME]];
        int xScale = ((r.upscaledWidth << 14) + (FrameWidth / 2)) / FrameWidth;
        int yScale = ((r.frameHeight << 14) + (FrameHeight / 2)) / FrameHeight;
        return xScale != (1 << 14) || yScale != (1 << 14);
    }

    // the single-reference extra search (libaom's process_single_ref_mv_
    // candidate): both vectors of the neighbours above, then to the left,
    // turned where their reference lies on the other side
    void extra_search() {
        if (!use_intrabc) census[C_EXTRA_SEARCH]++;
        int w4 = std::min(std::min(16, bw4), MiCols - MiCol), h4 = std::min(std::min(16, bh4), MiRows - MiRow);
        int num4x4 = std::min(w4, h4);
        for (int pass = 0; pass < 2 && numMvFound < 2; pass++) {
            int idx = 0;
            while (idx < num4x4 && numMvFound < 2) {
                int r = pass == 0 ? MiRow - 1 : MiRow + idx, c = pass == 0 ? MiCol + idx : MiCol - 1;
                if (!is_inside(r, c)) break;
                size_t m = mi(r, c);
                for (int list = 0; list < 2; list++) {
                    int candRef = list ? refFrame1[m] : refFrame0[m];
                    if (candRef <= INTRA_FRAME) continue;
                    int mv[2] = {list ? mvRow1[m] : mvRow[m], list ? mvCol1[m] : mvCol[m]};
                    if (refFrameSignBias[candRef] != refFrameSignBias[RefFrame0]) { mv[0] = -mv[0]; mv[1] = -mv[1]; }
                    int k;
                    for (k = 0; k < numMvFound; k++) if (stackMv[k][0][0] == mv[0] && stackMv[k][0][1] == mv[1]) break;
                    if (k == numMvFound) {
                        stackMv[k][0][0] = mv[0]; stackMv[k][0][1] = mv[1]; weightStack[k] = 2; numMvFound++;
                    }
                }
                idx += pass == 0 ? kNum4x4W[miSize[m]] : kNum4x4H[miSize[m]];
            }
        }
    }

    // the compound extra search (libaom's process_compound_ref_mv_
    // candidate): per list, the neighbours' vectors of that reference, then
    // of other references (turned by sign bias), then the global one
    void compound_extra_search() {
        census[C_EXTRA_SEARCH]++;
        int idMv[2][2][2], diffMv[2][2][2], idN[2] = {0, 0}, diffN[2] = {0, 0};
        int w4 = std::min(std::min(16, bw4), MiCols - MiCol), h4 = std::min(std::min(16, bh4), MiRows - MiRow);
        int num4x4 = std::min(w4, h4);
        int rf[2] = {RefFrame0, RefFrame1};
        for (int pass = 0; pass < 2; pass++) {
            if (pass == 0 ? !AvailU : !AvailL) continue;
            for (int idx = 0; idx < num4x4;) {
                size_t m = pass == 0 ? mi(MiRow - 1, MiCol + idx) : mi(MiRow + idx, MiCol - 1);
                for (int cl = 0; cl < 2; cl++) {
                    int canRf = cl ? refFrame1[m] : refFrame0[m];
                    int mv[2] = {cl ? mvRow1[m] : mvRow[m], cl ? mvCol1[m] : mvCol[m]};
                    for (int list = 0; list < 2; list++) {
                        if (canRf == rf[list] && idN[list] < 2) {
                            idMv[list][idN[list]][0] = mv[0]; idMv[list][idN[list]][1] = mv[1]; idN[list]++;
                        } else if (canRf > INTRA_FRAME && diffN[list] < 2) {
                            int s = refFrameSignBias[canRf] != refFrameSignBias[rf[list]] ? -1 : 1;
                            diffMv[list][diffN[list]][0] = s * mv[0]; diffMv[list][diffN[list]][1] = s * mv[1];
                            diffN[list]++;
                        }
                    }
                }
                idx += pass == 0 ? kNum4x4W[miSize[m]] : kNum4x4H[miSize[m]];
            }
        }
        int comp[2][2][2];
        for (int list = 0; list < 2; list++) {
            int k = 0;
            for (int i = 0; i < idN[list] && k < 2; i++, k++) { comp[k][list][0] = idMv[list][i][0]; comp[k][list][1] = idMv[list][i][1]; }
            for (int i = 0; i < diffN[list] && k < 2; i++, k++) { comp[k][list][0] = diffMv[list][i][0]; comp[k][list][1] = diffMv[list][i][1]; }
            for (; k < 2; k++) { comp[k][list][0] = GlobalMvs[list][0]; comp[k][list][1] = GlobalMvs[list][1]; }
        }
        if (numMvFound == 1) {
            int same = !memcmp(comp[0], stackMv[0], sizeof(comp[0]));
            memcpy(stackMv[1], comp[same ? 1 : 0], sizeof(comp[0]));
            weightStack[1] = 2; numMvFound = 2;
        } else {
            for (int k = 0; k < 2; k++) { memcpy(stackMv[k], comp[k], sizeof(comp[0])); weightStack[k] = 2; }
            numMvFound = 2;
        }
    }

    // ---- inter prediction (7.11.3.1): the whole block, chroma of a block
    // under 8x8 from the blocks it covers where none of them is intra; a
    // compound block from both references (predict_compound)
    void predict_inter_block() {
        if (RefFrame1 > INTRA_FRAME) { predict_compound(); return; }
        for (int plane = 0; plane < 1 + 2 * HasChroma; plane++) {
            int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
            int planeSz = plane_residual_size(MiSize, plane);
            int n4w = kNum4x4W[planeSz], n4h = kNum4x4H[planeSz];
            int baseX = (MiCol >> sx) * 4, baseY = (MiRow >> sy) * 4;
            int candRow = (MiRow >> sy) << sy, candCol = (MiCol >> sx) << sx;
            int predW = (bw4 * 4) >> sx, predH = (bh4 * 4) >> sy;
            int someUseIntra = 0;
            for (int r = 0; r < (n4h << sy); r++)
                for (int c = 0; c < (n4w << sx); c++)
                    if (refFrame0[mi(candRow + r, candCol + c)] == INTRA_FRAME) someUseIntra = 1;
            if (someUseIntra) { predW = n4w * 4; predH = n4h * 4; candRow = MiRow; candCol = MiCol; }
            else if (predW < n4w * 4 || predH < n4h * 4) census[C_CHROMA_SUB8X8]++;
            static thread_local uint16_t intra[32 * 32];
            int w = n4w * 4, h = n4h * 4;
            if (interintra) {
                // the intra prediction of the whole block from its edges, kept
                // while the inter prediction overwrites it
                static const int toIntra[4] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED};
                predict_intra(plane, baseX, baseY, plane ? AvailLChroma : AvailL, plane ? AvailUChroma : AvailU,
                              0, 0, toIntra[interintraMode], floor_log2(w), floor_log2(h));
                for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) intra[i * w + j] = frame[plane].get(baseY + i, baseX + j);
            }
            Plane& f = frame[plane];
            for (int y = 0, r = 0; y < h; y += predH, r++)
                for (int x = 0, c = 0; x < w; x += predW, c++)
                    predict_with(plane, baseX + x, baseY + y, predW, predH, mi(candRow + r, candCol + c),
                                 f.at(baseY + y, baseX + x), f.stride, motionMode == 2, false);
            if (interintra) {
                // libaom's smooth inter-intra masks: ii_weights1d by the row,
                // the column or the nearer edge, 32 for DC; or the block
                // size's wedge mask, averaged over 2 samples a side where the
                // plane is subsampled
                int scale = 128 / std::max(w, h);
                const uint8_t* wedge = wedgeInterintra ? wedge_mask() : nullptr;
                int lw = bw4 * 4, subw = 2 * bw4 == w, subh = 2 * bh4 == h;
                for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
                    int mk = wedge ? sub_mask(wedge, lw, i, j, subw, subh, 0)
                           : interintraMode == 0 ? 32 : interintraMode == 1 ? k_ii_weights1d[i * scale]
                           : interintraMode == 2 ? k_ii_weights1d[j * scale] : k_ii_weights1d[std::min(i, j) * scale];
                    uint16_t* d = frame[plane].at(baseY + i, baseX + j);
                    *d = (uint16_t)((mk * intra[i * w + j] + (64 - mk) * *d + 32) >> 6);
                }
            }
        }
        if (motionMode == 1) obmc();
    }

    // the block size's wedge mask (sign 0) of wedgeIndex, at luma size
    const uint8_t* wedge_mask() const {
        static const int sizes[9] = {BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32,
                                     BLOCK_32X16, BLOCK_32X32, BLOCK_8X32, BLOCK_32X8};
        size_t off = 0;
        for (int k = 0; k < 9 && sizes[k] != MiSize; k++) off += (size_t)16 * kNum4x4W[sizes[k]] * kNum4x4H[sizes[k]] * 16;
        return k_wedge_masks + off + (size_t)wedgeIndex * bw4 * bh4 * 16;
    }
    // a luma-size mask at a sample of a plane: averaged over 2 samples a
    // subsampled side, as libaom's blend_a64 functions; `flip` gives 64 - it
    static int sub_mask(const uint8_t* m, int lw, int i, int j, int subw, int subh, int flip) {
        const uint8_t* m0 = m + (size_t)(i << subh) * lw + (j << subw);
        int v0 = m0[0], v1 = subw ? m0[1] : 0, v2 = subh ? m0[lw] : 0, v3 = subw && subh ? m0[lw + 1] : 0;
        if (flip) { v0 = 64 - v0; v1 = 64 - v1; v2 = 64 - v2; v3 = 64 - v3; }
        if (subw && subh) return (v0 + v1 + v2 + v3 + 2) >> 2;
        if (subw) return (v0 + v1 + 1) >> 1;
        if (subh) return (v0 + v2 + 1) >> 1;
        return v0;
    }

    // compound prediction (7.11.3.1, 7.11.3.11-7.11.3.15) as libaom's
    // convolve, warp and blend_a64 functions compute it: each reference's
    // prediction rounded by 7 after the vertical filter, then averaged,
    // weighted by frame distance, or blended by a wedge mask or by the
    // difference of the two luma predictions (COMPOUND_DIFFWTD), rounded
    // and clipped
    void predict_compound() {
        static thread_local int32_t p0[128 * 128], p1[128 * 128];
        static thread_local uint8_t diffMask[128 * 128];
        int round0 = bitDepth == 12 ? 5 : 3, post = 14 - round0 - 7, maxv = (1 << bitDepth) - 1;
        size_t m = mi(MiRow, MiCol);
        int fwdW = 8, bckW = 8;
        if (compoundType == COMPOUND_DISTANCE) {
            // av1_dist_wtd_comp_weight_assign
            static const int weights[4][2] = {{2, 3}, {2, 5}, {2, 7}, {1, 31}};
            static const int lut[4][2] = {{9, 7}, {11, 5}, {12, 4}, {13, 3}};
            int d0 = clip3(0, 31, std::abs(relative_dist(refs[refFrameIdx[RefFrame1 - LAST_FRAME]].orderHint, orderHint)));
            int d1 = clip3(0, 31, std::abs(relative_dist(orderHint, refs[refFrameIdx[RefFrame0 - LAST_FRAME]].orderHint)));
            int order = d0 <= d1, i = 3;
            if (d0 && d1)
                for (i = 0; i < 3; i++) {
                    int c0 = weights[i][order], c1 = weights[i][!order];
                    if ((d0 > d1 && d0 * c0 < d1 * c1) || (d0 <= d1 && d0 * c0 > d1 * c1)) break;
                }
            fwdW = lut[i][order]; bckW = lut[i][1 - order];
        }
        int lw = bw4 * 4;
        const uint8_t* wedge = compoundType == COMPOUND_WEDGE ? wedge_mask() : nullptr;
        for (int plane = 0; plane < 1 + 2 * HasChroma; plane++) {
            int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
            int w = (bw4 * 4) >> sx, h = (bh4 * 4) >> sy;
            int x0 = (MiCol >> sx) * 4, y0 = (MiRow >> sy) * 4;
            predict_one(plane, x0, y0, w, h, m, 0, 7, false, false, p0);
            predict_one(plane, x0, y0, w, h, m, 1, 7, false, false, p1);
            if (compoundType == COMPOUND_DIFFWTD && plane == 0)
                for (int i = 0; i < w * h; i++) {
                    int diff = round2(std::abs(p0[i] - p1[i]), post + bitDepth - 8);
                    int mk = clip3(0, 64, 38 + diff / 16);
                    diffMask[i] = (uint8_t)(maskType ? 64 - mk : mk);
                }
            Plane& f = frame[plane];
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int k = i * w + j, v;
                    if (compoundType == COMPOUND_AVERAGE) v = (p0[k] + p1[k]) >> 1;
                    else if (compoundType == COMPOUND_DISTANCE) v = (p0[k] * fwdW + p1[k] * bckW) >> 4;
                    else {
                        int mk = wedge ? sub_mask(wedge, lw, i, j, sx, sy, wedgeSign) : sub_mask(diffMask, lw, i, j, sx, sy, 0);
                        v = (mk * p0[k] + (64 - mk) * p1[k]) >> 6;
                    }
                    *f.at(y0 + i, x0 + j) = (uint16_t)clip3(0, maxv, (v + (1 << (post - 1))) >> post);
                }
        }
    }

    // a single reference's prediction, rounded and clipped to samples
    void predict_with(int plane, int x, int y, int w, int h, size_t m, uint16_t* dst, int dstStride, bool local, bool obmcPass) {
        static thread_local int32_t tmp[128 * 128];
        int round1 = bitDepth == 12 ? 9 : 11, maxv = (1 << bitDepth) - 1;
        predict_one(plane, x, y, w, h, m, 0, round1, local, obmcPass, tmp);
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) dst[(size_t)r * dstStride + c] = (uint16_t)clip3(0, maxv, tmp[r * w + c]);
    }

    // motion vector scaling (7.11.3.3) and block inter prediction
    // (7.11.3.4) of list `list` of the block at mi m: positions in 1/1024
    // sample, a filter per direction (4-tap on a side of 4 or less), the
    // reference clamped to its edges, the vertical filter's sum rounded by
    // round1; a block of 8x8 or more in the plane is warped instead
    // (7.11.3.5) by its local warp, or by a global motion model of its
    // GLOBALMV mode (not for OBMC's neighbour predictions: libaom's
    // av1_allow_warp)
    void predict_one(int plane, int x, int y, int w, int h, size_t m, int list, int round1, bool local,
                     bool obmcPass, int32_t* out) {
        int refFrame = list ? refFrame1[m] : refFrame0[m];
        const RefSlot& ref = refs[refFrameIdx[refFrame - LAST_FRAME]];
        int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        int xScale = ((ref.upscaledWidth << 14) + (FrameWidth / 2)) / FrameWidth;
        int yScale = ((ref.frameHeight << 14) + (FrameHeight / 2)) / FrameHeight;
        int scaled = xScale != (1 << 14) || yScale != (1 << 14);
        if (scaled) census[C_SCALED_REF]++;
        const Plane& rp = ref.planes[plane];
        int lastX = ((ref.upscaledWidth + sx) >> sx) - 1, lastY = ((ref.frameHeight + sy) >> sy) - 1;
        if (w >= 8 && h >= 8 && !forceIntegerMv && !scaled && !obmcPass) {
            if (local && localValid) {
                int shear[4] = {warpAlpha, warpBeta, warpGamma, warpDelta};
                warp_block(rp, lastX, lastY, sx, sy, x, y, w, h, localWarp, shear, round1, out);
                return;
            }
            int bs = miSize[m];
            if ((yMode[m] == GLOBALMV || yMode[m] == GLOBAL_GLOBALMV) && gmType[refFrame] > TRANSLATION &&
                std::min(kNum4x4W[bs], kNum4x4H[bs]) >= 2 && gmValid[refFrame]) {
                if (plane == 0) census[C_GM_WARP]++;
                int64_t g[6];
                for (int i = 0; i < 6; i++) g[i] = gmParams[refFrame][i];
                warp_block(rp, lastX, lastY, sx, sy, x, y, w, h, g, gmShear[refFrame], round1, out);
                return;
            }
        }
        int mvr = list ? mvRow1[m] : mvRow[m], mvc = list ? mvCol1[m] : mvCol[m];
        int origX = (x << 4) + ((2 * mvc) >> sx) + 8;
        int origY = (y << 4) + ((2 * mvr) >> sy) + 8;
        int64_t baseX = (int64_t)origX * xScale - (8 << 14), baseY = (int64_t)origY * yScale - (8 << 14);
        int startX = (int)round2signed64(baseX, 8) + 32, startY = (int)round2signed64(baseY, 8) + 32;
        int stepX = (int)round2signed64(xScale, 4), stepY = (int)round2signed64(yScale, 4);
        int interH = (((h - 1) * stepY + (1 << 10) - 1) >> 10) + 8;
        int fv = filt0[m], fh = filt1[m];
        if (w <= 4) { if (fh == EIGHTTAP || fh == EIGHTTAP_SHARP) fh = 4; else if (fh == EIGHTTAP_SMOOTH) fh = 5; }
        if (h <= 4) { if (fv == EIGHTTAP || fv == EIGHTTAP_SHARP) fv = 4; else if (fv == EIGHTTAP_SMOOTH) fv = 5; }
        int round0 = bitDepth == 12 ? 5 : 3;
        static thread_local int32_t inter[(128 * 2 + 16) * 128];
        for (int r = 0; r < interH; r++) {
            int yy = clip3(0, lastY, (startY >> 10) + r - 3);
            const uint16_t* row = &rp.px[(size_t)yy * rp.stride];
            for (int c = 0; c < w; c++) {
                int p = startX + stepX * c;
                const int16_t* fk = k_subpel_filters[fh][(p >> 6) & 15];
                int sum = 0;
                for (int t = 0; t < 8; t++) sum += fk[t] * row[clip3(0, lastX, (p >> 10) + t - 3)];
                inter[r * w + c] = (sum + (1 << (round0 - 1))) >> round0;   // Round2 of a signed sum
            }
        }
        for (int r = 0; r < h; r++) {
            int p = (startY & 1023) + stepY * r;
            const int16_t* fk = k_subpel_filters[fv][(p >> 6) & 15];
            for (int c = 0; c < w; c++) {
                int sum = 0;
                for (int t = 0; t < 8; t++) sum += fk[t] * inter[((p >> 10) + t) * w + c];
                out[r * w + c] = (sum + (1 << (round1 - 1))) >> round1;
            }
        }
    }

    // libaom's av1_highbd_warp_affine_c (the 8-bit one computes the same)
    // of the model `mat` with its shear, the vertical sum rounded by round1
    // (2 * 7 - the horizontal rounding, or 7 into a compound prediction)
    void warp_block(const Plane& rp, int lastX, int lastY, int sx, int sy, int x, int y, int w, int h,
                    const int64_t* mat, const int* shear, int round1, int32_t* out) {
        int round0 = bitDepth == 12 ? 5 : 3;
        int rbh = round0 + std::max(bitDepth + 7 - round0 - 14, 0);
        int offH = bitDepth + 6, offV = bitDepth + 14 - rbh;
        int offset = (1 << (offV - round1)) + (1 << (offV - 1 - round1));
        int alpha = shear[0], beta = shear[1], gamma = shear[2], delta = shear[3];
        int32_t tmp[15 * 8];
        for (int i = y; i < y + h; i += 8)
            for (int j = x; j < x + w; j += 8) {
                int32_t srcX = (j + 4) << sx, srcY = (i + 4) << sy;
                int64_t dstX = mat[2] * srcX + mat[3] * srcY + mat[0];
                int64_t dstY = mat[4] * srcX + mat[5] * srcY + mat[1];
                int64_t x4 = dstX >> sx, y4 = dstY >> sy;
                int ix4 = (int)(x4 >> 16), iy4 = (int)(y4 >> 16);
                int sx4 = (int)(x4 & 0xFFFF), sy4 = (int)(y4 & 0xFFFF);
                sx4 += alpha * -4 + beta * -4;
                sy4 += gamma * -4 + delta * -4;
                sx4 &= ~63; sy4 &= ~63;
                for (int k = -7; k < 8; k++) {
                    int iy = clip3(0, lastY, iy4 + k);
                    const uint16_t* row = &rp.px[(size_t)iy * rp.stride];
                    int sxk = sx4 + beta * (k + 4);
                    for (int l = -4; l < 4; l++, sxk += alpha) {
                        int offs = ((sxk + (1 << 9)) >> 10) + 64;
                        const int16_t* co = k_warped_filter[offs];
                        int32_t sum = 1 << offH;
                        for (int mm = 0; mm < 8; mm++) sum += row[clip3(0, lastX, ix4 + l - 3 + mm)] * co[mm];
                        tmp[(k + 7) * 8 + (l + 4)] = (sum + (1 << (rbh - 1))) >> rbh;
                    }
                }
                for (int k = -4; k < std::min(4, y + h - i - 4); k++) {
                    int syk = sy4 + delta * (k + 4);
                    for (int l = -4; l < std::min(4, x + w - j - 4); l++, syk += gamma) {
                        int offs = ((syk + (1 << 9)) >> 10) + 64;
                        const int16_t* co = k_warped_filter[offs];
                        int32_t sum = 1 << offV;
                        for (int mm = 0; mm < 8; mm++) sum += tmp[(k + mm + 4) * 8 + (l + 4)] * co[mm];
                        sum = (sum + (1 << (round1 - 1))) >> round1;
                        out[(size_t)(i - y + k + 4) * w + (j - x + l + 4)] = sum - offset;
                    }
                }
            }
    }

    // overlapped block motion compensation (7.11.3.10), as libaom's
    // dec_build_obmc_inter_predictors_sb: the top and left strips of the
    // block predicted again with the motion of each inter neighbour above
    // (then to the left) and blended in
    void obmc() {
        static const int maxNb[6] = {0, 1, 2, 3, 4, 4};
        static thread_local uint16_t tmp[64 * 128];
        for (int dir = 0; dir < 2; dir++) {
            if (dir == 0 ? !AvailU : !AvailL) continue;
            int count = 0, limit = maxNb[dir == 0 ? kMiWLog2[MiSize] : kMiHLog2[MiSize]];
            int end = dir == 0 ? std::min(MiCol + bw4, MiCols) : std::min(MiRow + bh4, MiRows);
            for (int pos = dir == 0 ? MiCol : MiRow, step = 0; pos < end && count < limit; pos += step) {
                size_t m = dir == 0 ? mi(MiRow - 1, pos) : mi(pos, MiCol - 1);
                step = std::min(dir == 0 ? kNum4x4W[miSize[m]] : kNum4x4H[miSize[m]], 16);
                if (step == 1) {
                    pos &= ~1;
                    m = dir == 0 ? mi(MiRow - 1, pos + 1) : mi(pos + 1, MiCol - 1);
                    step = 2;
                }
                if (refFrame0[m] <= INTRA_FRAME) continue;
                count++;
                int size4 = std::min(dir == 0 ? bw4 : bh4, (int)step);
                for (int plane = 0; plane < numPlanes; plane++) {
                    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
                    int psz = plane_residual_size(MiSize, plane);
                    if (dir == 0 && (psz == BLOCK_4X4 || psz == BLOCK_8X4 || psz == BLOCK_4X8)) continue;
                    int x = (MiCol * 4) >> sx, y = (MiRow * 4) >> sy;
                    int w, h, bw, bh;
                    if (dir == 0) {
                        x += ((pos - MiCol) * 4) >> sx;
                        w = bw = (size4 * 4) >> sx;
                        h = clip3(4, 64 >> (sy + 1), (bh4 * 4) >> (sy + 1));
                        bh = (std::min(bh4 * 4, 64) >> 1) >> sy;
                    } else {
                        y += ((pos - MiRow) * 4) >> sy;
                        h = bh = (size4 * 4) >> sy;
                        w = clip3(4, 64 >> (sx + 1), (bw4 * 4) >> (sx + 1));
                        bw = (std::min(bw4 * 4, 64) >> 1) >> sx;
                    }
                    predict_with(plane, x, y, w, h, m, tmp, w, false, true);
                    const uint8_t* mask = k_obmc_masks + (dir == 0 ? bh : bw) - 1;
                    Plane& f = frame[plane];
                    for (int i = 0; i < bh; i++)
                        for (int j = 0; j < bw; j++) {
                            int mk = dir == 0 ? mask[i] : mask[j];
                            uint16_t* d = f.at(y + i, x + j);
                            *d = (uint16_t)((mk * *d + (64 - mk) * tmp[i * w + j] + 32) >> 6);
                        }
                }
            }
        }
    }

    // ---- prediction (7.11.2)
    int is_smooth(int row, int col, int plane) const {
        int mode = plane == 0 ? yMode[mi(row, col)] : uvMode[mi(row, col)];
        if (plane && isInter[mi(row, col)]) return 0;
        return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
    }
    int get_filter_type(int plane) const {
        int aboveSmooth = 0, leftSmooth = 0;
        if (plane == 0 ? AvailU : AvailUChroma) {
            int r = MiRow - 1, c = MiCol;
            if (plane > 0) { if (ssx && !(MiCol & 1)) c++; if (ssy && (MiRow & 1)) r--; }
            aboveSmooth = is_smooth(r, c, plane);
        }
        if (plane == 0 ? AvailL : AvailLChroma) {
            int r = MiRow, c = MiCol - 1;
            if (plane > 0) { if (ssx && (MiCol & 1)) c--; if (ssy && !(MiRow & 1)) r++; }
            leftSmooth = is_smooth(r, c, plane);
        }
        return aboveSmooth || leftSmooth;
    }

    void predict_intra(int plane, int x, int y, int haveLeft, int haveAbove, int haveAboveRt,
                       int haveBelowLt, int mode, int log2W, int log2H) {
        Plane& f = frame[plane];
        int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        int edge = enIntraEdge && is_directional(mode) ? get_filter_type(plane) : -1;
        av1::predict_intra(f.px.data(), f.stride, x, y, ((MiCols * 4) >> sx) - 1, ((MiRows * 4) >> sy) - 1,
                           bitDepth, haveLeft, haveAbove, haveAboveRt, haveBelowLt, mode,
                           plane == 0 ? AngleDeltaY : AngleDeltaUV, log2W, log2H, edge,
                           plane == 0 && use_filter_intra ? filter_intra_mode : -1);
    }

    void predict_cfl(int plane, int startX, int startY, int txSz) {
        int w = kTxW[txSz], h = kTxH[txSz];
        int sx = ssx, sy = ssy;
        int alpha = plane == 1 ? CflAlphaU : CflAlphaV;
        static thread_local int L[32][32];
        int sum = 0;
        Plane& luma = frame[0];
        for (int i = 0; i < h; i++) {
            int lumaY = std::min(startY + i, (MaxLumaH >> sy) - 1) << sy;
            for (int j = 0; j < w; j++) {
                int lumaX = std::min(startX + j, (MaxLumaW >> sx) - 1) << sx;
                int t = 0;
                for (int dy = 0; dy <= sy; dy++) for (int dx = 0; dx <= sx; dx++) t += luma.get(lumaY + dy, lumaX + dx);
                int v = t << (3 - sx - sy);
                L[i][j] = v; sum += v;
            }
        }
        int avg = round2(sum, floor_log2(w) + floor_log2(h));
        Plane& f = frame[plane];
        int maxv = (1 << bitDepth) - 1;
        for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
            uint16_t* p = f.at(startY + i, startX + j);
            int scaled = round2signed(alpha * (L[i][j] - avg), 6);
            *p = (uint16_t)clip3(0, maxv, *p + scaled);
        }
    }

    void predict_palette(int plane, int startX, int startY, int x, int y, int txSz) {
        int w = kTxW[txSz], h = kTxH[txSz];
        const uint16_t* pal = paletteColors[plane];
        uint8_t (*map)[128] = plane ? colorMapUV : colorMapY;
        Plane& f = frame[plane];
        for (int i = 0; i < h; i++) for (int j = 0; j < w; j++)
            *f.at(startY + i, startX + j) = pal[map[y * 4 + i][x * 4 + j]];
    }

    // ================================================================ in-loop filters
    void loop_filter() {
        if (!lfLevel[0] && !lfLevel[1]) return;
        census[C_DEBLOCK]++;
        for (int plane = 0; plane < numPlanes; plane++) {
            if (plane > 0 && !lfLevel[1 + plane]) continue;
            int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
            for (int pass = 0; pass < 2; pass++) {
                int rowStep = plane == 0 ? 1 : (1 << sy), colStep = plane == 0 ? 1 : (1 << sx);
                for (int row = 0; row < MiRows; row += rowStep)
                    for (int col = 0; col < MiCols; col += colStep) edge_loop_filter(plane, pass, row, col, sx, sy);
            }
        }
    }

    int filter_level(int row, int col, int plane, int pass) const {
        size_t m = mi(row, col);
        int seg = segId[m];
        int i = plane == 0 ? pass : plane + 1;
        int deltaLf = deltaLfMulti ? deltaLFs[m * 4 + i] : deltaLFs[m * 4];
        if (!deltaLfPresent) deltaLf = 0;
        int lvl = clip3(0, 63, deltaLf + lfLevel[i]);
        if (segEnabled && featEn[seg][1 + i]) lvl = clip3(0, 63, lvl + featData[seg][1 + i]);
        if (lfDeltaEnabled) {
            int nShift = lvl >> 5, ref = refFrame0[m];
            if (ref == INTRA_FRAME) lvl += lfRefDeltas[INTRA_FRAME] * (1 << nShift);
            else lvl += lfRefDeltas[ref] * (1 << nShift) + lfModeDeltas[k_mode_lf_lut[yMode[m]]] * (1 << nShift);
            lvl = clip3(0, 63, lvl);
        }
        return lvl;
    }

    void edge_loop_filter(int plane, int pass, int row, int col, int sx, int sy) {
        int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
        int x = col * 4, y = row * 4;
        row |= sy; col |= sx;
        int onScreen;
        if (x >= FrameWidth) onScreen = 0;
        else if (y >= FrameHeight) onScreen = 0;
        else if (pass == 0 && x == 0) onScreen = 0;
        else if (pass == 1 && y == 0) onScreen = 0;
        else onScreen = 1;
        if (!onScreen) return;
        int xP = x >> sx, yP = y >> sy;
        int prevRow = row - (dy << sy), prevCol = col - (dx << sx);
        int txSz = lfTx[plane][mi(row >> sy, col >> sx)];
        int prevTxSz = lfTx[plane][mi(prevRow >> sy, prevCol >> sx)];
        // every transform edge, but one between two skipped inter blocks
        // only on the current block's edge (a frame with intra block copy is
        // never deblocked)
        int applyFilter = pass == 0 ? (xP % kTxW[txSz] == 0) : (yP % kTxH[txSz] == 0);
        size_t m = mi(row, col), mPrev = mi(prevRow, prevCol);
        if (applyFilter && skip[m] && isInter[m] && skip[mPrev] && isInter[mPrev]) {
            int bsz = plane_residual_size(miSize[m], plane);
            applyFilter = pass == 0 ? (xP % (kNum4x4W[bsz] * 4) == 0) : (yP % (kNum4x4H[bsz] * 4) == 0);
        }
        int baseSize = pass == 0 ? std::min(kTxW[prevTxSz], kTxW[txSz]) : std::min(kTxH[prevTxSz], kTxH[txSz]);
        int filterSize = plane == 0 ? std::min(16, baseSize) : std::min(8, baseSize);
        int lvl = filter_level(row, col, plane, pass);
        if (lvl == 0) lvl = filter_level(prevRow, prevCol, plane, pass);
        if (!applyFilter || lvl == 0) return;
        int shift = lfSharp > 4 ? 2 : (lfSharp > 0 ? 1 : 0);
        int limit = lfSharp > 0 ? clip3(1, 9 - lfSharp, lvl >> shift) : std::max(1, lvl >> shift);
        LfParams lp{limit, 2 * (lvl + 2) + limit, lvl >> 4};
        int size = filterSize == 4 ? 4 : filterSize == 8 ? (plane == 0 ? 8 : 6) : 14;
        Plane& f = frame[plane];
        int step = pass == 0 ? 1 : f.stride;
        for (int i = 0; i < 4; i++) {
            uint16_t* s = f.at(yP + dx * i, xP + dy * i);
            lf_sample(s, step, size, lp, bitDepth);
        }
    }

    void cdef() {
        for (int p = 0; p < numPlanes; p++) cdefFrame[p] = frame[p];
        if (codedLossless || allowIntrabc || !enCdef) return;
        int coeffShift = bitDepth - 8;
        for (int fbr = 0; fbr < MiRows; fbr += 16)
            for (int fbc = 0; fbc < MiCols; fbc += 16) {
                int idx = cdefIdx[(size_t)(fbr >> 4) * cdefStride + (fbc >> 4)];
                if (idx == -1) continue;
                for (int r = fbr; r < std::min(fbr + 16, MiRows); r += 2)
                    for (int c = fbc; c < std::min(fbc + 16, MiCols); c += 2) {
                        int sk = skip[mi(r, c)] && skip[mi(r + 1, c)] && skip[mi(r, c + 1)] && skip[mi(r + 1, c + 1)];
                        if (sk) continue;
                        int yDir, var;
                        cdef_direction(frame[0].at(r * 4, c * 4), frame[0].stride, bitDepth, &yDir, &var);
                        int priStr = cdefYPri[idx] << coeffShift, secStr = cdefYSec[idx] << coeffShift;
                        int dir = priStr == 0 ? 0 : yDir;
                        int varStr = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
                        priStr = var ? (priStr * (4 + varStr) + 8) >> 4 : 0;
                        int damping = cdefDamping + coeffShift;
                        if (cdefYPri[idx] || cdefYSec[idx]) census[C_CDEF]++;
                        cdef_filter(0, r, c, priStr, secStr, damping, dir);
                        if (numPlanes == 1) continue;
                        priStr = cdefUvPri[idx] << coeffShift; secStr = cdefUvSec[idx] << coeffShift;
                        dir = priStr == 0 ? 0 : kCdefUvDir[ssx][ssy][yDir];
                        damping = cdefDamping + coeffShift - 1;
                        cdef_filter(1, r, c, priStr, secStr, damping, dir);
                        cdef_filter(2, r, c, priStr, secStr, damping, dir);
                    }
            }
    }

    void cdef_filter(int plane, int r, int c, int priStr, int secStr, int damping, int dir) {
        if (!priStr && !secStr) return;
        int coeffShift = bitDepth - 8;
        int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
        int w = 8 >> sx, h = 8 >> sy;
        const Plane& src = frame[plane];
        Plane& dst = cdefFrame[plane];
        static const int priTaps[2][2] = {{4, 2}, {3, 3}}, secTaps[2][2] = {{2, 1}, {2, 1}};
        auto avail = [&](int y, int x) {
            int cr = (y << sy) >> 2, cc = (x << sx) >> 2;
            return y >= 0 && x >= 0 && cr < MiRows && cc < MiCols;
        };
        int tapSet = (priStr >> coeffShift) & 1;
        for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
            int x = src.get(y0 + i, x0 + j);
            int sum = 0, mx = x, mn = x;
            for (int k = 0; k < 2; k++)
                for (int sign = -1; sign <= 1; sign += 2) {
                    int yy = y0 + i + sign * kCdefDirections[dir][k][0], xx = x0 + j + sign * kCdefDirections[dir][k][1];
                    if (avail(yy, xx)) {
                        int p = src.get(yy, xx);
                        sum += priTaps[tapSet][k] * cdef_constrain(p - x, priStr, damping);
                        mx = std::max(p, mx); mn = std::min(p, mn);
                    }
                    for (int off = -2; off <= 2; off += 4) {
                        int d2 = (dir + off) & 7;
                        int y2 = y0 + i + sign * kCdefDirections[d2][k][0], x2 = x0 + j + sign * kCdefDirections[d2][k][1];
                        if (avail(y2, x2)) {
                            int s = src.get(y2, x2);
                            sum += secTaps[tapSet][k] * cdef_constrain(s - x, secStr, damping);
                            mx = std::max(s, mx); mn = std::min(s, mn);
                        }
                    }
                }
            *dst.at(y0 + i, x0 + j) = (uint16_t)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
        }
    }

    // loop restoration (7.17)
    int stripeStartY = 0, stripeEndY = 0, planeEndX = 0, planeEndY = 0;

    int source_sample(int plane, int x, int y) const {
        x = std::max(0, std::min(planeEndX, x));
        y = std::max(0, std::min(planeEndY, y));
        if (y < stripeStartY) { y = std::max(stripeStartY - 2, y); return frame[plane].get(y, x); }
        if (y > stripeEndY) { y = std::min(stripeEndY + 2, y); return frame[plane].get(y, x); }
        return cdefFrame[plane].get(y, x);
    }

    void loop_restoration() {
        if (!usesLr) { for (int p = 0; p < numPlanes; p++) lrFrame[p] = cdefFrame[p]; return; }
        for (int p = 0; p < numPlanes; p++) lrFrame[p] = cdefFrame[p];
        for (int y = 0; y < FrameHeight; y += 4)
            for (int x = 0; x < UpscaledWidth; x += 4)
                for (int p = 0; p < numPlanes; p++)
                    if (frameRestType[p] != RESTORE_NONE) lr_block(p, y >> 2, x >> 2);
    }

    void lr_block(int plane, int row, int col) {
        int lumaY = row * 4;
        int stripeNum = (lumaY + 8) / 64;
        int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        stripeStartY = (-8 + stripeNum * 64) >> sy;
        stripeEndY = stripeStartY + (64 >> sy) - 1;
        int unitSize = lrSize[plane];
        int unitRows = lrUnitRows[plane], unitCols = lrUnitCols[plane];
        int unitRow = std::min(unitRows - 1, ((row * 4 + 8) >> sy) / unitSize);
        int unitCol = std::min(unitCols - 1, ((col * 4) >> sx) / unitSize);
        planeEndX = round2(UpscaledWidth, sx) - 1;
        planeEndY = round2(FrameHeight, sy) - 1;
        int x = (col * 4) >> sx, y = (row * 4) >> sy;
        if (x > planeEndX || y > planeEndY) return;
        // subsampled chroma: a 4x4 block per 2x2 luma 4x4s, visited once
        if ((sx && (col & 1)) || (sy && (row & 1))) return;
        int w = std::min(4, planeEndX - x + 1), h = std::min(4, planeEndY - y + 1);
        size_t u = (size_t)unitRow * unitCols + unitCol;
        int rType = lrType[plane][u];
        if (rType == RESTORE_WIENER) wiener_filter(plane, u, x, y, w, h);
        else if (rType == RESTORE_SGRPROJ) sgr_filter(plane, u, x, y, w, h);
    }

    void wiener_filter(int plane, size_t u, int x, int y, int w, int h) {
        int round0 = bitDepth == 12 ? 5 : 3, round1 = bitDepth == 12 ? 9 : 11;
        int vf[7], hf[7];
        const int16_t* co = &lrWiener[plane][u * 6];
        auto mk = [](const int16_t* c, int* f) {
            f[3] = 128;
            for (int i = 0; i < 3; i++) { f[i] = c[i]; f[6 - i] = c[i]; f[3] -= 2 * c[i]; }
        };
        mk(co, vf); mk(co + 3, hf);
        int offset = 1 << (bitDepth + 7 - round0 - 1);
        int limit = (1 << (bitDepth + 1 + 7 - round0)) - 1;
        int inter[10][4];
        for (int r = 0; r < h + 6; r++) for (int c = 0; c < w; c++) {
            int s = 0;
            for (int t = 0; t < 7; t++) s += hf[t] * source_sample(plane, x + c + t - 3, y + r - 3);
            int v = round2(s, round0);
            inter[r][c] = clip3(-offset, limit - offset, v);
        }
        int maxv = (1 << bitDepth) - 1;
        for (int r = 0; r < h; r++) for (int c = 0; c < w; c++) {
            int s = 0;
            for (int t = 0; t < 7; t++) s += vf[t] * inter[r + t][c];
            *lrFrame[plane].at(y + r, x + c) = (uint16_t)clip3(0, maxv, round2(s, round1));
        }
    }

    void box_filter(int plane, int x, int y, int w, int h, int set, int pass, int32_t F[4][4]) {
        int r = k_sgr_params[set][pass];
        uint32_t s = (uint32_t)k_sgr_params[set][2 + pass];
        int n = (2 * r + 1) * (2 * r + 1);
        uint32_t A[6][6], B[6][6];
        for (int i = -1; i < h + 1; i++) for (int j = -1; j < w + 1; j++) {
            uint32_t a = 0, b = 0;
            for (int dy = -r; dy <= r; dy++) for (int dx = -r; dx <= r; dx++) {
                uint32_t c = (uint32_t)source_sample(plane, x + j + dx, y + i + dy);
                a += c * c; b += c;
            }
            a = (uint32_t)round2_64(a, 2 * (bitDepth - 8));
            uint32_t d = (uint32_t)round2_64(b, bitDepth - 8);
            uint32_t p = (a * n < d * d) ? 0 : a * n - d * d;
            // uint32 arithmetic throughout, wrapping as libaom's
            uint32_t z = (p * s + (1u << 19)) >> 20;
            uint32_t a2 = (uint32_t)k_x_by_xplus1[std::min<uint32_t>(z, 255)];
            uint32_t b2 = ((256 - a2) * b * (uint32_t)k_one_by_x[n - 1] + (1u << 11)) >> 12;
            A[i + 1][j + 1] = a2; B[i + 1][j + 1] = b2;
        }
        for (int i = 0; i < h; i++) {
            int shift = 5;
            if (pass == 0 && (i & 1)) shift = 4;
            for (int j = 0; j < w; j++) {
                int32_t a = 0, b = 0;
                for (int dy = -1; dy <= 1; dy++) for (int dx = -1; dx <= 1; dx++) {
                    int weight;
                    if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                    else weight = (dx == 0 || dy == 0) ? 4 : 3;
                    a += weight * (int32_t)A[i + dy + 1][j + dx + 1];
                    b += weight * (int32_t)B[i + dy + 1][j + dx + 1];
                }
                int32_t v = a * (int32_t)cdefFrame[plane].get(y + i, x + j) + b;
                F[i][j] = (int32_t)round2_64(v, 8 + shift - 4);
            }
        }
    }

    void sgr_filter(int plane, size_t u, int x, int y, int w, int h) {
        int set = lrSgr[plane][u * 3];
        int xqd0 = lrSgr[plane][u * 3 + 1], xqd1 = lrSgr[plane][u * 3 + 2];
        int r0 = k_sgr_params[set][0], r1 = k_sgr_params[set][1];
        int xq0, xq1;
        if (r0 == 0) { xq0 = 0; xq1 = (1 << 7) - xqd1; }
        else if (r1 == 0) { xq0 = xqd0; xq1 = 0; }
        else { xq0 = xqd0; xq1 = (1 << 7) - xqd0 - xqd1; }
        int32_t f0[4][4], f1[4][4];
        if (r0) box_filter(plane, x, y, w, h, set, 0, f0);
        if (r1) box_filter(plane, x, y, w, h, set, 1, f1);
        int maxv = (1 << bitDepth) - 1;
        for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) {
            int32_t uu = (int32_t)cdefFrame[plane].get(y + i, x + j) << 4;
            int32_t v = uu << 7;
            if (r0) v += xq0 * (f0[i][j] - uu);
            if (r1) v += xq1 * (f1[i][j] - uu);
            int s = (int)round2_64(v, 11);
            *lrFrame[plane].at(y + i, x + j) = (uint16_t)clip3(0, maxv, s);
        }
    }

    // ================================================================ OBUs
    void tile_group(const uint8_t* d, size_t sz) {
        Bits b{d, sz};
        int numTiles = tileCols * tileRows;
        int tgStart = 0, tgEnd = numTiles - 1;
        if (numTiles > 1 && b.f(1)) {
            int bits = tileColsLog2 + tileRowsLog2;
            tgStart = b.f(bits); tgEnd = b.f(bits);
        }
        b.align();
        size_t pos = b.pos >> 3;
        census[C_TILES] = numTiles;
        for (int t = tgStart; t <= tgEnd; t++) {
            int tileRow = t / tileCols, tileCol = t % tileCols;
            size_t tileSize;
            if (t == tgEnd) {
                if (pos > sz) throw (int)ERR_BITSTREAM;
                tileSize = sz - pos;
            } else {
                if (pos + tileSizeBytes > sz) throw (int)ERR_BITSTREAM;
                tileSize = 0;
                for (int i = 0; i < tileSizeBytes; i++) tileSize |= (size_t)d[pos + i] << (8 * i);
                tileSize += 1; pos += tileSizeBytes;
            }
            if (pos + tileSize > sz) throw (int)ERR_BITSTREAM;
            MiRowStart = miRowStarts[tileRow]; MiRowEnd = miRowStarts[tileRow + 1];
            MiColStart = miColStarts[tileCol]; MiColEnd = miColStarts[tileCol + 1];
            currentQIndex = baseQ;
            cdf = frameCdf;
            memcpy(ndvc, k_nmv_cdf, sizeof(ndvc));
            sd.init(d + pos, tileSize, disableCdfUpdate);
            decode_tile();
            if (t == contextUpdateTileId) { savedCdf = cdf; savedCdf.reset_counters(); }
            pos += tileSize;
        }
        if (tgEnd == numTiles - 1) tilesDone = 1;
    }

    static size_t leb128(const uint8_t* d, size_t n, size_t& pos) {
        size_t v = 0;
        for (int i = 0; i < 8; i++) {
            if (pos >= n) throw (int)ERR_BITSTREAM;
            uint8_t byte = d[pos++];
            v |= (size_t)(byte & 0x7f) << (7 * i);
            if (!(byte & 0x80)) return v;
        }
        throw (int)ERR_BITSTREAM;
    }

    // Parse the OBUs of operating point `op`: with decode == false, up to
    // the first frame header; otherwise every frame, each decoded, filtered
    // and kept in the reference slots it refreshes. A shown frame becomes
    // the output (the last one, as libaom hands libavif one frame per
    // temporal unit; or the first of spatial layer `layer` when it is not
    // -1, as libavif picks an `lsel` layer among all of them).
    int op = 0, layer = -1, frames = 0, spatialId = 0, outSpatialId = -1;
    Plane out[3];
    int outW = 0, outH = 0;
    void run(const uint8_t* d, size_t n, bool decode) {
        size_t pos = 0;
        while (pos < n) {
            uint8_t h = d[pos++];
            if (h & 0x80) throw (int)ERR_BITSTREAM;
            int type = (h >> 3) & 15, ext = (h >> 2) & 1, hasSize = (h >> 1) & 1;
            int temporalId = 0, sid = 0;
            if (ext) {
                if (pos >= n) throw (int)ERR_BITSTREAM;
                temporalId = d[pos] >> 5; sid = (d[pos] >> 3) & 3; pos++;
            }
            size_t sz = hasSize ? leb128(d, n, pos) : n - pos;
            if (pos + sz > n) throw (int)ERR_BITSTREAM;
            const uint8_t* p = d + pos;
            pos += sz;
            if (type == 1) { Bits b{p, sz}; sequence_header(b); continue; }
            if (type == 8) throw (int)ERR_LARGE_SCALE_TILE;
            if (type != 3 && type != 4 && type != 6) continue;
            if (!seqSeen) throw (int)ERR_BITSTREAM;
            int idc = opIdc[op < opCount ? op : 0];   // libaom takes 0 for a point the stream lacks
            if (ext && idc && !(((idc >> temporalId) & 1) && ((idc >> (sid + 8)) & 1))) continue;
            if (type == 3 || type == 6) {
                if (headerDone) {
                    if (type == 3) continue;        // a copy of the header
                    throw (int)ERR_BITSTREAM;
                }
                Bits b{p, sz};
                spatialId = sid;
                frame_header(b, temporalId, sid);
                if (showExistingFrame) {
                    if (type == 6) throw (int)ERR_BITSTREAM;   // a frame OBU shows no existing frame
                    if (decode) show_existing();
                    continue;
                }
                if (!decode) return;
                alloc();
                if (type == 6) {
                    b.align();
                    size_t off = b.pos >> 3;
                    tile_group(p + off, sz - off);
                }
            } else {
                if (!headerDone) throw (int)ERR_BITSTREAM;
                tile_group(p, sz);
            }
            if (tilesDone) { finish_frame(); headerDone = tilesDone = 0; }
        }
        if (headerDone) throw (int)ERR_BITSTREAM;   // a frame without all its tiles
    }

    void finish_frame() {
        if (!disableFrameEndUpdateCdf) frameCdf = savedCdf;
        if (!frameIsIntra) {
            census[C_INTER_DEBLOCK] += lfLevel[0] || lfLevel[1];
            census[C_INTER_CDEF] += enCdef && !codedLossless && (cdefBits || cdefYPri[0] || cdefYSec[0] || cdefUvPri[0] || cdefUvSec[0]);
            census[C_INTER_LR] += usesLr;
            census[C_SUPERRES_INTER] += UpscaledWidth != FrameWidth;
            census[C_GRAIN_INTER] += grain.apply;
        }
        census[C_SEGMENTATION] += segEnabled;
        census[C_DELTA_Q] += deltaQPresent;
        census[C_DELTA_LF] += deltaLfPresent;
        census[C_SB128] = sb128;
        if (frameRestType[0] == RESTORE_SWITCHABLE || frameRestType[1] == RESTORE_SWITCHABLE ||
            frameRestType[2] == RESTORE_SWITCHABLE) census[C_LR_SWITCHABLE] = 1;
        post_filters();
        // SegmentIds as saved: the block's ids, the previous map where this
        // frame kept it (update_map 0), or none
        std::vector<uint8_t> segIds((size_t)MiRows * MiCols, 0);
        if (segEnabled)
            for (int r = 0; r < MiRows; r++)
                for (int c = 0; c < MiCols; c++) {
                    size_t k = (size_t)r * MiCols + c;
                    segIds[k] = segUpdateMap ? segId[mi(r, c)] : prevSegIds.empty() ? 0 : prevSegIds[k];
                }
        // the motion field motion vectors of this frame (7.19): per 8x8, its
        // last mi's vector where it points back in order and is short enough
        int rows8 = (MiRows + 1) >> 1, cols8 = (MiCols + 1) >> 1;
        std::vector<int8_t> mfRef((size_t)rows8 * cols8, -1);
        std::vector<int16_t> mfMv((size_t)2 * rows8 * cols8, 0);
        if (!frameIsIntra)
            for (int r8 = 0; r8 < rows8; r8++)
                for (int c8 = 0; c8 < cols8; c8++) {
                    size_t m = mi(2 * r8 + 1, 2 * c8 + 1), k = (size_t)r8 * cols8 + c8;
                    for (int list = 0; list < 2; list++) {   // the second list's vector wins
                        int ref = list ? refFrame1[m] : refFrame0[m];
                        int mr = list ? mvRow1[m] : mvRow[m], mc = list ? mvCol1[m] : mvCol[m];
                        if (ref <= INTRA_FRAME || relative_dist(orderHints[ref], orderHint) >= 0) continue;
                        if (std::abs(mr) > 4095 || std::abs(mc) > 4095) continue;
                        mfRef[k] = (int8_t)ref; mfMv[2 * k] = (int16_t)mr; mfMv[2 * k + 1] = (int16_t)mc;
                    }
                }
        for (int i = 0; i < 8; i++) {
            if (!((refreshFlags >> i) & 1)) continue;
            RefSlot& r = refs[i];
            r.valid = true; r.frameType = frameType; r.orderHint = orderHint;
            memcpy(r.savedOrderHints, orderHints, sizeof(orderHints));
            r.frameWidth = FrameWidth; r.frameHeight = FrameHeight; r.upscaledWidth = UpscaledWidth;
            r.renderWidth = RenderWidth; r.renderHeight = RenderHeight;
            r.miCols = MiCols; r.miRows = MiRows; r.bitDepth = bitDepth; r.ssx = ssx; r.ssy = ssy; r.mono = mono;
            for (int p = 0; p < numPlanes; p++) r.planes[p] = lrFrame[p];
            r.cdf = frameCdf;
            memcpy(r.lfRefDeltas, lfRefDeltas, sizeof(lfRefDeltas));
            memcpy(r.lfModeDeltas, lfModeDeltas, sizeof(lfModeDeltas));
            memcpy(r.featEn, featEn, sizeof(featEn)); memcpy(r.featData, featData, sizeof(featData));
            r.grain = grain;
            r.mfRef = mfRef; r.mfMv = mfMv;
            r.showable = showableFrame;
            memcpy(r.gm, gmParams, sizeof(r.gm));
            r.segIds = segIds;
        }
        frames++;
        if (showFrame) output(lrFrame, UpscaledWidth, FrameHeight, grain);
    }

    // show_existing_frame (7.21): the slot's frame is the output, with its
    // film grain; a key frame shown so also becomes every slot (the
    // reference frame update process with all slots refreshed)
    void show_existing() {
        census[C_SHOW_EXISTING]++;
        RefSlot& r = refs[frameToShow];
        if (r.frameType == KEY_FRAME) {
            census[C_SHOW_EXISTING_KEY]++;
            r.showable = 0;
            for (int i = 0; i < 8; i++) if (i != frameToShow) refs[i] = r;
        }
        output(r.planes, r.upscaledWidth, r.frameHeight, r.grain);
    }

    void output(const Plane* planes, int w, int h, const FilmGrain& g) {
        if (layer >= 0 && (outSpatialId == layer || spatialId != layer)) return;
        outSpatialId = spatialId;
        outW = w; outH = h;
        for (int p = 0; p < numPlanes; p++) out[p] = planes[p];
        if (g.apply) {
            census[C_FILM_GRAIN]++;
            uint16_t* px[3] = {nullptr, nullptr, nullptr};
            int strides[3] = {0, 0, 0};
            for (int p = 0; p < numPlanes; p++) { px[p] = out[p].px.data(); strides[p] = out[p].stride; }
            GrainSynthesis(g, bitDepth, mono, ssx, ssy).apply(px, strides, outW, outH, mc == 0);
        }
    }

    // the upscaling process (7.16) of each plane, in place: the 8-tap
    // normative filter at 1/64 sample, positions in 1/16384, the source
    // clamped to the decoded width of whole 4x4 units
    void upscale(Plane* planes) {
        int maxv = (1 << bitDepth) - 1;
        for (int p = 0; p < numPlanes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int downW = round2(FrameWidth, sx), upW = round2(UpscaledWidth, sx);
            int planeH = round2(FrameHeight, sy);
            int stepX = ((downW << 14) + (upW / 2)) / upW;
            int err = upW * stepX - (downW << 14);
            int x0 = (-((upW - downW) << 13) + upW / 2) / upW + (1 << 7) - err / 2;
            x0 &= (1 << 14) - 1;
            int maxX = (MiCols >> sx) * 4 - 1;
            const Plane& in = planes[p];
            Plane out;
            out.w = upW + 80; out.h = in.h; out.stride = out.w;
            out.px.assign((size_t)out.w * out.h, 0);
            for (int y = 0; y < planeH; y++)
                for (int x = 0; x < upW; x++) {
                    int srcX = -(1 << 14) + x0 + x * stepX;
                    int srcPx = srcX >> 14, sub = (srcX & ((1 << 14) - 1)) >> 8;
                    int sum = 0;
                    for (int k = 0; k < 8; k++)
                        sum += in.get(y, clip3(0, maxX, srcPx + k - 3)) * k_upscale_filter[sub][k];
                    *out.at(y, x) = (uint16_t)clip3(0, maxv, round2(sum, 7));
                }
            planes[p] = std::move(out);
        }
    }

    void post_filters() {
        loop_filter();
        cdef();
        // as libaom, only where the widths differ (a denominator can leave
        // a narrow frame at its width)
        if (UpscaledWidth != FrameWidth) {
            census[C_SUPERRES]++;
            upscale(frame);         // the deblocked rows loop restoration reads
            upscale(cdefFrame);
        }
        loop_restoration();
    }
};

}  // namespace

static void fill_info(const Decoder* d, int32_t* info) {
    info[INFO_WIDTH] = d->outSpatialId >= 0 ? d->outW : d->headerDone ? d->UpscaledWidth : d->maxW;
    info[INFO_HEIGHT] = d->outSpatialId >= 0 ? d->outH : d->headerDone ? d->FrameHeight : d->maxH;
    info[INFO_BITDEPTH] = d->bitDepth; info[INFO_MONO] = d->mono;
    info[INFO_SSX] = d->ssx; info[INFO_SSY] = d->ssy;
    info[INFO_CP] = d->cp; info[INFO_TC] = d->tc; info[INFO_MC] = d->mc;
    info[INFO_RANGE] = d->colorRange; info[INFO_PROFILE] = d->profile;
    info[INFO_STILL] = d->stillPicture; info[INFO_REDUCED] = d->reducedStill;
    info[INFO_CSP] = d->csp; info[INFO_FRAME_TYPE] = d->frameType;
    info[INFO_OPERATING_POINTS] = d->opCount;
    info[INFO_LEVEL] = d->level0; info[INFO_TIER] = d->tier0;
    info[INFO_TOOL] = d->refusedTool; info[INFO_FRAMES] = d->frames;
    info[INFO_SPATIAL_ID] = d->outSpatialId; info[INFO_BASE_Q_IDX] = d->baseQ;
}

extern "C" int64_t av1_decode(const uint8_t* obus, int64_t n, int32_t* info, uint16_t* planes,
                              int64_t cap, int64_t* census, int32_t op, int32_t layer) {
    Decoder* dec = new Decoder();
    int64_t ret = 0;
    int64_t dummy[C_COUNT];
    memset(dummy, 0, sizeof(dummy));
    try {
        dec->census = census ? census : dummy;
        dec->op = op; dec->layer = layer;
        dec->run(obus, (size_t)n, false);
        if (!dec->headerDone) throw (int)ERR_NO_FRAME;
        fill_info(dec, info);
        // every frame fits the sequence header's largest size
        int64_t W = dec->maxW, H = dec->maxH;
        int64_t cw = dec->mono ? 0 : (W + dec->ssx) >> dec->ssx, ch = dec->mono ? 0 : (H + dec->ssy) >> dec->ssy;
        int64_t need = W * H + 2 * cw * ch;
        if (cap < need) { delete dec; return -need - 1000; }
        Decoder* d2 = new Decoder();
        delete dec;
        dec = d2;
        dec->census = census ? census : dummy;
        dec->op = op; dec->layer = layer;
        dec->run(obus, (size_t)n, true);
        if (dec->outSpatialId < 0) throw (int)ERR_NO_FRAME;
        fill_info(dec, info);
        W = dec->outW; H = dec->outH;
        cw = dec->mono ? 0 : (W + dec->ssx) >> dec->ssx; ch = dec->mono ? 0 : (H + dec->ssy) >> dec->ssy;
        uint16_t* out = planes;
        for (int p = 0; p < dec->numPlanes; p++) {
            int64_t pw = p ? cw : W, ph = p ? ch : H;
            const Plane& f = dec->out[p];
            for (int64_t y = 0; y < ph; y++) memcpy(out + y * pw, &f.px[(size_t)y * f.stride], pw * 2);
            out += pw * ph;
        }
    } catch (int code) {
        ret = code;
        if (dec->seqSeen) fill_info(dec, info);
    } catch (...) {
        ret = ERR_BITSTREAM;
    }
    delete dec;
    return ret;
}
