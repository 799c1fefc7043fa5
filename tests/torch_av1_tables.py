"""Write `rnb_neus2_torch/native/av1_tables.h`, the AV1 specification's
tables that the port's AV1 decoder needs (default CDFs, quantizer lookup
and matrices, scans, intra and filter constants, the superres upscaling
filter and film grain's Gaussian sequence), from the read-only data
of libaom 3.14 as the opencv-python wheel ships it, and check the header
against that data.

libaom keeps a coefficient block column by column (index = col * h + row);
the specification, and the port, row by row (row * w + col): scans and
quantizer matrices are converted here. CDFs keep libaom's inverse form
(32768 - cdf, then 0, then the adaptation counter), which the decoder
reads as is. The CDFs libaom builds from immediates in
`av1_init_mode_probs` are written out here and found byte for byte in the
library by `check_small_cdfs`.

    python tests/torch_av1_tables.py          # rewrite the header
"""

from __future__ import annotations

import glob
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
HEADER = REPO / "rnb_neus2_torch" / "native" / "av1_tables.h"

TX_W = [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64]
TX_H = [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16]
SCAN_SIZES = ["4x4", "8x8", "16x16", "32x32", None, "4x8", "8x4", "8x16",
              "16x8", "16x32", "32x16", None, None, "4x16", "16x4", "8x32",
              "32x8", None, None]


def libaom_path() -> str:
    import cv2  # noqa: F401  (the wheel's libraries sit beside the package)
    import os
    libs = Path(os.path.dirname(cv2.__file__)).parent / "opencv_python.libs"
    found = sorted(glob.glob(str(libs / "libaom-*.so*")))
    if not found:
        raise FileNotFoundError("libaom of the opencv-python wheel not found")
    return found[0]


class Rodata:
    """Named objects and raw bytes of an ELF shared library."""

    def __init__(self, path: str):
        from elftools.elf.elffile import ELFFile
        with open(path, "rb") as f:
            self.data = f.read()
            f.seek(0)
            elf = ELFFile(f)
            self.syms = {}
            for s in elf.get_section_by_name(".symtab").iter_symbols():
                if s["st_size"]:
                    self.syms.setdefault(s.name, (s["st_value"], s["st_size"]))
            self.secs = [(s["sh_addr"], s["sh_offset"], s["sh_size"])
                         for s in elf.iter_sections() if s["sh_addr"]]

    def raw(self, addr: int, size: int) -> bytes:
        for a, o, sz in self.secs:
            if a <= addr < a + sz:
                return self.data[o + addr - a:o + addr - a + size]
        raise KeyError(hex(addr))

    def get(self, name: str, dtype, size: int | None = None) -> np.ndarray:
        addr, sz = self.syms[name]
        return np.frombuffer(self.raw(addr, size or sz), dtype).copy()


def icdf(*vals) -> list:
    """AOM_CDFn(vals): the inverse CDF, its final 0 and the counter."""
    return [32768 - v for v in vals] + [0, 0]


# CDFs libaom's av1_init_mode_probs stores from immediates or small
# unnamed constants (entropymode.c); `check_small_cdfs` finds each.
SMALL_CDFS = {
    "angle_delta_cdf": [icdf(2180, 5032, 7567, 22776, 26989, 30217),
                        icdf(2301, 5608, 8801, 23487, 26974, 30330),
                        icdf(3780, 11018, 13699, 19354, 23083, 31286),
                        icdf(4581, 11226, 15147, 17138, 21834, 28397),
                        icdf(1737, 10927, 14509, 19588, 22745, 28823),
                        icdf(2664, 10176, 12485, 17650, 21600, 30495),
                        icdf(2240, 11096, 15453, 20341, 22561, 28917),
                        icdf(3605, 10428, 12459, 17676, 21244, 30655)],
    "intrabc_cdf": [icdf(30531)],
    "skip_cdf": [icdf(31671), icdf(16515), icdf(4576)],
    "spatial_pred_seg_cdf": [
        icdf(5622, 7893, 16093, 18233, 27809, 28373, 32533),
        icdf(14274, 18230, 22557, 24935, 29980, 30851, 32344),
        icdf(27527, 28487, 28723, 28890, 32397, 32647, 32679)],
    "delta_q_cdf": [icdf(28160, 32120, 32677)],
    "delta_lf_cdf": [icdf(28160, 32120, 32677)],
    "delta_lf_multi_cdf": [icdf(28160, 32120, 32677)] * 4,
    "tx_size_cdf": [icdf(19968) + [0], icdf(19968) + [0], icdf(24320) + [0],
                    icdf(12272, 30172), icdf(12272, 30172),
                    icdf(18677, 30848), icdf(12986, 15180),
                    icdf(12986, 15180), icdf(24302, 25602),
                    icdf(5782, 11475), icdf(5782, 11475),
                    icdf(16803, 22759)],
    "filter_intra_cdfs": [icdf(v) for v in (
        4621, 6743, 5893, 7866, 12551, 9394, 12408, 14301, 12756, 22343,
        16384, 16384, 16384, 16384, 16384, 16384, 12770, 10368, 20229, 18101,
        16384, 16384)],
    "filter_intra_mode_cdf": [icdf(8949, 12776, 17211, 29558)],
    "palette_y_size_cdf": [
        icdf(7952, 13000, 18149, 21478, 25527, 29241),
        icdf(7139, 11421, 16195, 19544, 23666, 28073),
        icdf(7788, 12741, 17325, 20500, 24315, 28530),
        icdf(8271, 14064, 18246, 21564, 25071, 28533),
        icdf(12725, 19180, 21863, 24839, 27535, 30120),
        icdf(9711, 14888, 16923, 21052, 25661, 27875),
        icdf(14940, 20797, 21678, 24186, 27033, 28999)],
    "palette_uv_size_cdf": [
        icdf(8713, 19979, 27128, 29609, 31331, 32272),
        icdf(5839, 15573, 23581, 26947, 29848, 31700),
        icdf(4426, 11260, 17999, 21483, 25863, 29430),
        icdf(3228, 9464, 14993, 18089, 22523, 27420),
        icdf(3768, 8886, 13091, 17852, 22495, 27207),
        icdf(2464, 8451, 12861, 21632, 25525, 28555),
        icdf(1269, 5435, 10433, 18963, 21700, 25865)],
    "palette_y_mode_cdf": [icdf(v) for v in (
        31676, 3419, 1261, 31912, 2859, 980, 31823, 3400, 781, 32030, 3561,
        904, 32309, 7337, 1462, 32265, 4015, 1521, 32450, 7946, 129)],
    "palette_uv_mode_cdf": [icdf(32461), icdf(21488)],
    "cfl_sign_cdf": [icdf(1418, 2123, 13340, 18405, 26972, 28343, 32294)],
    "cfl_alpha_cdf": [
        icdf(7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700,
             32704, 32708, 32712, 32716, 32720, 32724),
        icdf(14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620,
             32647, 32668, 32672, 32676, 32680, 32684),
        icdf(11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673,
             32677, 32681, 32685, 32689, 32693, 32697),
        icdf(26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708,
             32712, 32716, 32720, 32724, 32728, 32732),
        icdf(17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394,
             32464, 32516, 32560, 32576, 32593, 32622),
        icdf(14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144,
             32413, 32520, 32594, 32622, 32656, 32660)],
    "switchable_restore_cdf": [icdf(9413, 22581)],
    "wiener_restore_cdf": [icdf(11570)],
    "sgrproj_restore_cdf": [icdf(16855)],
    "txfm_partition_cdf": [icdf(v) for v in (
        28581, 23846, 20847, 24315, 18196, 12133, 18791, 10887, 11005, 27179,
        20004, 11281, 26549, 19308, 14224, 28015, 21546, 14400, 28165, 22401,
        16088)],
}


def check_small_cdfs(lib: Rodata) -> list:
    """Names of SMALL_CDFS rows whose values (without the trailing 0 and
    counter) appear nowhere in the library, as uint16 runs or split into
    the 16-bit halves of immediates."""
    missing = []
    for name, rows in SMALL_CDFS.items():
        for row in rows:
            vals = [v for v in row[:-2] if v] or row[:1]
            found = False
            for k in range(len(vals), 0, -1):
                if np.array(vals[:k], np.uint16).tobytes() in lib.data:
                    found = k == len(vals) or all(
                        np.array(vals[j:j + 1], np.uint16).tobytes()
                        in lib.data for j in range(k, len(vals)))
                    break
            if not found:
                missing.append((name, row))
    return missing


def col_to_row_major(table: np.ndarray, w: int, h: int) -> np.ndarray:
    """A scan (positions) given column by column → row by row."""
    p = table.astype(np.int64)
    return ((p % h) * w + p // h).astype(table.dtype)


def qm_row_major(block: np.ndarray, w: int, h: int) -> np.ndarray:
    """Matrix values indexed column by column → row by row."""
    return block.reshape(w, h).T.reshape(-1)


# The inter-frame CDFs libaom builds from immediates: the byte offsets and
# shapes of FRAME_CONTEXT's members (libaom 3.14, av1/common/entropy.h)
# after av1_init_mode_probs, whose anchors below must hold.
FRAME_CONTEXT_CDFS = {
    "newmv_cdf": (8090, (6, 3)), "zeromv_cdf": (8126, (2, 3)),
    "refmv_cdf": (8138, (6, 3)), "drl_cdf": (8174, (3, 3)),
    "interintra_cdf": (9216, (4, 3)), "wedge_interintra_cdf": (9240, (22, 3)),
    "interintra_mode_cdf": (9372, (4, 5)), "motion_mode_cdf": (9412, (22, 4)),
    "obmc_cdf": (9588, (22, 3)), "comp_inter_cdf": (11342, (5, 3)),
    "single_ref_cdf": (11372, (3, 6, 3)), "skip_mode_cdf": (11852, (3, 3)),
    "intra_inter_cdf": (11888, (4, 3)), "seg_pred_cdf": (12490, (3, 3)),
    "y_mode_cdf": (12726, (4, 14)), "switchable_interp_cdf": (14058, (16, 4)),
    # compound prediction (between drl_cdf and wedge_idx_cdf, single_ref_cdf
    # and txfm_partition_cdf, txfm_partition_cdf and skip_mode_cdf)
    "compound_mode_cdf": (8192, (8, 9)), "compound_type_cdf": (8336, (22, 3)),
    "comp_ref_type_cdf": (11480, (5, 3)), "uni_comp_ref_cdf": (11510, (3, 3, 3)),
    "comp_ref_cdf": (11564, (3, 3, 3)), "comp_bwdref_cdf": (11618, (3, 2, 3)),
    "compound_idx_cdf": (11780, (6, 3)), "comp_group_idx_cdf": (11816, (6, 3)),
}
FRAME_CONTEXT_ANCHORS = {
    "default_wedge_idx_cdf": 8468, "default_palette_y_color_index_cdf": 9944,
    "default_uv_mode_cdf": 12838, "default_partition_cdf": 13618,
    "default_kf_y_mode_cdf": 14186, "default_inter_ext_tx_cdf": 20474,
}


def frame_context_cdfs(lib: Rodata) -> dict:
    """Run libaom's av1_init_mode_probs on a FRAME_CONTEXT-sized buffer
    (the library loaded through ctypes; its base found from an exported
    symbol) and read the inter CDFs at their offsets, after checking the
    named tables and the CDFs of SMALL_CDFS sit where the layout puts
    them."""
    import ctypes
    dll = ctypes.CDLL(libaom_path())
    base = ctypes.cast(dll.aom_codec_av1_dx, ctypes.c_void_p).value - lib.syms["aom_codec_av1_dx"][0]
    init = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + lib.syms["av1_init_mode_probs"][0])
    buf = ctypes.create_string_buffer(1 << 16)
    init(buf)
    raw = buf.raw
    for name, off in FRAME_CONTEXT_ANCHORS.items():
        want = lib.raw(*lib.syms[name])
        if raw[off:off + len(want)] != want:
            raise ValueError(f"FRAME_CONTEXT layout: {name} not at {off}")
    for name, off in (("skip_cdf", 11870), ("txfm_partition_cdf", 11654), ("intrabc_cdf", 12484),
                      ("spatial_pred_seg_cdf", 12508), ("sgrproj_restore_cdf", 12720)):
        want = np.array(SMALL_CDFS[name], np.uint16).tobytes()
        if raw[off:off + len(want)] != want:
            raise ValueError(f"FRAME_CONTEXT layout: {name} not at {off}")
    out = {}
    for name, (off, shape) in FRAME_CONTEXT_CDFS.items():
        n = int(np.prod(shape))
        out[name] = np.frombuffer(raw[off:off + 2 * n], np.uint16).reshape(shape).copy()
    return out


WEDGE_SIZES = (3, 4, 5, 6, 7, 8, 9, 18, 19)    # BLOCK_8X8..BLOCK_32X32, 8X32, 32X8
BLOCK_W = [4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64]
BLOCK_H = [4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16]


def wedge_masks(lib: Rodata) -> np.ndarray:
    """The 16 wedge masks (sign 0) of each block size with wedges, in
    WEDGE_SIZES order, as libaom builds them when its decoder first runs
    (it decodes a small key frame of its own encoder here, through ctypes;
    `wedge_masks` then holds a pointer to each)."""
    import ctypes

    import torch_image_writers as tw
    from torch_avif_reference import _lib, libaom_planes
    libaom_planes(tw.aom_encode(tw.rgb_to_yuv420(np.zeros((16, 16, 3), np.uint8)), options={"cpu-used": 6}))
    dll = _lib()
    base = ctypes.cast(dll.aom_codec_av1_dx, ctypes.c_void_p).value - lib.syms["aom_codec_av1_dx"][0]
    table = base + lib.syms["wedge_masks"][0]
    out = []
    for b in WEDGE_SIZES:
        for k in range(16):
            ptr = ctypes.c_void_p.from_address(table + ((b * 2 + 0) * 16 + k) * 8).value
            out.append(np.frombuffer(ctypes.string_at(ptr, BLOCK_W[b] * BLOCK_H[b]), np.uint8))
    return np.concatenate(out)


def build(lib: Rodata) -> dict:
    t = {}
    u16 = np.uint16
    t["partition_cdf"] = lib.get("default_partition_cdf", u16).reshape(20, 11)
    t["kf_y_mode_cdf"] = lib.get("default_kf_y_mode_cdf", u16).reshape(5, 5, 14)
    t["uv_mode_cdf"] = lib.get("default_uv_mode_cdf", u16).reshape(2, 13, 15)
    t["intra_ext_tx_cdf"] = lib.get("default_intra_ext_tx_cdf", u16).reshape(3, 4, 13, 17)
    t["inter_ext_tx_cdf"] = lib.get("default_inter_ext_tx_cdf", u16).reshape(4, 4, 17)
    t["palette_y_color_cdf"] = lib.get("default_palette_y_color_index_cdf", u16).reshape(7, 5, 9)
    t["palette_uv_color_cdf"] = lib.get("default_palette_uv_color_index_cdf", u16).reshape(7, 5, 9)
    t["nmv_cdf"] = lib.get("default_nmv_context", u16)
    t["txb_skip_cdf"] = lib.get("av1_default_txb_skip_cdfs", u16).reshape(4, 5, 13, 3)
    for n, k in ((16, 6), (32, 7), (64, 8), (128, 9), (256, 10), (512, 11), (1024, 12)):
        t[f"eob_multi{n}_cdf"] = lib.get(f"av1_default_eob_multi{n}_cdfs", u16).reshape(4, 2, 2, k)
    t["eob_extra_cdf"] = lib.get("av1_default_eob_extra_cdfs", u16).reshape(4, 5, 2, 9, 3)
    t["dc_sign_cdf"] = lib.get("av1_default_dc_sign_cdfs", u16).reshape(4, 2, 3, 3)
    t["coeff_base_eob_cdf"] = lib.get("av1_default_coeff_base_eob_multi_cdfs", u16).reshape(4, 5, 2, 4, 4)
    t["coeff_base_cdf"] = lib.get("av1_default_coeff_base_multi_cdfs", u16).reshape(4, 5, 2, 42, 5)
    t["coeff_br_cdf"] = lib.get("av1_default_coeff_lps_multi_cdfs", u16).reshape(4, 5, 2, 21, 5)
    for name, rows in SMALL_CDFS.items():
        t[name] = np.array(rows, u16)
    i16 = np.int16
    t["dc_qlookup"] = np.stack([lib.get("dc_qlookup_QTX", i16), lib.get("dc_qlookup_10_QTX", i16),
                                lib.get("dc_qlookup_12_QTX", i16)])
    t["ac_qlookup"] = np.stack([lib.get("ac_qlookup_QTX", i16), lib.get("ac_qlookup_10_QTX", i16),
                                lib.get("ac_qlookup_12_QTX", i16)])
    qm = np.frombuffer(lib.raw(lib.syms["iwt_matrix_ref"][0], 15 * 2 * 3344), np.uint8).reshape(15, 2, 3344)
    out = qm.copy()
    off = 0
    for tx in range(19):
        w, h = TX_W[tx], TX_H[tx]
        if w == 64 or h == 64:
            continue
        n = w * h
        for lv in range(15):
            for c in range(2):
                out[lv, c, off:off + n] = qm_row_major(qm[lv, c, off:off + n], w, h)
        off += n
    assert off == 3344
    t["iwt_matrix"] = out
    scans = []
    for tx, s in enumerate(SCAN_SIZES):
        if s is None:
            continue
        w, h = TX_W[tx], TX_H[tx]
        scans.append(col_to_row_major(lib.get(f"default_scan_{s}", i16), w, h))
    t["default_scan"] = np.concatenate(scans)
    t["smooth_weights"] = lib.get("smooth_weights", np.uint8)
    t["dr_intra_derivative"] = lib.get("dr_intra_derivative", i16)
    t["filter_intra_taps"] = lib.get("av1_filter_intra_taps", np.int8).reshape(5, 8, 8)
    t["sgr_params"] = lib.get("av1_sgr_params", np.int32).reshape(16, 4)
    t["x_by_xplus1"] = lib.get("av1_x_by_xplus1", np.int32)
    t["one_by_x"] = lib.get("av1_one_by_x", np.int32)
    t["ext_tx_inv"] = lib.get("av1_ext_tx_inv", np.int32).reshape(6, 16)
    t["ss_size_lookup"] = lib.get("av1_ss_size_lookup", np.uint8).reshape(22, 2, 2)
    t["palette_color_context"] = lib.get("av1_palette_color_index_context_lookup", np.int32)
    t["upscale_filter"] = lib.get("av1_resize_filter_normative", i16).reshape(64, 8)
    t["gaussian_sequence"] = lib.get("gaussian_sequence", np.int32)
    t.update(frame_context_cdfs(lib))
    # the sub-sample filters in the specification's order: regular, smooth,
    # sharp, bilinear, then the 4-tap regular and smooth for small blocks
    bilinear = np.zeros((16, 8), i16)
    bilinear[:, 3] = 128 - 8 * np.arange(16)
    bilinear[:, 4] = 8 * np.arange(16)
    t["subpel_filters"] = np.stack([
        lib.get("av1_sub_pel_filters_8", i16).reshape(16, 8),
        lib.get("av1_sub_pel_filters_8smooth", i16).reshape(16, 8),
        lib.get("av1_sub_pel_filters_8sharp", i16).reshape(16, 8), bilinear,
        lib.get("av1_sub_pel_filters_4", i16).reshape(16, 8),
        lib.get("av1_sub_pel_filters_4smooth", i16).reshape(16, 8)])
    t["mode_lf_lut"] = lib.get("mode_lf_lut", np.int32)
    t["div_mult"] = lib.get("div_mult", np.int32)
    t["div_lut"] = lib.get("div_lut", i16)
    t["warped_filter"] = lib.get("av1_warped_filter", i16).reshape(193, 8)
    # OBMC's blending masks of length 1, 2, 4, 8, 16 and 32, one after another
    t["ii_weights1d"] = lib.get("ii_weights1d", np.uint8)
    t["wedge_masks"] = wedge_masks(lib)
    t["wedge_idx_cdf"] = lib.get("default_wedge_idx_cdf", u16).reshape(22, 17)
    t["obmc_masks"] = np.concatenate([lib.get(f"obmc_mask_{n}", np.uint8) for n in (1, 2, 4, 8, 16, 32)])
    return t


CTYPES = {np.dtype(np.uint16): "uint16_t", np.dtype(np.int16): "int16_t",
          np.dtype(np.uint8): "uint8_t", np.dtype(np.int8): "int8_t",
          np.dtype(np.int32): "int32_t"}


def render(t: dict) -> str:
    lines = ["// AV1 specification tables for native/av1.cc, written by",
             "// tests/torch_av1_tables.py. CDFs in inverse form (32768 - cdf,",
             "// 0, counter); coefficient positions row by row.",
             "#pragma once", "#include <cstdint>", ""]
    for name, a in t.items():
        dims = "".join(f"[{d}]" for d in a.shape)
        flat = a.reshape(-1)
        body = []
        for i in range(0, flat.size, 16):
            body.append("  " + ", ".join(str(int(v)) for v in flat[i:i + 16]) + ",")
        lines.append(f"static const {CTYPES[a.dtype]} k_{name}{dims} = {{")
        lines.extend(body)
        lines.append("};")
        lines.append("")
    return "\n".join(lines)


def main() -> int:
    lib = Rodata(libaom_path())
    missing = check_small_cdfs(lib)
    if missing:
        print("not found in libaom:", missing)
        return 1
    HEADER.write_text(render(build(lib)))
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
