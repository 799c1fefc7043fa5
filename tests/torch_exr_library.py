"""OpenEXR 3.1 itself, for the EXR fixtures: `write` files with the
library (scan-line, tiled, multi-part, deep) and `read` them back through
`Imf::InputFile` with FLOAT slices, the call cv2's EXR decoder makes.
`tests/torch_exr_library.cc` is built with g++ against the host's
`libopenexr-dev` headers into `build/torch_exr_library/` at first use.
Only `tests/torch_fixtures/formats/make_fixtures.py exr` needs it: tier-1
reads the committed files and `expected.npz`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "torch_exr_library.cc"
BUILD = Path(__file__).resolve().parents[1] / "build" / "torch_exr_library"
FLAGS = ["-std=c++17", "-O1", "-shared", "-fPIC",
         "-I/usr/include/OpenEXR", "-I/usr/include/Imath"]
LIBS = ["-lOpenEXR-3_1", "-lIex-3_1", "-lImath-3_1"]
COMPRESSION = {"NO": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3, "PIZ": 4,
               "PXR24": 5, "B44": 6, "B44A": 7, "DWAA": 8, "DWAB": 9}
TYPES = {"uint": 0, "half": 1, "float": 2}
DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
LINE_ORDER = {"increasing": 0, "decreasing": 1, "random": 2}
LEVEL_MODE = {"one": 0, "mipmap": 1, "ripmap": 2}
ROUNDING = {"down": 0, "up": 1}
P_FIELDS, C_FIELDS = 13, 4


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    lib = BUILD / tag / "libtorch_exr_library.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(lib), *LIBS],
                       check=True)
    out = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    out.exr_write.argtypes = [ctypes.c_char_p, ctypes.c_int, P, P, P, P, P,
                              P, ctypes.c_int]
    out.exr_read.argtypes = [ctypes.c_char_p, P, P, ctypes.c_int, P, P,
                             ctypes.c_int]
    return out


def part(channels: dict, compression="ZIP", window=(0, 0), line_order=
         "increasing", tiles=None, level_mode="one", rounding="down",
         dwa_level=45.0, plinear=(), sampling=None, deep=False) -> dict:
    """One part: `channels` {name: (h, w) array of float16, float32 or
    uint32, each channel's own (h / ys, w / xs) shape when `sampling`
    {name: (xs, ys)} subsamples it}; `tiles` (tx, ty) makes it tiled."""
    return dict(channels=channels, compression=compression, window=window,
                line_order=line_order, tiles=tiles, level_mode=level_mode,
                rounding=rounding, dwa_level=dwa_level, plinear=set(plinear),
                sampling=sampling or {}, deep=deep)


def write(path, *parts: dict) -> None:
    """Write `parts` (see `part`) with the library; one part writes a
    single-part file."""
    info, levels, names, chans, data, keep = [], [], b"", [], [], []
    for p in parts:
        items = sorted(p["channels"].items())
        xs, ys = p["sampling"].get(items[0][0], (1, 1))
        h, w = items[0][1].shape[0] * ys, items[0][1].shape[1] * xs
        tx, ty = p["tiles"] or (0, 0)
        info += [p["window"][0], p["window"][1], w, h,
                 COMPRESSION[p["compression"]], LINE_ORDER[p["line_order"]],
                 int(p["tiles"] is not None), tx, ty,
                 LEVEL_MODE[p["level_mode"]], ROUNDING[p["rounding"]],
                 len(items), int(p["deep"])]
        levels.append(p["dwa_level"])
        for name, arr in items:
            arr = np.ascontiguousarray(arr)
            code = {np.dtype("float16"): 1, np.dtype("float32"): 2,
                    np.dtype("uint32"): 0}[arr.dtype]
            sx, sy = p["sampling"].get(name, (1, 1))
            names += name.encode() + b"\0"
            chans += [code, int(name in p["plinear"]), sx, sy]
            keep.append(arr)
            data.append(arr.ctypes.data)
    info = np.asarray(info, np.int32)
    levels = np.asarray(levels, np.float32)
    chans = np.asarray(chans, np.int32)
    ptrs = (ctypes.c_void_p * len(data))(*data)
    err = ctypes.create_string_buffer(512)
    code = _library().exr_write(str(path).encode(), len(parts),
                                info.ctypes.data, levels.ctypes.data,
                                ctypes.c_char_p(names), chans.ctypes.data,
                                ptrs, err, 512)
    if code:
        raise RuntimeError(f"OpenEXR could not write {path}: "
                           f"{err.value.decode()}")


def read(path) -> dict:
    """`Imf::InputFile`'s decode of part 0 with a FLOAT slice a channel →
    {"window": (x0, y0), "channels": {name: (h, w) float32}} in the
    header's order, or {"error": message} where the library throws."""
    lib = _library()
    info = np.zeros(5, np.int32)
    names = ctypes.create_string_buffer(4096)
    err = ctypes.create_string_buffer(512)
    if lib.exr_read(str(path).encode(), info.ctypes.data, names, 4096, None,
                    err, 512):
        return {"error": err.value.decode()}
    x0, y0, w, h, n = (int(v) for v in info)
    out = np.zeros((n, h, w), np.float32)
    if lib.exr_read(str(path).encode(), info.ctypes.data, names, 4096,
                    out.ctypes.data, err, 512):
        return {"error": err.value.decode()}
    keys = names.raw.split(b"\0")[:n]
    return {"window": (x0, y0),
            "channels": {k.decode(): out[i] for i, k in enumerate(keys)}}
