"""Write `rnb_neus2_torch/native/sgilog_uv.h`, libtiff's `uv_row` table
(uvcode.h: for each of the 163 rows of the (u', v') grid of LogLuv24's
14-bit colour index, the first u' of the row, the number of cells in it
and the cells before it), from the read-only data of the libtiff 4.7.1
that the opencv-python wheel links into cv2, and check the header
against it.

The table is found by its shape: 163 records of (float32, int16, int16)
whose counts add up row after row from 0 to 16,289 cells, the first
starting at u' = 0.247663.

    python tests/torch_sgilog_table.py          # rewrite the header
    python tests/torch_sgilog_table.py --check  # compare only
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
HEADER = REPO / "rnb_neus2_torch" / "native" / "sgilog_uv.h"
ROWS, CELLS = 163, 16289


def cv2_binary() -> Path:
    import cv2
    return Path(cv2.__file__).parent / "cv2.abi3.so"


def find_table(data: bytes) -> list:
    """[(ustart, nus, ncum)] × 163 from a libtiff build's data."""
    first = struct.pack("<fhh", 0.247663, 4, 0)
    pos = data.find(first)
    while pos >= 0:
        rows = [struct.unpack_from("<fhh", data, pos + 8 * i)
                for i in range(ROWS)]
        total = 0
        for _, nus, ncum in rows:
            if ncum != total or nus <= 0:
                break
            total += nus
        else:
            if total == CELLS:
                return rows
        pos = data.find(first, pos + 1)
    raise LookupError("libtiff's uv_row table not found")


def header(rows: list) -> str:
    lines = ["// libtiff's uv_row (uvcode.h) for native/codecs.cc's LogLuv24",
             "// decoder, written by tests/torch_sgilog_table.py from the",
             "// libtiff in the opencv-python wheel: the first u' of each",
             "// row of the (u', v') grid, its cells, the cells before it.",
             "#pragma once", "#include <cstdint>", "",
             "struct UvRow {", "  float ustart;", "  int16_t nus, ncum;",
             "};", "", f"static const UvRow k_uv_row[{ROWS}] = {{"]
    for u, nus, ncum in rows:
        lines.append(f"  {{{u!r}f, {nus}, {ncum}}},")
    lines += ["};", ""]
    return "\n".join(lines)


def main(argv) -> int:
    text = header(find_table(cv2_binary().read_bytes()))
    if "--check" in argv:
        same = HEADER.read_text() == text
        print("sgilog_uv.h", "matches" if same else "DIFFERS")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
