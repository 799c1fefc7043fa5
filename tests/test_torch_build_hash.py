"""The host libraries' build hash (`kernels/build.py:_digest`) covers the
headers a source includes, so an edit to one (native/av1_tables.h beside
native/av1.cc, ...) builds a new library instead of loading a stale
one."""

from pathlib import Path

from rnb_neus2_torch.kernels import build

NATIVE = Path(build.__file__).resolve().parent.parent / "native"


def test_digest_follows_included_headers(tmp_path):
    src, head, deep = tmp_path / "a.cc", tmp_path / "a.h", tmp_path / "b.h"
    src.write_text('#include "a.h"\n#include <vector>\nint f() { return A; }\n')
    head.write_text('#pragma once\n#include "b.h"\n#define A B\n')
    deep.write_text("#define B 1\n")
    flags = build.GXX_FLAGS
    first = build._digest([src], flags)
    assert build._digest([src], flags) == first
    head.write_text('#pragma once\n#include "b.h"\n#define A (B + 1)\n')
    second = build._digest([src], flags)
    assert second != first
    deep.write_text("#define B 2\n")
    assert build._digest([src], flags) != second


def test_av1_sources_hash_their_headers():
    deps = build._included(NATIVE / "av1.cc", set())
    assert {p.name for p in deps} == {"av1_common.h", "av1_dsp.h",
                                      "av1_grain.h", "av1_tables.h"}
    deps = build._included(NATIVE / "av1_enc.cc", set())
    assert {p.name for p in deps} == {"av1_common.h", "av1_dsp.h",
                                      "av1_tables.h"}


def test_codecs_source_hashes_the_uv_table():
    deps = build._included(NATIVE / "codecs.cc", set())
    assert {p.name for p in deps} == {"sgilog_uv.h"}


def test_exr_source_includes_no_local_header():
    assert build._included(NATIVE / "exr.cc", set()) == []
