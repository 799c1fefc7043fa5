"""Build a source into a shared library with a plain C interface and load
it with ctypes.

CUDA sources of `csrc/`: `nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -shared -Xcompiler -fPIC`; host C++ sources (the repo's
`native/raycast.cc`, the package's `native/png_unfilter.cc`): `g++ -O3
-fopenmp -shared -fPIC`. Either goes into
`build/rnb_neus2_torch/<hash of the sources, the headers of csrc/ and the
flags>/lib<name>.so` under the repository root, at first use; nothing is
written beside the sources. The library is written under a temporary
name and renamed into place, so two processes building at once never see
a half-written file and no lock file is needed.
A missing compiler or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO = Path(__file__).resolve().parents[2]
BUILD_ROOT = REPO / "build" / "rnb_neus2_torch"
BUILD_TIMEOUT_S = 600

# name -> (loaded library, build record); one build per process
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return nvcc


def _digest(paths: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in [*paths, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[str]) -> Tuple[ctypes.CDLL, dict]:
    """Build (if needed) with nvcc and load `lib<name>.so` from
    `csrc/<sources>`.

    Returns (library, record) where record holds the path, whether it was
    built in this call, the build seconds and nvcc's output
    (`-Xptxas -v`: registers, shared memory and spills per kernel)."""
    return _load(name, [CSRC / s for s in sources], find_nvcc, NVCC_FLAGS)


def load_host_library(name: str, source: Path) -> Tuple[ctypes.CDLL, dict]:
    """Build (if needed) with g++ and load `lib<name>.so` from one host
    C++ source."""
    def gxx() -> str:
        path = shutil.which("g++")
        if path is None:
            raise RuntimeError(f"g++ not found on PATH; {source.name} cannot "
                               "be built")
        return path
    return _load(name, [source], gxx, GXX_FLAGS)


def _load(name, paths, compiler, flags) -> Tuple[ctypes.CDLL, dict]:
    if name in _LOADED:
        return _LOADED[name]
    out_dir = BUILD_ROOT / _digest(paths, flags)
    lib_path = out_dir / f"lib{name}.so"
    record = {"path": str(lib_path), "built": False, "seconds": 0.0,
              "log": ""}
    if not lib_path.exists():
        exe = compiler()
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [exe, *flags, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        record["seconds"] = time.perf_counter() - t0
        record["log"] = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(exe).name} failed ({proc.returncode}) "
                               f"building {lib_path}:\n{record['log']}")
        os.replace(tmp, lib_path)
        record["built"] = True
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, record)
    return lib, record
