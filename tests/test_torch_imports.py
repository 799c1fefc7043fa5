"""The PyTorch port stands alone: no source of `rnb_neus2_torch` or
`chip_smoke.py` imports JAX, the JAX package or a library the card's host
lacks (`cv2`, `msgpack`, `PIL`, `trimesh`, the image libraries `imageio`,
`tifffile` and `OpenEXR`, `pyalicevision`), except
`pyalicevision` inside a function (the SfMData loader imports the
optional bindings when it is called, as the JAX package does); the whole
package imports with all of them blocked, and so do the two CLIs'
`--help`; `chip_smoke.py` fails without a card or without the package
beside it; so do the tools' `--help`. The Meshroom node (`rnb_neus2_torch/meshroom/`) imports the
Meshroom application, which exists only inside Meshroom: its source is
scanned, and tests/test_torch_ported_modules.py imports it with
`meshroom.core` mocked."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "rnb_neus2_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "flax", "optax", "cv2", "msgpack", "PIL", "trimesh",
           "imageio", "tifffile", "OpenEXR", "pyalicevision", "rnb_neus2_tpu")
# pyalicevision may be imported inside a function only
ANYWHERE = "|".join(m for m in BLOCKED if m != "pyalicevision")
FORBIDDEN = re.compile(
    rf"^\s*(import\s+({ANYWHERE})\b|from\s+({ANYWHERE})\b)"
    r"|^(import|from)\s+pyalicevision\b", re.M)
# imported only by the Meshroom application
MESHROOM_NODES = ("meshroom",)
BLOCK = f"import sys\nfor m in {BLOCKED!r}:\n    sys.modules[m] = None\n"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_source_imports_no_jax(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "rnb_neus2_torch").rglob("*.py")
        if p.relative_to(ROOT / "rnb_neus2_torch").parts[0]
        not in MESHROOM_NODES)
    code = (BLOCK + f"import importlib\nfor m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("cli", ["testbed", "run_pipeline"])
def test_cli_help_with_libraries_blocked(cli):
    code = (BLOCK + "import runpy\n"
            "sys.argv = ['x', '--help']\n"
            f"runpy.run_module('rnb_neus2_torch.cli.{cli}', "
            "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


@pytest.mark.parametrize("tool", ["mesh_from_snapshot", "bench_primitives"])
def test_tool_help_with_libraries_blocked(tool):
    code = (BLOCK + "import runpy\n"
            "sys.argv = ['x', '--help']\n"
            f"runpy.run_module('rnb_neus2_torch.tools.{tool}', "
            "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    """Without a card the smoke exits non-zero and prints no result; so it
    does, card or not, from a directory that holds nothing else of the
    repo."""
    import torch
    runs = []
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
            capture_output=True, text=True, timeout=120))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                               cwd=tmp_path, capture_output=True, text=True,
                               timeout=120))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
