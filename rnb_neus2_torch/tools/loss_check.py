"""Evidence for the loss kernels' checks on the card: their float64 check
run on a build with a planted fault, and the spread of the pipeline
sphere's radius over repeated runs.

    python -m rnb_neus2_torch.tools.loss_check --planted
    python -m rnb_neus2_torch.tools.loss_check --pipelines 5 [--steps 1000]
        [--loss kernels|plain|plain_twin]

--planted: trains the default config at full width for 440 steps (the
seeded 16-view 256x256 sphere, one `train_step` at a time, as
`chip_smoke.py`'s phase 7), takes the next step's loss arguments (that
step then undone) and holds the kernels against the plain version run in
float64 on them, on the edge-case batch and on the tile batch
(`testing/loss_batch.py:hold_against_float64` with its twin checks,
`EDGE_CASES`, `TILE_CASES`). Then, for each fault of `PLANTS`, it
copies this package to a temporary directory, plants the fault in the
kernels' source there (`plant`), and runs the same check on the same
arguments with that build in a subprocess: `eikonal` removes the eikonal
term from the backward kernel's ∇sdf gradient, `scan_shift` moves each
slot's log1p(−α) one slot on within its tile in the scan kernel (the
logs that the prefix sums and that the kernel writes for the check both
shifted, so that only a reference computed apart from the kernel sees
it). One JSON line per case and build; exits 1 unless every case of the
real build passes and every case of each planted one fails.

--pipelines N: N runs of `cli.pipeline.run_full_pipeline` on the IDR
sphere of `chip_smoke.py`'s phase 12 (`--steps` steps, mesh at 512), one
JSON line each with the mesh's median vertex radius about the sphere's
centre and phase 12's bound, the world radius less one voxel. `--loss`
picks what the training's loss runs on the card (`LOSSES`): the kernels,
the float32 plain version (its prefix `torch.cumsum`, on the card CUB's
chained scan) or the plain version fed the kernels' prefix order.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import neus_loss
from ..testing import loss_batch as lb

PACKAGE = Path(__file__).resolve().parents[1]
EIKONAL_LINE = "const float ge = eg * 2.f * (gn - 1.f) / gn;"
# fault -> (the line it edits, standing once in csrc/neus_loss.cu; the
# planted line)
PLANTS = {
    "eikonal": (EIKONAL_LINE, "const float ge = 0.f;"),
    "scan_shift": ("    lw_s[l] = lw;\n", "    lw_s[(l + 1) % kTile] = lw;\n"),
}
TRAIN_STEPS = 440
SPHERE = dict(n_views=16, width=256, height=256, radius=0.25)
WORLD_CENTER = np.array([0.2, -0.1, 0.3])
LOSSES = {
    "kernels": neus_loss.neus_loss,
    "plain": neus_loss.plain,
    "plain_twin": lambda *a: neus_loss.plain(
        *a, prefix=neus_loss.prefix_twin),
}


def plant(source: str, fault: str = "eikonal") -> str:
    """The kernels' source with the fault `fault` of `PLANTS` planted:
    `eikonal` sets the eikonal term's gradient to 0, `scan_shift` shifts
    the scan's logs by one slot."""
    line, planted_line = PLANTS[fault]
    if source.count(line) != 1:
        raise ValueError(f"the line that {fault} edits is not in the "
                         "source exactly once")
    return source.replace(line, planted_line)


def main_path_arguments(dev):
    """The arguments of the `neus_loss` call of the step after 440 default
    steps at full width; the step is undone."""
    from ..config import TestbedConfig
    from ..testing.synthetic import sphere_dataset
    from ..train.trainer import Trainer

    ds = sphere_dataset(**SPHERE, device=dev)
    tr = Trainer(ds, TestbedConfig(), device=dev)
    for _ in range(TRAIN_STEPS):
        tr.train_step()
    state = tr._snapshot_state()
    _, (args,) = lb.capture_call(tr.train_step_async)
    tr._restore(state)
    return (*[x.detach() for x in args[:5]], *args[5:])


def hold(args_path: Path, build: str) -> bool:
    """Each case through `hold_against_float64`, one JSON line each;
    True where every case passed, False where every case failed."""
    dev = resolve_device("cuda")
    cases = [("main path", torch.load(args_path, weights_only=False,
                                      map_location=dev))]
    oks = []
    for label, args in cases + lb.edge_case_calls(dev):
        rep = lb.hold_against_float64(args, label)
        oks.append(rep["ok"])
        grads = rep["kernel"]["grads"]
        print(json.dumps({
            "build": build, "case": label, "ok": rep["ok"],
            "failed": rep["failed"], "scan": rep["scan"],
            "off_share": {k: e.get("off_share") for k, e in grads.items()},
            "worst_share_of_largest": {
                k: e["max_abs_err"] / e["scale"] if e["scale"] else 0.0
                for k, e in grads.items()}}), flush=True)
    return all(oks) if build == "real" else not any(oks)


def planted(dev) -> bool:
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        args_path = root / "main_path.pt"
        torch.save(main_path_arguments(dev), args_path)
        real = hold(args_path, "real")
        fails = {}
        for fault in PLANTS:
            pkg = root / fault / PACKAGE.name
            shutil.copytree(PACKAGE, pkg,
                            ignore=shutil.ignore_patterns("__pycache__"))
            cu = pkg / "csrc" / "neus_loss.cu"
            cu.write_text(plant(cu.read_text(), fault))
            fails[fault] = subprocess.run(
                [sys.executable, "-m", f"{PACKAGE.name}.tools.loss_check",
                 "--hold", str(args_path), "--fault", fault],
                cwd=pkg.parent).returncode == 0
    print(json.dumps({"real_build_passes": real,
                      "planted_build_fails_every_case": fails}), flush=True)
    return real and all(fails.values())


def pipelines(n: int, steps: int, loss: str = "kernels") -> None:
    from ..cli import pipeline
    from ..mesh.writer import load_obj
    from ..testing.synthetic import write_idr_scene

    real = neus_loss.neus_loss
    neus_loss.neus_loss = LOSSES[loss]
    try:
        for i in range(n):
            with tempfile.TemporaryDirectory() as d:
                root = Path(d)
                scales = [(1.0 + 0.01 * v,) * 3
                          for v in range(SPHERE["n_views"])]
                r_world = write_idr_scene(str(root / "in"),
                                          world_center=WORLD_CENTER,
                                          albedo_scales=scales, **SPHERE)
                t0 = time.perf_counter()
                mesh = pipeline.run_full_pipeline(
                    str(root / "in"), str(root / "out"), max_steps=steps,
                    mesh_resolution=512, device="cuda")
                seconds = time.perf_counter() - t0
                with open(root / "out" / "prepared_data"
                          / "transform.json") as f:
                    voxel = 2.0 / 512 * json.load(f)["n2w"][0][0]
                V, _ = load_obj(mesh)
                radius = float(np.median(np.linalg.norm(V - WORLD_CENTER,
                                                        axis=1)))
            print(json.dumps({"run": i, "loss": loss, "steps": steps,
                              "median_radius": radius,
                              "bound": r_world - voxel,
                              "world_radius": r_world, "voxel": voxel,
                              "seconds": seconds}), flush=True)
    finally:
        neus_loss.neus_loss = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--planted", action="store_true")
    ap.add_argument("--pipelines", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--loss", choices=sorted(LOSSES), default="kernels")
    ap.add_argument("--hold", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--fault", default="eikonal", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("loss_check: no CUDA device")
    if a.hold:
        sys.exit(0 if hold(a.hold, f"planted {a.fault}") else 1)
    ok = planted(resolve_device("cuda")) if a.planted else True
    if a.pipelines:
        pipelines(a.pipelines, a.steps, a.loss)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
