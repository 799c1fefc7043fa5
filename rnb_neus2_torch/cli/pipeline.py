"""Pipeline orchestration: load → prepare → train → albedo scaling → train
→ mesh postprocess (port of `rnb_neus2_tpu/cli/pipeline.py`; reference:
rnb_neus2/pipeline.py).

The reference shells out to the testbed executable at each stage
(pipeline.py:27-53, a process boundary); here stages are in-process
function calls by default, with an optional subprocess mode
(`python -m rnb_neus2_torch.cli.testbed …`) for drop-in CLI parity. The
stages run on `device` (cuda unless the caller asks for the CPU), passed
to the testbed as `--device`. Stage
structure, flag plumbing, snapshot/mesh file layout, and step arithmetic
match the reference exactly:

- two-stage: stage 1 = ⌊2/3·max_steps⌋ with --save-snapshot, stage 2
  resumes with --opti-lights --save-mesh --free-memory to max_steps
  (pipeline.py:56-103);
- albedo mode: geometry-only warmup max(0.1·steps, 1000) with --no-albedo
  --save-mesh --resolution 512, multi-view albedo scaling against the
  phase-1 mesh, albedos/ swapped, then two-stage (pipeline.py:106-175);
- postprocess: keep the largest component by area, export obj
  (pipeline.py:178-219).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

from ..utils.meters import Logger


def run_testbed(scene_path, max_iter, flags, stage_name, logger=None,
                use_subprocess=False):
    """One testbed stage (reference pipeline.py:27-53)."""
    logger = logger or Logger()
    argv = ["--scene", str(scene_path) + "/", "--maxiter", str(max_iter),
            "--no-gui"] + list(flags)
    logger.info(f"{stage_name} command: testbed {' '.join(argv)}")
    if use_subprocess:
        cmd = [sys.executable, "-m", "rnb_neus2_torch.cli.testbed"] + argv
        result = subprocess.run(cmd, capture_output=True, text=True)
        for line in (result.stdout or "").strip().split("\n"):
            if line:
                logger.info(line)
        if result.returncode != 0:
            if result.stderr:
                logger.error(result.stderr)
            raise RuntimeError(
                f"{stage_name} failed with code {result.returncode}")
    else:
        from . import testbed
        rc = testbed.main(argv)
        if rc != 0:
            raise RuntimeError(f"{stage_name} failed with code {rc}")
    logger.info(f"{stage_name} completed")


def _latest_snapshot_step(out_dir):
    """(path, step) of output/snapshot_latest.msgpack, or (None, -1).
    Written atomically by the testbed's --snapshot-each; unreadable files
    (a crash mid-replace cannot happen, but a truncated disk write can)
    count as absent and fall back to the one-generation-back
    snapshot_latest.msgpack.prev the testbed keeps."""
    from ..train import snapshot as snap
    base = os.path.join(out_dir, "snapshot_latest.msgpack")
    for path in (base, base + ".prev"):
        if not os.path.exists(path):
            continue
        try:
            return path, int(snap.load_snapshot(path)["step"])
        except Exception:
            continue
    return None, -1


def run_two_stage(data_dir, max_steps, common_flags, resolution=1024,
                  no_albedo=False, extra_flags=None, logger=None,
                  use_subprocess=False, resume=False):
    """Two-stage training (reference pipeline.py:56-103). With
    `resume=True` (the JAX package's extra, no reference analog)
    completed stages are skipped and interrupted ones continue from the
    rolling --snapshot-each checkpoint instead of restarting."""
    logger = logger or Logger()
    iter_stage1 = int(max_steps * 2 / 3)
    out_dir = os.path.join(data_dir, "output")

    stage1_snap = os.path.join(out_dir, f"snapshot_{iter_stage1}.msgpack")
    latest, latest_step = (None, -1)
    if resume:
        latest, latest_step = _latest_snapshot_step(out_dir)
    skip_stage1 = resume and (os.path.exists(stage1_snap)
                              or latest_step >= iter_stage1)

    if skip_stage1:
        logger.info(f"Stage 1: already at step >= {iter_stage1}, skipping")
    else:
        stage1 = list(common_flags) + ["--save-snapshot"]
        if resume and latest and 0 <= latest_step < iter_stage1:
            logger.info(f"Stage 1: resuming from step {latest_step}")
            stage1 += ["--snapshot", latest]
        if no_albedo:
            stage1.append("--no-albedo")
        if extra_flags:
            stage1.extend(extra_flags)
        logger.info(f"Stage 1: {iter_stage1} iterations")
        run_testbed(data_dir, iter_stage1, stage1, "Stage 1", logger,
                    use_subprocess)

    final_snap = os.path.join(out_dir, f"snapshot_{max_steps}.msgpack")
    final_mesh = os.path.join(out_dir, f"mesh_{max_steps}.obj")
    if resume and os.path.exists(final_snap) and os.path.exists(final_mesh):
        logger.info("Stage 2: already complete, skipping")
        return

    snapshot = stage1_snap
    if not os.path.exists(snapshot):
        snapshot = os.path.join(data_dir, f"snapshot_{iter_stage1}.msgpack")
    if resume and latest and latest_step > iter_stage1:
        # mid-stage-2 checkpoint beats restarting stage 2 from its start
        logger.info(f"Stage 2: resuming from step {latest_step}")
        snapshot = latest
    if not os.path.exists(snapshot):
        raise RuntimeError(
            f"Snapshot not found after {iter_stage1} iterations")

    stage2 = list(common_flags) + [
        "--opti-lights", "--snapshot", snapshot,
        "--resolution", str(resolution),
        "--save-mesh", "--save-snapshot", "--free-memory",
    ]
    if no_albedo:
        stage2.append("--no-albedo")
    if extra_flags:
        stage2.extend(extra_flags)
    logger.info(f"Stage 2: {max_steps} iterations (opti-lights)")
    run_testbed(data_dir, max_steps, stage2, "Stage 2", logger,
                use_subprocess)


def run_with_albedo_scaling(data_dir, max_steps, common_flags,
                            resolution=1024, warmup_ratio=0.1,
                            n_samples=2000, logger=None,
                            use_subprocess=False):
    logger = logger or Logger()
    from ..io.albedo_scaling import (compute_albedo_scale_ratios,
                                     scale_and_save_albedos)

    warmup = max(int(max_steps * warmup_ratio), 1000)
    logger.info(f"=== Phase 1: Geometry only ({warmup} steps) ===")
    phase1 = list(common_flags) + ["--no-albedo", "--save-mesh",
                                   "--resolution", "512", "--free-memory"]
    run_testbed(data_dir, warmup, phase1, "Phase 1 (warmup)", logger,
                use_subprocess)

    out_dir = os.path.join(data_dir, "output")
    mesh_path = os.path.join(out_dir, f"mesh_{warmup}.obj")
    if not os.path.exists(mesh_path):
        cands = list(Path(out_dir).glob("mesh_*.obj"))
        if not cands:
            raise RuntimeError(f"Phase 1 mesh not found in {out_dir}")
        mesh_path = str(max(cands, key=lambda p: p.stat().st_mtime))

    logger.info("=== Albedo scaling ===")
    albedo_dir = os.path.join(data_dir, "albedos")
    scaled_dir = os.path.join(data_dir, "albedos_scaled")
    ratios = compute_albedo_scale_ratios(
        albedo_path=albedo_dir,
        camera_source=os.path.join(data_dir, "transform.json"),
        mesh_path=mesh_path, n_samples=n_samples, logger=logger)
    scale_and_save_albedos(albedo_dir, scaled_dir, ratios, logger=logger)
    shutil.rmtree(albedo_dir)
    os.rename(scaled_dir, albedo_dir)
    logger.info("Albedos scaled and replaced")

    shutil.rmtree(out_dir, ignore_errors=True)
    logger.info("=== Phase 3: Full training with scaled albedos ===")
    run_two_stage(data_dir, max_steps, common_flags, resolution=resolution,
                  logger=logger, use_subprocess=use_subprocess)


def postprocess_mesh(data_dir, output_mesh_path, logger=None):
    logger = logger or Logger()
    from ..mesh import postprocess, writer

    out_dir = os.path.join(data_dir, "output")
    files = list(Path(out_dir).glob("mesh_*.o*")) \
        if os.path.isdir(out_dir) else []
    if not files:
        files = list(Path(data_dir).glob("mesh_*.o*"))
    files = [f for f in files if f.suffix not in (".json", ".txt",
                                                  ".msgpack")]
    if not files:
        raise RuntimeError(f"No mesh files in {out_dir} or {data_dir}")
    mesh_file = max(files, key=lambda p: p.stat().st_mtime)
    logger.info(f"Post-processing: {mesh_file.name}")

    V, F = writer.load_obj(mesh_file)
    V2, F2, _, _ = postprocess.largest_component(V, F)
    if len(V2) < len(V):
        logger.info(f"Kept largest component ({len(V2)} vertices)")
    os.makedirs(os.path.dirname(output_mesh_path) or ".", exist_ok=True)
    writer.save_mesh(output_mesh_path, V2, F2)
    logger.info(f"Mesh exported to: {output_mesh_path}")
    shutil.rmtree(out_dir, ignore_errors=True)


def run_full_pipeline(input_path, output_dir, max_steps=10000,
                      mesh_resolution=1024, scaling_mode="auto",
                      sphere_scale=1.0, margin_px=20, warmup_ratio=0.1,
                      mask_weight=1.0, super_normal=False, use_l1=False,
                      use_rgb_plus=True, has_albedo=False,
                      albedo_sfm_path="", mask_sfm_path="",
                      mask_folder_path="", n_samples=2000, logger=None,
                      use_subprocess=False, testbed_path=None,
                      device="cuda"):
    """Complete pipeline (reference pipeline.py:222-305). `testbed_path`
    accepted for API parity (ignored: the testbed is this package)."""
    logger = logger or Logger()
    from ..device import resolve_device
    from ..io.dataloaders import load_data
    from ..io.prepare import prepare_testbed_data

    resolve_device(device)      # no card: fail before any stage runs

    logger.info(f"=== Loading data from {input_path} ===")
    data = load_data(input_path, albedo_sfm_path=albedo_sfm_path,
                     mask_sfm_path=mask_sfm_path,
                     mask_folder_path=mask_folder_path, logger=logger)

    data_dir = os.path.join(output_dir, "prepared_data")
    logger.info("=== Preparing testbed data ===")
    prepare_testbed_data(data, data_dir, logger, scaling_mode=scaling_mode,
                         sphere_scale=sphere_scale, margin_px=margin_px)

    common = ["--mask-weight", str(mask_weight), "--device", str(device)]
    if super_normal:
        common.append("--supernormal")
    if use_l1:
        common.append("--lone")
    if not use_rgb_plus:
        common.append("--no-rgbplus")

    if has_albedo:
        run_with_albedo_scaling(data_dir, max_steps, common,
                                resolution=mesh_resolution,
                                warmup_ratio=warmup_ratio,
                                n_samples=n_samples, logger=logger,
                                use_subprocess=use_subprocess)
    else:
        run_two_stage(data_dir, max_steps, common,
                      resolution=mesh_resolution, no_albedo=True,
                      logger=logger, use_subprocess=use_subprocess)

    output_mesh = os.path.join(output_dir, "mesh.obj")
    postprocess_mesh(data_dir, output_mesh, logger)
    logger.info("=== Pipeline complete ===")
    return output_mesh
