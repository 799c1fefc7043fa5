"""Testbed CLI (port of `rnb_neus2_tpu/cli/testbed.py`), flag-compatible
with the reference executable (src/main.cu:90-258):

  python -m rnb_neus2_torch.cli.testbed --scene DIR --maxiter N [--no-gui]
      [--mask-weight W] [--lone] [--supernormal] [--no-rgbplus] [--bce]
      [--relu] [--opti-lights] [--no-albedo] [--save-mesh]
      [--save-snapshot] [--snapshot PATH] [--resolution R] [--save-each K]
      [--fractional-training N] [--free-memory] [--network CONFIG]
      [--disable-snap-to-center] [--trace-steps N [--trace-dir D]]
      [--render-path PATH.json [--render-frames N] [--render-scale S]]
      [--device cuda|cpu] ...

Every flag of the JAX CLI parses. The run is on the card unless `--device
cpu` asks for the CPU. A flag whose feature the port does not have exits
with code 2 and names it: `--n-chips` > 1 (data parallelism) and any
configuration `check_ported` refuses. So does a scene whose transform.json
says another `aabb_scale` than the configuration (`check_scene`). Nothing
else runs in their place.

Behaviour (main.cu:283-470): L2 unless --lone, RGB+ unless --no-rgbplus;
`iteration=N loss=X` every 100 steps (main.cu:447-449); --snapshot
resumes the training state (main.cu:304-314); the mesh goes to
<scene>/output/mesh_<maxiter>.obj at --resolution, the snapshot to
<scene>/output/snapshot_<maxiter>.msgpack; --snapshot-each N keeps a
rolling output/snapshot_latest.msgpack (and .prev), written off the loop,
and skips a generation whose eikonal EMA creeps or whose loss diverged.

The loop is the JAX CLI's: it trains to the next of maxiter, the next
multiple of 100, the next --save-each and --snapshot-each step and the
trace's start with `Trainer.train_steps(n, sync_every=25)`, which reads
the metrics once per 25 dispatched steps (or per two 16-step chunks after
step 256) and at the target. --trace-steps N profiles N steps from step
min(max(256, start + 32), maxiter − N) with `torch.profiler` (the card's
kernels and the trainer's spans) into a Chrome trace,
<trace-dir or scene/output/trace>/trace.json. --render-path renders
--render-frames views along a camera-path JSON (`render/camera_path.py`)
after training, as 8-bit RGBA PNGs in <scene>/output/flythrough/.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser("testbed",
                                description="PyTorch RNb-NeuS2 testbed")
    p.add_argument("--scene", required=True)
    p.add_argument("--maxiter", type=int, default=10000)
    p.add_argument("--network", default="")
    p.add_argument("--mask-weight", type=float, default=1.0)
    p.add_argument("--save-mesh", action="store_true")
    p.add_argument("--save-snapshot", action="store_true")
    p.add_argument("--snapshot", default="")
    p.add_argument("--no-albedo", action="store_true")
    p.add_argument("--lone", action="store_true", help="L1 loss")
    p.add_argument("--supernormal", action="store_true")
    p.add_argument("--opti-lights", action="store_true")
    p.add_argument("--no-rgbplus", action="store_true")
    p.add_argument("--bce", action="store_true")
    p.add_argument("--relu", action="store_true")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--fractional-training", type=int, default=None)
    p.add_argument("--save-each", type=int, default=0)
    p.add_argument("--free-memory", action="store_true")
    p.add_argument("--no-gui", action="store_true")
    p.add_argument("--disable-snap-to-center", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    # the JAX package's extras (not in the reference)
    p.add_argument("--n-chips", type=int, default=0,
                   help="0 or 1: one device; more is data parallelism, "
                        "which is not ported")
    p.add_argument("--target-batch-size", type=int, default=0,
                   help="sample budget per step (0 = reference 2^18)")
    p.add_argument("--occ-grid-size", type=int, default=0,
                   help="occupancy grid resolution (0 = reference 128)")
    p.add_argument("--n-ladder", type=int, default=0,
                   help="ray-march ladder length (0 = reference 1024)")
    p.add_argument("--cone-angle", type=float, default=None,
                   help="ray-march cone angle (default: the reference rule, "
                        "0 for aabb_scale <= 1)")
    p.add_argument("--stoch-corner-bwd", type=int, default=None,
                   help="K>0: unbiased K-corner stochastic hash-grid "
                        "backward; 0 = exact 8-corner (default: config)")
    p.add_argument("--fp16-grad-emu", type=int, default=None,
                   help="1/0: the reference's fp16 loss-gradient chain "
                        "(default: config)")
    p.add_argument("--rgbplus-ref-jacobian", action="store_true",
                   help="the reference's RGB+ L2 jacobian inside the "
                        "clamped region (LossConfig.rgbplus_ref_jacobian)")
    p.add_argument("--dense-max-entries-log2", type=int, default=0,
                   help="densify hash-grid levels whose full table fits in "
                        "2^N entries (0 = reference 2^19 cap)")
    p.add_argument("--occ-refresh-levels", type=int, default=0,
                   help="cap the levels of occupancy-refresh density "
                        "evaluations (0 = all levels)")
    p.add_argument("--rollover-grad-emu", type=int, default=None,
                   help="1/0: the reference's rollover-padded backward "
                        "(default: config)")
    p.add_argument("--adapt-to-kept", type=int, default=None,
                   help="1/0: adaptive rays/batch divides by the "
                        "contributing sample count (default: config)")
    p.add_argument("--stab-window", nargs=3, type=float, default=None,
                   metavar=("START", "END", "SCALE"),
                   help="multiply the Adam update by SCALE for steps in "
                        "[START, END) (default: config)")
    p.add_argument("--no-stab-window", action="store_true",
                   help="disable the stabilizer window")
    p.add_argument("--snapshot-each", type=int, default=0,
                   help="write output/snapshot_latest.msgpack every N "
                        "steps (atomic; resume point)")
    p.add_argument("--trace-steps", type=int, default=0,
                   help="a device trace of N steps")
    p.add_argument("--trace-dir", default="",
                   help="trace output dir (with --trace-steps)")
    p.add_argument("--render-path", default="",
                   help="camera-path JSON for a fly-through")
    p.add_argument("--render-frames", type=int, default=60,
                   help="frames along --render-path")
    p.add_argument("--render-scale", type=float, default=1.0,
                   help="internal render scale for the fly-through")
    return p


def default_network_config() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "configs", "nerf", "base.json")


def make_config(args):
    from ..config import RenderFlags, TestbedConfig

    cfg_path = args.network or default_network_config()
    if not os.path.isabs(cfg_path) and not os.path.exists(cfg_path):
        cand = os.path.join(os.path.dirname(default_network_config()),
                            cfg_path)
        if os.path.exists(cand):
            cfg_path = cand
    cfg = TestbedConfig.from_network_json(cfg_path)
    flags = RenderFlags(
        apply_l2=not args.lone,
        apply_rgbplus=not args.no_rgbplus,
        apply_supernormal=args.supernormal,
        apply_relu=args.relu,
        apply_bce=args.bce,
        apply_light_opti=args.opti_lights,
        apply_no_albedo=args.no_albedo,
    )
    loss = dataclasses.replace(cfg.loss, mask_loss_weight=args.mask_weight)
    if args.fp16_grad_emu is not None:
        loss = dataclasses.replace(
            loss, fp16_grad_emulation=bool(args.fp16_grad_emu))
    if args.rollover_grad_emu is not None:
        loss = dataclasses.replace(
            loss, rollover_grad_emulation=bool(args.rollover_grad_emu))
    if args.rgbplus_ref_jacobian:
        loss = dataclasses.replace(loss, rgbplus_ref_jacobian=True)
    train_kw = dict(max_steps=args.maxiter, seed=args.seed,
                    fractional_from_step=args.fractional_training)
    if args.target_batch_size:
        train_kw["target_batch_size"] = args.target_batch_size
        train_kw["initial_rays_per_batch"] = max(
            args.target_batch_size // 32, 64)
    if args.occ_grid_size:
        train_kw["occ_grid_size"] = args.occ_grid_size
    if args.occ_refresh_levels:
        train_kw["occ_refresh_levels"] = args.occ_refresh_levels
    if args.adapt_to_kept is not None:
        train_kw["adapt_to_kept"] = bool(args.adapt_to_kept)
    if args.no_stab_window:
        train_kw["stab_scale"] = 1.0
    elif args.stab_window is not None:
        s0, s1, sc = args.stab_window
        train_kw.update(stab_start=int(s0), stab_end=int(s1),
                        stab_scale=float(sc))
    train = dataclasses.replace(cfg.train, **train_kw)
    march = cfg.march
    if args.n_ladder:
        march = dataclasses.replace(march, n_ladder=args.n_ladder)
    if args.cone_angle is not None:
        march = dataclasses.replace(march, cone_angle=args.cone_angle)
    if args.disable_snap_to_center:
        march = dataclasses.replace(march, snap_to_pixel_centers=False)
    network = cfg.network
    if args.stoch_corner_bwd is not None:
        network = dataclasses.replace(
            network, stoch_corner_bwd=args.stoch_corner_bwd)
    grid = cfg.grid
    if args.dense_max_entries_log2:
        grid = dataclasses.replace(
            grid, dense_max_entries_log2=args.dense_max_entries_log2)
    return dataclasses.replace(cfg, flags=flags, loss=loss, train=train,
                               march=march, network=network, grid=grid)


def unported_flag(args) -> str:
    """The feature a flag asks for that the port lacks, or ''."""
    if args.n_chips > 1:
        return (f"--n-chips {args.n_chips}: data parallelism over several "
                "devices is not ported")
    return ""


def run(args) -> int:
    from ..device import resolve_device
    from ..io.dataset import load_transform_json
    from ..mesh import extract, writer
    from ..train import snapshot as snap
    from ..train.trainer import Trainer, check_ported, check_scene
    from ..utils.diagnostics import profile_trace
    from ..utils.meters import Logger

    logger = Logger()
    cfg = make_config(args)
    try:
        refusal = unported_flag(args)
        if refusal:
            raise ValueError(refusal)
        check_ported(cfg)
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        logger.error(f"not run: {e}")
        return 2
    scene = args.scene.rstrip("/")
    out_dir = os.path.join(scene, "output")
    os.makedirs(out_dir, exist_ok=True)

    dataset = load_transform_json(scene, device)
    try:
        check_scene(dataset.meta, cfg)
    except ValueError as e:
        logger.error(f"not run: {e}")
        return 2
    logger.info(f"Loaded {dataset.n_images} views "
                f"{dataset.resolution[0]}x{dataset.resolution[1]} "
                f"on {device}")
    trainer = Trainer(dataset, cfg, device=device)

    if args.snapshot:
        if not os.path.exists(args.snapshot):
            logger.error(f"Snapshot path {args.snapshot} does not exist.")
            return 1
        # this run's flags, the snapshot's state
        snap.restore_trainer(trainer, snap.load_snapshot(args.snapshot))
        logger.info(f"Loaded snapshot at step {trainer.step}")

    def save_mesh_now(tag):
        t0 = time.perf_counter()
        m = extract.extract_mesh(trainer.field, trainer.inference_params,
                                 resolution=args.resolution,
                                 meta=dataset.meta)
        t1 = time.perf_counter()
        path = os.path.join(out_dir, f"mesh_{tag}.obj")
        writer.save_mesh(path, m["V"], m["F"], m["N"], m["C"])
        logger.info(f"Saved mesh to {path} "
                    f"({len(m['V'])} verts, {len(m['F'])} faces; extract "
                    f"{t1 - t0:.3f} s, write {time.perf_counter() - t1:.3f} "
                    "s)")

    max_steps = args.maxiter
    snap_writer = None
    trace_at = None
    if args.trace_steps:
        # a mid-run window, past the occupancy warm-up, so that the
        # steady-state step is what the trace shows
        trace_at = min(max(256, trainer.step + 32),
                       max(max_steps - args.trace_steps, 0))
    start_step, t0 = trainer.step, time.perf_counter()
    while trainer.step < max_steps:
        if trace_at is not None and trainer.step >= trace_at:
            tdir = args.trace_dir or os.path.join(out_dir, "trace")
            n = min(args.trace_steps, max_steps - trainer.step)
            t_trace = time.perf_counter()
            with profile_trace(tdir, device):
                trainer.train_steps(n, sync_every=max(n, 1))
            logger.info(f"Wrote a {n}-step device trace to "
                        f"{os.path.join(tdir, 'trace.json')} in "
                        f"{time.perf_counter() - t_trace:.3f} s")
            trace_at = None
            continue
        # to the next log, mesh, snapshot or trace boundary, with the
        # metrics read once per 25 steps
        boundaries = [max_steps, (trainer.step // 100 + 1) * 100]
        if args.save_each:
            boundaries.append(
                (trainer.step // args.save_each + 1) * args.save_each)
        if args.snapshot_each:
            boundaries.append((trainer.step // args.snapshot_each + 1)
                              * args.snapshot_each)
        if trace_at is not None and trace_at > trainer.step:
            boundaries.append(trace_at)
        trainer.train_steps(min(boundaries) - trainer.step, sync_every=25)
        step = trainer.step
        if step % 100 == 0 or step >= max_steps:
            # reference `iteration=N loss=X` (main.cu:447-449), plus the
            # JAX package's extra meters
            logger.info(f"iteration={step} "
                        f"loss={trainer.loss_ema.value:.6f} "
                        f"mask={trainer.mask_ema.value:.4f} "
                        f"ek={trainer.ek_ema.value:.4f} "
                        f"rays={trainer.n_rays}")
        if args.save_each and step % args.save_each == 0 \
                and step < max_steps:
            save_mesh_now(step)
        if args.snapshot_each and step % args.snapshot_each == 0 \
                and step < max_steps:
            latest = os.path.join(out_dir, "snapshot_latest.msgpack")
            loss_now = trainer.loss_ema.value
            if not trainer.ek_healthy():
                # geometry-sick under a healthy loss: keep the last good
                # generation
                logger.error(f"iteration={step}: ek EMA "
                             f"{trainer.ek_ema.value:.4g} is past the guard "
                             "ceiling; skipping rolling snapshot")
            elif not trainer.loss_ema._initialized or \
                    not (loss_now == loss_now and loss_now < 1e6):
                # diverged, or no healthy read since the (re)start
                logger.error(f"iteration={step}: loss={loss_now} is "
                             "divergent; skipping rolling snapshot")
            else:
                if snap_writer is None:
                    snap_writer = snap.AsyncSnapshotWriter()
                snap_writer.submit(latest, trainer, logger)
    seconds = time.perf_counter() - t0
    n = trainer.step - start_step
    logger.info(f"Trained {n} steps in {seconds:.3f} s "
                f"({1e3 * seconds / max(n, 1):.2f} ms/step, "
                f"{trainer.metric_reads} metric reads)")

    if snap_writer is not None:
        snap_writer.join()
    if args.save_mesh:
        save_mesh_now(args.maxiter)
    if args.save_snapshot:
        path = os.path.join(out_dir, f"snapshot_{args.maxiter}.msgpack")
        logger.info("Saving Snapshot !")
        logger.info(path)
        t0 = time.perf_counter()
        size = snap.save_snapshot(path, trainer)
        logger.info(f"Wrote {size} bytes in "
                    f"{time.perf_counter() - t0:.3f} s")
    if args.render_path:
        render_path(args, trainer, dataset, cfg, out_dir, logger)
    return 0


def render_path(args, trainer, dataset, cfg, out_dir, logger) -> None:
    """--render-path: `--render-frames` views along the camera path, each
    through view 0's intrinsics, as 8-bit RGBA PNGs."""
    from ..io.image_io import save_image
    from ..render.camera_path import CameraPath
    from ..render import renderer

    frames_dir = os.path.join(out_dir, "flythrough")
    os.makedirs(frames_dir, exist_ok=True)
    t0 = time.perf_counter()
    frames = renderer.render_path(
        trainer.field, trainer.inference_params, dataset.cameras,
        trainer.occ.bitfield, CameraPath.load(args.render_path),
        args.render_frames, cfg.march, render_scale=args.render_scale)
    for i, rgba in enumerate(frames):
        save_image(rgba, os.path.join(frames_dir, f"{i:05d}.png"),
                   bit_depth=8)
    logger.info(f"Rendered {args.render_frames} fly-through frames to "
                f"{frames_dir} in {time.perf_counter() - t0:.3f} s")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
