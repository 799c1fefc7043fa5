"""The PyTorch pipeline's CLI (port of the repo's `run_pipeline.py`),
argument-compatible with the reference's run_pipeline.py
(reference run_pipeline.py:23-92): same options, defaults and semantics,
plus `--device` (cuda unless cpu is asked for); `--testbed-path` is
accepted and ignored (the testbed is this package).

    python -m rnb_neus2_torch.cli.run_pipeline INPUT OUTPUT [options]
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        "rnb-neus2",
        description="Multi-view normal/albedo surface reconstruction "
                    "(PyTorch)")
    p.add_argument("input", help="cameras.npz dir, .npz, .sfm, or .json")
    p.add_argument("output", help="output directory")
    p.add_argument("--testbed-path", default="",
                   help="ignored (kept for reference CLI parity)")
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--mesh-resolution", type=int, default=1024)
    p.add_argument("--scaling-mode", default="auto",
                   choices=["auto", "pcd", "silhouettes", "silhouettes_v2",
                            "cameras", "none"])
    p.add_argument("--sphere-scale", type=float, default=1.0)
    p.add_argument("--margin-px", type=float, default=20)
    p.add_argument("--warmup-ratio", type=float, default=0.1)
    p.add_argument("--mask-weight", type=float, default=1.0)
    p.add_argument("--supernormal", action="store_true")
    p.add_argument("--l1", action="store_true")
    p.add_argument("--no-rgbplus", action="store_true")
    p.add_argument("--has-albedo", action="store_true")
    p.add_argument("--albedo-sfm-path", default="")
    p.add_argument("--mask-sfm-path", default="")
    p.add_argument("--mask-folder-path", default="")
    p.add_argument("--n-samples", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--subprocess", action="store_true",
                   help="run testbed stages as subprocesses (reference-style"
                        " process boundary)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    np.random.seed(args.seed)   # reference seeds numpy (run_pipeline.py:71)

    from .pipeline import run_full_pipeline

    run_full_pipeline(
        input_path=args.input,
        output_dir=args.output,
        max_steps=args.max_steps,
        mesh_resolution=args.mesh_resolution,
        scaling_mode=args.scaling_mode,
        sphere_scale=args.sphere_scale,
        margin_px=args.margin_px,
        warmup_ratio=args.warmup_ratio,
        mask_weight=args.mask_weight,
        super_normal=args.supernormal,
        use_l1=args.l1,
        use_rgb_plus=not args.no_rgbplus,
        has_albedo=args.has_albedo,
        albedo_sfm_path=args.albedo_sfm_path,
        mask_sfm_path=args.mask_sfm_path,
        mask_folder_path=args.mask_folder_path,
        n_samples=args.n_samples,
        use_subprocess=args.subprocess,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
