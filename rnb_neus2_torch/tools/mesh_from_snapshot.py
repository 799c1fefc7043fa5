"""Extract a mesh from a saved snapshot + Chamfer-L1 vs the composite GT
(port of the repository's `tools/mesh_from_snapshot.py`).

The reference's contract ends with output/mesh_<iter>.obj
(src/main.cu:455-461) and the pipeline's Chamfer postprocess; this runs
that tail from any snapshot without retraining, through the port's CLI
(`cli/testbed.main`), and writes the result to
<scene>/output/<out> as one JSON object, which it also prints.

    python -m rnb_neus2_torch.tools.mesh_from_snapshot --scene DIR \
        --snapshot PATH [--iter N] [--resolution 512] \
        [--gt-resolution 384] [--out NAME] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True)
    ap.add_argument("--snapshot", required=True)
    ap.add_argument("--iter", type=int, default=None,
                    help="default: the snapshot's own step (no retraining)")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--gt-resolution", type=int, default=384)
    ap.add_argument("--out", default="chamfer_from_snapshot.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..cli import testbed
    from ..mesh.metrics import chamfer_distance
    from ..mesh.writer import load_obj
    from ..testing.synthetic import composite_gt_mesh

    if args.iter is None:
        from ..train import snapshot as snap
        args.iter = int(snap.load_snapshot(args.snapshot)["step"])
        print(f"snapshot is at step {args.iter}; extracting there")

    t0 = time.time()
    rc = testbed.main(["--scene", args.scene, "--maxiter", str(args.iter),
                       "--no-gui", "--snapshot", args.snapshot,
                       "--save-mesh", "--resolution", str(args.resolution),
                       "--device", args.device])
    mesh_path = os.path.join(args.scene, "output", f"mesh_{args.iter}.obj")
    if rc != 0 or not os.path.exists(mesh_path):
        print(f"no mesh: testbed exited {rc}, {mesh_path} "
              f"{'exists' if os.path.exists(mesh_path) else 'is missing'}",
              file=sys.stderr)
        return rc or 1
    V, F = load_obj(mesh_path)
    Vg, Fg = composite_gt_mesh(args.gt_resolution)
    Vg = (Vg - 0.5) / 0.5  # unit-cube -> world
    ch = chamfer_distance(V, F, Vg, Fg)
    result = {"snapshot": args.snapshot, "iter": args.iter,
              "resolution": args.resolution,
              "mesh_vertices": int(len(V)),
              "seconds": round(time.time() - t0, 1),
              **{k: round(v, 6) for k, v in ch.items()}}
    out = os.path.join(args.scene, "output", args.out)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
