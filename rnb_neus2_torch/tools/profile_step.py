"""Where a training step's time goes on the card.

    python -m rnb_neus2_torch.tools.profile_step [--warm 420] [--steps 16]
        [--stoch-corner-bwd K] [--sync-every N]

Trains the default config at full width, with the default stochastic
backward (K = 1; `--stoch-corner-bwd 0` takes the exact one, as the
testbed CLI's flag does) and the divergence guard on, on the seeded
synthetic sphere, as `chip_smoke.py` does, for `--warm` steps
(420: past step 411, from which every step runs all 14 levels, and past
step 256, where the occupancy refresh becomes subsampled and runs every
16 steps), times `--steps` steps, runs `--steps` more under
`torch.profiler` and prints one JSON line:

- unprofiled_wall_ms_per_step: host clock over the timed steps (each step
  ends in the host read-back of its metrics);
- wall_ms_per_step: the same over the profiled steps;
- device_busy_ms_per_step: the sum of all device activity durations;
- idle_share: 1 − busy / wall, over the profiled steps;
- kernels_per_step: device activities (kernels, copies, fills);
- phases: for each `record_function` span of the trainer
  (occupancy_refresh, sample_and_march, field_forward, loss, backward,
  grad_sum (the data-parallel trainer's sum over its replicas),
  optimizer, guard_snapshot) the host ms per step, and the device ms and
  activities per step of the kernels it launched (autograd runs the
  backward's kernels from its own thread; those count under `backward`;
  device time that no span claims is `other`). `guard_snapshot` is the
  divergence guard's on-device copy of the state after each healthy step;
- top_kernels: the 15 kernels with the most device time per step;
- backward_fills_and_copies: per step, the fill and copy kernels that the
  backward launched, by name (the table gradient is zeroed once, and its
  levels are added in place, so no per-level fill or copy belongs there);
- n_levels_run: the level bucket of each profiled step.

Each step is a `train_step` (its metrics read and passed through the
guard), unless `--sync-every N` runs each window as one
`train_steps(--steps, sync_every=N)` call, the CLI's schedule: metrics
read every N steps, and 16-step chunks from step 256 (`--warm 416
--steps 32 --sync-every 25`: two chunks and one read per window, as the
CLI runs after step 256). Then `n_levels_run` and `rays_per_batch` are
those of the window's reads, and the guard's snapshot is taken once per
read.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time

import torch
from torch.autograd import DeviceType

from ..config import TestbedConfig
from ..device import resolve_device
from ..testing.synthetic import sphere_dataset
from ..train.trainer import Trainer
from .bench_scatter import card_name_and_power

PHASES = ("occupancy_refresh", "sample_and_march", "field_forward", "loss",
          "backward", "grad_sum", "optimizer", "guard_snapshot")


def _root(evt):
    while evt.cpu_parent is not None:
        evt = evt.cpu_parent
    return evt


def _phase_of(evt) -> str:
    name = _root(evt).name
    if name in PHASES:
        return name
    if name.startswith("autograd::engine"):
        return "backward"
    return "other"


def profile_window(window, n: int) -> dict:
    """Run `window(n)` (n training steps, returning their metrics) under
    `torch.profiler` → the per-step breakdown of the module docstring:
    wall_ms_per_step, device_busy_ms_per_step, idle_share,
    kernels_per_step, phases, top_kernels, backward_fills_and_copies, and
    the window's `metrics`."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        metrics = window(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    host_ms = collections.Counter()
    device_us = collections.Counter()    # kernels attributed to a phase
    device_n = collections.Counter()     # their launches
    bwd_fill_copy = collections.Counter()  # backward fill/copy launches
    by_kernel = collections.Counter()    # every device activity, by name
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False):  # a span on the card
                continue
            by_kernel[evt.name] += evt.time_range.elapsed_us()
            n_kernels += 1
            continue
        if evt.name in PHASES and evt.cpu_parent is None:
            host_ms[evt.name] += evt.cpu_time_total / 1e3
        for k in evt.kernels:
            phase = _phase_of(evt)
            device_us[phase] += k.duration
            device_n[phase] += 1
            if phase == "backward" and any(w in k.name.lower()
                                           for w in ("fill", "copy")):
                bwd_fill_copy[k.name[:120]] += 1
    busy_us = sum(by_kernel.values())
    device_us["other"] += busy_us - sum(device_us.values())
    device_n["other"] += n_kernels - sum(device_n.values())
    busy_ms = busy_us / 1e3
    return {
        "wall_ms_per_step": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": n_kernels / n,
        "phases": {p: {"host_ms": host_ms[p] / n,
                       "device_ms": device_us[p] / 1e3 / n,
                       "device_activities": device_n[p] / n}
                   for p in PHASES + ("other",)},
        "top_kernels": [{"name": k[:120], "device_ms": us / 1e3 / n}
                        for k, us in by_kernel.most_common(15)],
        "backward_fills_and_copies": {k: c / n for k, c in
                                      bwd_fill_copy.most_common()},
        "metrics": metrics,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=420)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--stoch-corner-bwd", type=int, default=None,
                    help="K corners per sample in the hash-grid backward "
                    "(0 = exact 8-corner); default: the config's (1)")
    ap.add_argument("--sync-every", type=int, default=0,
                    help="run each window as train_steps(--steps, "
                    "sync_every=N) (0: a train_step per step)")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    card = card_name_and_power()
    cfg = TestbedConfig()
    if args.stoch_corner_bwd is not None:
        cfg = dataclasses.replace(cfg, network=dataclasses.replace(
            cfg.network, stoch_corner_bwd=args.stoch_corner_bwd))
    tr = Trainer(sphere_dataset(n_views=16, width=256, height=256,
                                radius=0.25, device=dev), cfg, device=dev)
    def window(k):
        if args.sync_every:
            return [tr.train_steps(k, sync_every=args.sync_every)]
        return [tr.train_step() for _ in range(k)]

    for _ in range(args.warm):
        tr.train_step()
    t0 = time.perf_counter()
    window(args.steps)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_window(window, args.steps)
    metrics = prof.pop("metrics")
    out = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "stoch_corner_bwd": cfg.network.stoch_corner_bwd,
        "sync_every": args.sync_every, "metric_reads": len(metrics),
        "steps": args.steps, "first_step": tr.step - args.steps,
        "n_levels_run": [m["n_levels_run"] for m in metrics],
        "rays_per_batch": [m["rays_per_batch"] for m in metrics],
        "unprofiled_wall_ms_per_step": plain_wall_ms / args.steps,
        **prof,
        "rolled_back": sum("rolled_back" in m for m in metrics),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
