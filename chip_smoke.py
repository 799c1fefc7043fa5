#!/usr/bin/env python3
"""Drive the PyTorch port (`rnb_neus2_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines with `elapsed_s`:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Exits non-zero without a CUDA device or without the package
   beside this script.
2. build: every kernel library of the main path, built with nvcc from the
   sources in the checkout, and the point-to-mesh library of the Chamfer
   metric (`native/raycast.cc`, g++), all at once (one compiler per
   library), with `-Xptxas -v` output.
3. kernel vs plain: each kernel's wrapper on card tensors at the main
   path's shapes against its plain PyTorch version; max abs error ≤
   1e-5·(1 + max |plain|) (float atomics sum in another order), and every
   row that no element touches exactly 0.0 in both. (A touched entry whose
   terms cancel may come out 0.0 in one summation order and not in
   another: on the card both the kernels and `index_add_` sum in a varying
   order.) `hash_grad_small`: n = 2^21 and 2^18 at the 4096- and
   13,824-row levels 0 and 1, a ragged and an empty input, and dense
   tables of 29,792 and 32,768 rows, over one block's shared memory.
   `scatter_add`: n = 2^18 at the 2^19-row hashed tables and the dense
   39,304-, 125,000- and 373,248-row levels 2-4, n = 2^21, a ragged and
   an empty input, and F = 1. Some indices fall outside the table. Then
   each kernel's in-place entry point (`bench_scatter.check_in_place`)
   at n = 2^18 into a (S, F) view with sentinel rows on both sides, at
   F = 1, 2 and 4, on a zeroed view, a random one and one that starts 4
   bytes past an 8-byte boundary (F = 2 and 4 aligned take the float2
   vector path, the others 32-bit atomics), and on the padded hot-row
   input: the sentinels and untouched rows keep their bits.
4. timing: CUDA events over 50 launches after warm-up, with the stream held
   by a sleep kernel while the launches queue, so that host overhead does
   not count: the allocating wrapper (`ms`, a zeroed table per launch),
   the in-place entry point (`ms_into`, the main path's), the plain
   version, one PyTorch library call (`index_add_`) and the bounds (bytes
   over 3.35 TB/s vs float adds over 67 TFLOP/s): `bound_ms` for the
   allocating call, n·(4 + 4F) + S·F·4 bytes, and `bound_into_ms` for the
   in-place one, n·(4 + 4F) bytes plus a read and a write of each row
   that this input adds to. On uniform
   random indices here, and after phase 7 on the inputs that the trained
   field's next step gives each level, K = 1 and exact, which the kernels
   line reports (per step: the sum over the kernel's levels); there also,
   for `hash_grad_small`, the other kernel on the
   same inputs (`ms_into_scatter_add`), each kernel's fixed cost (one
   launch on its first level's indices with zero values, which add
   nothing: `ms_into_zero_values`), and one line per level with the share of
   elements whose row repeats within its warp of 32 consecutive elements
   (the atomics the aggregation can remove). Each input is first checked
   against the plain version as in phase 3.
5. probes: every section of `rnb_neus2_torch.tools.bench_scatter` (the
   five TPU scatter-add probes' sweeps), both kernels at every point,
   checked exactly against the plain version; a mismatch raises.
6. agreement: one training loss and its gradients at a small config on the
   card against the same on the CPU (the CPU port is held against the JAX
   package by tests/test_torch_*.py); then the default config's K = 1
   encode backward on the card and the CPU with the same positions and
   cotangents: the picked corner of every sample at every level is the
   same, and the table gradients agree as in phase 3.
7. train: the main path — `Trainer.train_step` at the full default width
   (14 levels x F=2, 2^19 hashed tables, 64-wide MLPs, 2^18-sample batch,
   128^3 occupancy grid) of the unmodified default config: the default
   stochastic backward (stoch_corner_bwd=1) and the divergence guard on,
   which checkpoints every healthy step on the card. From init for 440
   steps on a seeded synthetic sphere, so that the last 29 run all 14
   levels; then the exact backward (only stoch_corner_bwd=0 changed) for
   20 steps. Launch counts are zeroed just before each and read just
   after: `hash_grad_small` twice a step (levels 0 and 1), `scatter_add`
   once for each other level the step runs. Each run prints the guard's
   counters (rollbacks, degraded, the loss and eikonal floors); a
   rollback on the sphere is reported, not hidden.
8. rollback: one NaN color loss fed to the default run's guard
   (`_consume_metrics`) rolls it back. Parameters, Adam moments and step
   counts, EMA parameters, the occupancy grid and the error map must
   equal the good snapshot bit for bit, and the generator's next draws
   must differ from a replay of the snapshot's. Then 16 more steps: every
   one accepted, the color loss finite, and its mean below the loss EMA
   that the snapshot restored (the trailing average: one step's loss at
   convergence is noise).
9. mesh: the default run's EMA field exported on the card. At res 192 its
   fine volume goes through the card's marching cubes and, fetched to the
   host, through the numpy one: V within 1e-5, F equal. Then
   `extract_mesh` at res 512 and 1024 (the CLI and pipeline defaults):
   V and F counts, active blocks, seconds per stage and
   `torch.cuda.max_memory_allocated`; the sphere's vertices lie within a
   voxel of radius 0.25 (median), and the 512 OBJ written to a temporary
   directory reads back with `load_obj`.
10. chamfer: the protocol of tests/test_chamfer_gate.py on the card, guard
   on: the composite scene at 12 views of 80x96, 8 levels, top resolution
   256, a 2^15 table, n_ladder 1024, 900 steps, extraction at 128 against
   `composite_gt_mesh(192)`. The same absolute gate: chamfer_l1 < 0.05
   and completeness < 0.04.

Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Any failed phase raises and the script exits
non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import signal
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
WALL_LIMIT_S = 1150            # the process is killed past this
TRAIN_STEPS = 440              # bucket 14 from step 411
FULL_LEVEL_STEPS = 20          # at least this many final steps at 14 levels
EXACT_STEPS = 20
LOG_EVERY = 20


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **kw}), flush=True)


def build_all(build, modules) -> None:
    """Phase 2: one compiler per library, all started together."""
    with ThreadPoolExecutor(len(modules)) as pool:
        list(pool.map(lambda mod: mod._library(), modules))
    for mod in modules:
        _, rec = build._LOADED[mod.LIBRARY]
        print(rec["log"], flush=True)
        log("build", library=rec["path"], built=rec["built"],
            seconds=rec["seconds"])


def check_cases(torch, bench, name, fn, plain, dev, cases) -> float:
    """Phase 3 for one kernel over (n, S, F) cases
    (`bench_scatter.check_against_plain`, which raises on a mismatch).
    Returns the largest abs error seen."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0.0
    for n, S, F in cases:
        idx = torch.randint(0, S, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx = torch.where(idx % 7 == 0, idx + 1, idx)   # rows left untouched
        out_of_range = torch.rand(n, generator=gen, device=dev) < 0.01
        idx = torch.where(out_of_range, idx + S * (idx % 2 * 2 - 1), idx)
        cf = torch.randn(n, F, generator=gen, device=dev)
        got = fn(idx, cf, S)
        torch.cuda.synchronize()
        want = plain(idx, cf, S)
        err = bench.check_against_plain(name, got, want, idx, S,
                                        exact=False)
        keep = (idx >= 0) & (idx < S)
        n_zero = int((torch.bincount(idx[keep], minlength=S) == 0).sum())
        log("kernel_vs_plain", kernel=name, n=n, S=S, F=F, max_abs_err=err,
            tol=1e-5 * (1.0 + float(want.abs().max())),
            untouched_rows=n_zero, dropped=int((~keep).sum()))
        if n and n_zero == 0:
            raise AssertionError("no untouched rows to check exact zeros")
        worst = max(worst, err)
    return worst


def check_in_place_cases(torch, bench, name, mod, fn_into, dev, S) -> float:
    """Phase 3, in place, at n = 2^18 into a (S, F) view of a larger
    buffer: F = 1, 2, 4 on a zeroed, a random and a misaligned view, and
    the padded hot row. Returns the largest abs error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n = 1 << 18
    worst = 0.0
    for F in (1, 2, 4):
        for mode in ("zeroed", "nonzero", "misaligned"):
            idx = torch.randint(-S // 50, S + S // 50, (n,), generator=gen,
                                device=dev, dtype=torch.int32)
            idx = torch.where(idx % 5 == 0, idx + 1, idx)
            v = torch.randn(n, F, generator=gen, device=dev)
            buf, view = bench.in_place_view(S, F, dev, gen,
                                            nonzero=mode == "nonzero",
                                            misaligned=mode == "misaligned")
            before = mod.launches
            err = bench.check_in_place(name, fn_into, buf, view, idx, v)
            if mod.launches != before + 1:
                raise AssertionError(f"{name} in place did not launch")
            log("kernel_vs_plain_in_place", kernel=name, n=n, S=S, F=F,
                view=mode, vector_path=F % 2 == 0 and mode != "misaligned",
                max_abs_err=err)
            worst = max(worst, err)
    idx = torch.randint(0, S, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    v = torch.randn(n, 2, generator=gen, device=dev)
    pad = torch.arange(n, device=dev) >= n // 2
    idx[pad] = 1234
    v[pad] = 0.0
    buf, view = bench.in_place_view(S, 2, dev, gen)
    err = bench.check_in_place(name, fn_into, buf, view, idx, v)
    log("kernel_vs_plain_in_place", kernel=name, n=n, S=S, F=2,
        view="padded hot row", max_abs_err=err)
    return max(worst, err)


def check_kernels_vs_plain(torch, bench, kernels, dev) -> dict:
    """Phase 3. Returns each kernel's largest abs error."""
    hgs, sca = kernels["hash_grad_small"], kernels["scatter_add"]
    n1, n8 = 1 << 18, 1 << 21
    errs = {
        "hash_grad_small": check_cases(
            torch, bench, "hash_grad_small", hgs.grad_small, hgs.plain, dev,
            [(n8, 4096, 2), (n8, 13824, 2), (n1, 4096, 2), (n1, 13824, 2),
             (1_000_003, 13824, 2), (0, 4096, 2), (n8, 32768, 2),
             (1_000_003, 29792, 2)]),
        "scatter_add": check_cases(
            torch, bench, "scatter_add", sca.scatter_add, sca.plain, dev,
            [(n1, 1 << 19, 2), (n1, 39304, 2), (n1, 125000, 2),
             (n1, 373248, 2), (n8, 1 << 19, 2), (262_147, 1 << 19, 2),
             (0, 1 << 19, 2), (n1, 1 << 19, 1)]),
    }
    for name, S in (("hash_grad_small", 13824), ("scatter_add", 1 << 19)):
        errs[name] = max(errs[name], check_in_place_cases(
            torch, bench, name, kernels[name], bench.KERNELS_INTO[name], dev,
            S))
    return errs


def time_inputs(torch, bench, name, mod, dev, card, inputs,
                main_path=False) -> dict:
    """Phase 4 for one kernel module over (S, idx, v) inputs, each first
    checked against the plain version as in phase 3. On the `main_path`
    inputs, for `hash_grad_small`, also `scatter_add`'s in-place entry
    point on the same inputs (`ms_into_scatter_add`). Returns the sums
    over the inputs, and the largest abs error."""
    fn = bench.KERNELS[name]
    fn_into = bench.KERNELS_INTO[name]
    other = (bench.KERNELS_INTO["scatter_add"]
             if main_path and name == "hash_grad_small" else None)
    plain = mod.plain
    keys = ("ms", "ms_into", "plain_ms", "library_ms", "bound_ms",
            "bound_into_ms")
    keys += ("ms_into_scatter_add",) if other else ()
    tot = dict.fromkeys(keys, 0.0)
    tot["max_abs_err"] = 0.0
    for S, idx, v in inputs:
        n, F = v.shape
        err = bench.check_against_plain(name, fn(idx, v, S),
                                        plain(idx, v, S), idx, S,
                                        exact=False)
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        out = torch.zeros(S, F, device=dev)
        row = {
            "ms": bench.time_ms(lambda: fn(idx, v, S)),
            "ms_into": bench.time_ms(lambda: fn_into(out, idx, v)),
            "plain_ms": bench.time_ms(lambda: plain(idx, v, S)),
            "library_ms": bench.time_ms(lambda: torch.zeros(
                S, F, device=dev).index_add_(0, idx, v)),
        }
        if other:
            row["ms_into_scatter_add"] = bench.time_ms(
                lambda: other(out, idx, v))
        row["bound_ms"], bound_by = bench.scatter_bound(n, S, F)
        row["bound_into_ms"], _ = bench.scatter_bound_into(
            n, F, bench.rows_added_to(idx, v, S))
        log("timing", kernel=name, n=n, S=S, F=F, card=card,
            distinct_rows=int(torch.unique(idx).numel()),
            zero_values=int((v == 0).all(1).sum()), max_abs_err=err,
            bound_by=bound_by, **row)
        for k in keys:
            tot[k] += row[k]
        tot["bound_by"] = bound_by
    return tot


def uniform_inputs(torch, dev, sizes, ns) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    return [(S, torch.randint(0, S, (n,), generator=gen, device=dev,
                              dtype=torch.int32),
             torch.randn(n, 2, generator=gen, device=dev))
            for n in ns for S in sizes]


def check_small_agreement(torch, dev) -> None:
    """Phase 6a, at a small config whose levels 0 and 1 take the
    shared-memory kernel and levels 2-3 the global-atomics one: the march
    of one CPU ray batch on the card equals the CPU's bit for bit; the loss
    (rtol 1e-5) and every gradient (max error ≤ 1e-4 of the tensor's
    largest entry) agree on the CPU's samples. Exact backward."""
    from rnb_neus2_torch.config import (HashGridConfig, LossConfig,
                                        MarchConfig, NetworkConfig,
                                        RenderFlags)
    from rnb_neus2_torch.grid import occupancy
    from rnb_neus2_torch.models.neus_field import NeusField
    from rnb_neus2_torch.ops import hash_encoding, ray_march
    from rnb_neus2_torch.render.losses import RayBatch, training_loss
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.sampler import draw_uniforms, sample_ray_batch

    grid = HashGridConfig(n_levels=4, top_resolution=64)
    net = NetworkConfig(stoch_corner_bwd=0)
    if hash_encoding.levels_through_kernel(
            hash_encoding.HashGridStatic(grid)) != [0, 1]:
        raise AssertionError("the small config must reach the kernel")
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_field = NeusField(grid, net, "cpu", gen)
    with torch.no_grad():   # off the init, where w_enc is zero
        cpu_field.sdf_w_enc.normal_(0.0, 0.05, generator=gen)
        cpu_field.hash_table.normal_(0.0, 1e-3, generator=gen)
        bit = occupancy.update(occupancy.init_state(32), cpu_field.density(
            occupancy.cell_positions(32, gen))).bitfield
    ds = sphere_dataset(n_views=4, width=48, height=48, radius=0.2)
    R, S = 256, 1 << 13
    uni = draw_uniforms(R, gen, "cpu")
    batch, samples, pos, _ = sample_ray_batch(ds, bit, R, S, MarchConfig(),
                                              uniforms=uni)
    to = lambda xs, d: [x.to(d) for x in xs]
    on_card = ray_march.march_flat(*to((batch.ray_o, batch.ray_d, bit,
                                        uni.start), dev), 1024, S, 0.0)
    march_equal = all(torch.equal(a.cpu(), b) for a, b in zip(on_card,
                                                              samples))
    results = []
    for d in ("cpu", dev):
        field = NeusField(grid, net, d)
        field.load_state_dict(cpu_field.state_dict())
        loss, _ = training_loss(
            field(pos.to(d)), type(samples)(*to(samples, d)),
            RayBatch(*to(batch, d)), RenderFlags(), LossConfig())
        grads = torch.autograd.grad(loss, list(field.parameters()))
        results.append((float(loss.detach()), [g.cpu() for g in grads]))
    (l0, g0), (l1, g1) = results
    worst = max(float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12)
                for a, b in zip(g0, g1))
    log("agreement", config="small, exact backward",
        march_equal=march_equal, valid_samples=int(samples.valid.sum()),
        loss_cpu=l0, loss_gpu=l1, max_rel_grad_err=worst)
    if not march_equal:
        raise AssertionError("the march on the card differs from the CPU's")
    if abs(l0 - l1) > 1e-5 * abs(l0) or not worst <= 1e-4:
        raise AssertionError("card and CPU disagree on the small config")


def check_stochastic_agreement(torch, dev, n: int = 1 << 16) -> None:
    """Phase 6b: the default config's K = 1 encode backward on the card
    and on the CPU from the same positions, table and cotangents. Every
    sample's picked corner agrees at every level; the table gradients
    agree within 1e-5·(1 + max |CPU|), and every entry that no pick
    touches is exactly 0.0 in both."""
    from rnb_neus2_torch.config import HashGridConfig
    from rnb_neus2_torch.ops import hash_encoding as he

    static = he.HashGridStatic(HashGridConfig())
    L = static.cfg.n_levels
    gen = torch.Generator()
    gen.manual_seed(4)
    x = torch.rand(n, 3, generator=gen)
    table = torch.randn(static.n_entries, 2, generator=gen) * 1e-2
    cot = [torch.randn(n, static.cfg.output_dim, generator=gen)
           for _ in range(4)]
    picks, grads = [], []
    for d in ("cpu", dev):
        xd, cd = x.to(d), [c.to(d) for c in cot]
        base = he._position_hash(xd)
        per_level = []
        for lvl in range(L):
            idx, src = he.level_corner_cotangents(xd, static, lvl, cd[0],
                                                  cd[1:], 1.0)
            choice, idx_k, _ = he.pick_corners(
                idx, src, he._draws(base, lvl, 1), 1)
            per_level.append((choice.cpu(), idx_k.cpu()))
        picks.append(per_level)
        t = table.to(d).requires_grad_(True)
        f, j = he.make_encode_with_jacobian_cv(static, corner_samples=1)(
            t, xd)
        loss = (f * cd[0]).sum() + sum((jd * c).sum()
                                       for jd, c in zip(j, cd[1:]))
        grads.append(torch.autograd.grad(loss, t)[0].cpu())
    differ = [int((a[0] != b[0]).sum()) for a, b in zip(*picks)]
    touched = torch.zeros(static.n_entries, dtype=torch.bool)
    for lvl, (_, idx_k) in enumerate(picks[0]):
        touched[idx_k + int(static.offsets[lvl])] = True
    want, got = grads
    err = float((got - want).abs().max())
    tol = 1e-5 * (1.0 + float(want.abs().max()))
    zeros_kept = bool((got[~touched] == 0).all()
                      and (want[~touched] == 0).all())
    log("agreement", config="default, K=1 backward", samples=n,
        picks_differ_per_level=differ, max_abs_err=err, tol=tol,
        touched_entries=int(touched.sum()),
        untouched_exactly_zero=zeros_kept)
    if any(differ):
        raise AssertionError(f"picked corners differ on the card: {differ}")
    if not (err <= tol and zeros_kept):
        raise AssertionError("K=1 table gradients disagree card vs CPU")


def train(torch, kernels, dev, stoch: int, steps: int):
    """Phase 7: one training path at full width from init. Returns
    (summary, trainer)."""
    from rnb_neus2_torch.config import TestbedConfig
    from rnb_neus2_torch.ops import hash_encoding as he
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.trainer import Trainer

    cfg = TestbedConfig()
    if stoch != cfg.network.stoch_corner_bwd:
        cfg = dataclasses.replace(cfg, network=dataclasses.replace(
            cfg.network, stoch_corner_bwd=stoch))
    ds = sphere_dataset(n_views=16, width=256, height=256, radius=0.25,
                        device=dev)
    tr = Trainer(ds, cfg, device=dev)
    log("train_setup", stoch_corner_bwd=stoch,
        hash_rows=tr.field.static.n_entries, levels=cfg.grid.n_levels,
        batch=cfg.train.target_batch_size, occ_grid=cfg.train.occ_grid_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset_launches()
    hist = []
    for _ in range(steps):
        m = tr.train_step()
        torch.cuda.synchronize()
        hist.append(m)
        if tr.step % LOG_EVERY == 0 or tr.step == steps:
            log("step", stoch_corner_bwd=stoch, step=tr.step,
                step_ms=m["step_ms"], loss_color=m["loss_color"],
                loss_total=m["loss_total"], rays=m["rays_per_batch"],
                levels=m["n_levels_run"], valid=m["n_valid_total"],
                kept=m["n_samples_kept"])
    launches = {name: k.launches for name, k in kernels.items()}
    small = [len(he.levels_through_kernel(tr.field.static,
                                          int(m["n_levels_run"])))
             for m in hist]
    want = {"hash_grad_small": sum(small),
            "scatter_add": sum(int(m["n_levels_run"]) for m in hist)
            - sum(small)}
    color = [m["loss_color"] for m in hist]
    totals = [m["loss_total"] for m in hist]
    L = tr.cfg.grid.n_levels
    full = [m for m in hist if m["n_levels_run"] == L]
    trailing_full = 0
    for m in reversed(hist):
        if m["n_levels_run"] != L:
            break
        trailing_full += 1
    summary = {
        "stoch_corner_bwd": stoch, "steps": steps, "launches": launches,
        "launches_expected": want,
        "median_step_ms": statistics.median(m["step_ms"] for m in hist[5:]),
        "median_step_ms_all_levels": statistics.median(
            m["step_ms"] for m in full[-FULL_LEVEL_STEPS:]) if full else None,
        "final_steps_at_all_levels": trailing_full,
        "rays_per_batch_last": hist[-1]["rays_per_batch"],
        "valid_samples_last": hist[-1]["n_valid_total"],
        "kept_samples_last": hist[-1]["n_samples_kept"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "color_first5": sum(color[:5]) / 5, "color_last5": sum(color[-5:]) / 5,
        "guard": guard_counters(tr),
    }
    log("train", **summary)
    if not all(math.isfinite(v) for v in color + totals):
        raise AssertionError("non-finite loss")
    if not summary["color_last5"] < summary["color_first5"]:
        raise AssertionError("the color loss did not fall")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} in {steps} steps; "
                             f"want {want}")
    return summary, tr


def guard_counters(tr) -> dict:
    """The divergence guard's state after a run."""
    return {"enabled": tr.cfg.train.divergence_guard,
            "rollbacks": tr._guard_total_rollbacks,
            "degraded": not tr.cfg.flags.apply_rgbplus,
            "rearms_used": tr._guard_rearms_used,
            "lr_scale": tr.lr_scale,
            "loss_ema_floor": tr._guard_ema_floor,
            "ek_ema_floor": tr._guard_ek_floor,
            "checkpoint_steps": [g and g["step"] for g in (
                tr._good, tr._anchor, tr._deep_anchor)]}


def forced_rollback(torch, tr, steps: int = 16) -> dict:
    """Phase 8: one NaN color loss through the guard of a trained run; the
    restored state equals the good snapshot bit for bit, the generator
    draws a new stream, and training goes on."""
    good = tr._good
    out = tr._consume_metrics({
        "loss_color": float("nan"), "loss_ek": 0.0, "loss_mask": 0.0,
        "n_valid_total": 1.0, "rays_per_batch": tr._bucket()})
    if not out.get("rolled_back") or tr._good is not good:
        raise AssertionError("a NaN loss did not roll back to the good "
                             "snapshot")
    pairs = [(f"param.{k}", p, good["params"][k])
             for k, p in tr.params.items()]
    for name in ("mu", "nu", "steps", "ema"):
        pairs += [(f"{name}.{k}", t, good["opt"][name][k])
                  for k, t in getattr(tr.opt, name).items()]
    pairs += [(f"emap.{k}", t, getattr(good["emap"], k))
              for k, t in tr.emap._asdict().items()]
    pairs += [(f"occ.{k}", getattr(tr.occ, k), getattr(good["occ"], k))
              for k in ("density", "bitfield", "mean_density")]
    differ = [n for n, a, b in pairs if not torch.equal(a, b)]
    dev = tr.device

    def draws(state):
        g = torch.Generator(device=dev)
        g.set_state(state)
        return torch.rand(1024, generator=g, device=dev)
    new_stream = not torch.equal(draws(tr.generator.get_state()),
                                 draws(good["rng"]))
    restored_step = tr.step
    hist = [tr.train_step() for _ in range(steps)]
    torch.cuda.synchronize()
    color = [m["loss_color"] for m in hist]
    summary = {"restored_step": restored_step,
               "tensors_compared": len(pairs), "tensors_differ": differ,
               "bytes_compared": sum(a.numel() * a.element_size()
                                     for _, a, _ in pairs),
               "new_generator_stream": new_stream,
               "lr_scale_after": tr.lr_scale,
               "rolled_back_after": sum("rolled_back" in m for m in hist),
               "color": color, "loss_ema_restored": good["loss_ema"][0],
               "color_first4": sum(color[:4]) / 4,
               "color_last4": sum(color[-4:]) / 4,
               "guard": guard_counters(tr)}
    log("rollback", **summary)
    if differ or not new_stream:
        raise AssertionError("the rollback did not restore the snapshot "
                             "bit for bit with a new generator stream")
    # falling: below the trailing loss EMA that the snapshot restored
    # (one step's color loss at convergence is noise-dominated)
    if not all(math.isfinite(c) for c in color) \
            or summary["rolled_back_after"] \
            or not sum(color) / steps < good["loss_ema"][0]:
        raise AssertionError("training after the rollback failed")
    return summary


def mesh_export(torch, tr, card) -> dict:
    """Phase 9: the trained field's EMA mesh on the card."""
    import numpy as np
    import tempfile
    from rnb_neus2_torch.mesh import extract, writer
    from rnb_neus2_torch.mesh.marching import marching_cubes_grid
    from rnb_neus2_torch.mesh.marching_device import marching_cubes_device

    field = extract._bind(tr.field, tr.inference_params)
    res = 192
    csdf, active = extract.coarse_pass(field, res, 0.0, 1.0)
    vol = extract.fine_volume(field, csdf, active, res, 0.0, 1.0)
    t0 = time.perf_counter()
    V, F = marching_cubes_device(vol, (0.0, 0.0, 0.0), 1.0 / res)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    V0, F0 = marching_cubes_grid(vol.cpu().numpy(), (0.0, 0.0, 0.0),
                                 1.0 / res)
    t2 = time.perf_counter()
    same = V.shape == V0.shape and F.shape == F0.shape
    err = float(np.abs(V.cpu().numpy() - V0).max()) if same and len(V0) \
        else None
    faces_equal = same and bool(np.array_equal(F.cpu().numpy(), F0))
    log("mesh_vs_host", res=res, vertices=len(V0), faces=len(F0),
        active_blocks=int(active.shape[0]), max_abs_err=err,
        faces_equal=faces_equal, card_s=t1 - t0, numpy_s=t2 - t1)
    if not (faces_equal and len(F0) and err <= 1e-5):
        raise AssertionError("card marching cubes differs from numpy")
    del csdf, vol, V, F
    out = {"vs_host_res192": {"faces": len(F0), "card_s": t1 - t0,
                              "numpy_s": t2 - t1}}
    meta = tr.dataset.meta
    for res in (512, 1024):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = extract.extract_mesh(tr.field, tr.inference_params,
                                 resolution=res, meta=meta)
        total = time.perf_counter() - t0
        # back to the unit cube: the sphere of radius 0.25 at its centre
        unit = (m["V"] - np.asarray(meta.n2w_translation)) \
            / meta.n2w_scale * meta.scale + np.asarray(meta.offset)
        r_err = np.abs(np.linalg.norm(unit - 0.5, axis=1) - 0.25)
        row = {"res": res, "vertices": len(m["V"]), "faces": len(m["F"]),
               "active_blocks": m["active_blocks"], "seconds": m["seconds"],
               "total_s": total,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "memory_before": base,
               "radius_err_median": float(np.median(r_err)),
               "radius_err_p99": float(np.percentile(r_err, 99)),
               "card": card}
        if not (len(m["F"]) and np.isfinite(m["V"]).all()
                and np.isfinite(m["N"]).all()
                and row["radius_err_median"] < 0.01):
            log("mesh", **row)
            raise AssertionError(f"the res-{res} mesh is not the sphere")
        if res == 512:
            with tempfile.TemporaryDirectory() as d:
                path = Path(d) / "mesh.obj"
                t0 = time.perf_counter()
                writer.save_mesh(path, m["V"], m["F"], m["N"])
                row["obj_write_s"] = time.perf_counter() - t0
                row["obj_bytes"] = path.stat().st_size
                Vr, Fr = writer.load_obj(path)
            # "%0.5f" rounds by ≤ 5e-6, and parsing to float32 adds an ulp
            row["obj_max_abs_err"] = float(np.abs(Vr - m["V"]).max())
            if not (np.array_equal(Fr, m["F"])
                    and row["obj_max_abs_err"] <= 1e-5):
                log("mesh", **row)
                raise AssertionError("the OBJ does not read back")
        log("mesh", **row)
        out[f"res{res}"] = row
    return out


def chamfer_protocol(torch, dev, card) -> dict:
    """Phase 10: tests/test_chamfer_gate.py's protocol and gate on the
    card, with the default guard on."""
    from rnb_neus2_torch.config import (HashGridConfig, MarchConfig,
                                        TestbedConfig, TrainConfig)
    from rnb_neus2_torch.mesh.extract import extract_mesh
    from rnb_neus2_torch.mesh.metrics import chamfer_distance
    from rnb_neus2_torch.testing.synthetic import (composite_dataset,
                                                   composite_gt_mesh)
    from rnb_neus2_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    ds = composite_dataset(n_views=12, width=80, height=96,
                           focal=900.0 * 80 / 512, device=dev)
    cfg = TestbedConfig(
        grid=HashGridConfig(n_levels=8, top_resolution=256,
                            log2_hashmap_size=15),
        train=TrainConfig(target_batch_size=1 << 13,
                          initial_rays_per_batch=256,
                          occ_grid_size=64, seed=0),
        march=MarchConfig(n_ladder=1024))
    tr = Trainer(ds, cfg, device=dev)
    t1 = time.perf_counter()
    last = {}
    for _ in range(900):
        last = tr.train_step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    m = extract_mesh(tr.field, tr.inference_params, resolution=128,
                     meta=ds.meta)
    Vg, Fg = composite_gt_mesh(192)
    Vg = (Vg - 0.5) / 0.5
    ch = chamfer_distance(m["V"], m["F"], Vg, Fg)
    t3 = time.perf_counter()
    row = {**ch, "gate_chamfer_l1": 0.05, "gate_completeness": 0.04,
           "loss_color_last": last["loss_color"], "steps": tr.step,
           "vertices": len(m["V"]), "setup_s": t1 - t0, "train_s": t2 - t1,
           "extract_and_chamfer_s": t3 - t2, "total_s": t3 - t0,
           "guard": guard_counters(tr), "card": card}
    log("chamfer", **row)
    if not (math.isfinite(last["loss_color"]) and ch["chamfer_l1"] < 0.05
            and ch["completeness"] < 0.04):
        raise AssertionError(f"the Chamfer gate failed: {ch}")
    return row


def main_path_inputs(torch, tr) -> list:
    """[(kernel name, S, idx, v)] of one more training step of the trained
    field, level by level: what it gives the in-place entry points."""
    from rnb_neus2_torch.kernels import hash_grad_small as hgs
    from rnb_neus2_torch.kernels import scatter_add as sca

    seen = []

    def hook(mod, attr, name):
        real = getattr(mod, attr)

        def record(out, idx, v):
            seen.append((name, out.shape[0], idx.clone(), v.clone()))
            return real(out, idx, v)
        setattr(mod, attr, record)
        return mod, attr, real

    hooks = [hook(hgs, "grad_small_into", "hash_grad_small"),
             hook(sca, "scatter_add_into", "scatter_add")]
    try:
        tr.train_step()
    finally:
        for mod, attr, real in hooks:
            setattr(mod, attr, real)
    return seen


def warp_repeats(torch, S, idx, v) -> dict:
    """Of the elements a kernel adds (index in [0, S), a non-zero value),
    the share whose row equals another's in its warp of 32 consecutive
    elements, and the share of atomics that summing such rows first
    removes (1 - distinct rows per warp / elements)."""
    n = idx.numel()
    live = (idx >= 0) & (idx < S) & (v != 0).any(1)
    dead = -1 - torch.arange(n + (-n % 32), device=idx.device)
    key = torch.cat([torch.where(live, idx.long(), dead[:n]), dead[n:]])
    rows = key.view(-1, 32).sort(1).values
    dup = rows[:, 1:] == rows[:, :-1]
    repeat = torch.zeros_like(rows, dtype=torch.bool)
    repeat[:, 1:] |= dup
    repeat[:, :-1] |= dup
    n_live = int(live.sum())
    return {"elements": n_live,
            "repeat_share": int(repeat.sum()) / max(n_live, 1),
            "atomics_removed_share": int(dup.sum()) / max(n_live, 1)}


def main() -> int:
    signal.alarm(WALL_LIMIT_S)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "rnb_neus2_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no rnb_neus2_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rnb_neus2_torch.device import resolve_device
    from rnb_neus2_torch.kernels import build
    from rnb_neus2_torch.kernels import hash_grad_small as hgs
    from rnb_neus2_torch.kernels import scatter_add as sca
    from rnb_neus2_torch.io import raycast
    from rnb_neus2_torch.tools import bench_scatter as bench

    kernels = {"hash_grad_small": hgs, "scatter_add": sca}
    card = bench.card_name_and_power()
    print(card, flush=True)
    dev = resolve_device("cuda")
    log("device", kind=torch.cuda.get_device_name(0), nvidia_smi=card,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    build_all(build, [hgs, sca, raycast])
    errs = check_kernels_vs_plain(torch, bench, kernels, dev)
    for name, sizes in (("hash_grad_small", (4096, 13824)),
                        ("scatter_add", (39304, 125000, 373248, 1 << 19))):
        time_inputs(torch, bench, name, kernels[name], dev, card,
                    uniform_inputs(torch, dev, sizes, (1 << 18, 1 << 21)))
    probes = bench.run(list(bench.SECTIONS), dev,
                       emit=lambda line: log("probe", **json.loads(line)))
    log("probes", points=len(probes))
    check_small_agreement(torch, dev)
    check_stochastic_agreement(torch, dev)
    summary, tr = train(torch, kernels, dev, 1, TRAIN_STEPS)
    if summary["final_steps_at_all_levels"] < FULL_LEVEL_STEPS:
        raise AssertionError("too few final steps ran all 14 levels")
    exact, tr_exact = train(torch, kernels, dev, 0, EXACT_STEPS)
    # phase 4 again, on the inputs of the trained fields' next steps
    inputs = {"K=1": main_path_inputs(torch, tr),
              "exact": main_path_inputs(torch, tr_exact)}
    for lvl, case in enumerate(inputs["K=1"]):
        exact_case = (inputs["exact"][lvl] if lvl < len(inputs["exact"])
                      else None)
        log("warp_repeats", level=lvl, kernel=case[0], S=case[1],
            **{"K=1": warp_repeats(torch, *case[1:]),
               "exact": exact_case and warp_repeats(torch, *exact_case[1:])})
    fixed = {}
    for name, S, idx, v in (next(c for c in inputs["K=1"] if c[0] == k)
                            for k in kernels):
        out = torch.zeros(S, v.shape[1], device=dev)
        zeros = torch.zeros_like(v)
        fixed[name] = bench.time_ms(
            lambda: bench.KERNELS_INTO[name](out, idx, zeros))
        log("fixed_cost", kernel=name, S=S, n=idx.numel(), card=card,
            ms_into_zero_values=fixed[name])
    rows = []
    for name, mod in kernels.items():
        per_path = {
            path: time_inputs(torch, bench, name, mod, dev, card,
                              [c[1:] for c in cases if c[0] == name],
                              main_path=True)
            for path, cases in inputs.items()}
        t = per_path["K=1"]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"rnb_neus2_torch/csrc/{mod.SOURCE}",
            "replaces": list(mod.REPLACES),
            "launches": summary["launches"][name],
            "launches_exact_path": exact["launches"][name],
            "max_abs_err": max(errs[name], t["max_abs_err"],
                               per_path["exact"]["max_abs_err"]),
            "ms": t["ms"],
            "ms_into": t["ms_into"],
            "ms_into_scatter_add": t.get("ms_into_scatter_add"),
            "ms_into_zero_values": fixed[name],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_into_ms": t["bound_into_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "exact_path": {k: per_path["exact"].get(k) for k in (
                "ms", "ms_into", "ms_into_scatter_add", "plain_ms",
                "bound_ms", "bound_into_ms", "library_ms")},
        })
    forced_rollback(torch, tr)
    mesh_export(torch, tr, card)
    chamfer_protocol(torch, dev, card)
    log("done", card=card, total_s=time.perf_counter() - T0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
