"""Time the scatter-add kernels at the sweeps of the five TPU scatter-add
probes.

    python -m rnb_neus2_torch.tools.bench_scatter [section ...]
        [--device cuda|cpu] [--max-n N]

One section per probe, named after the function it ports; each runs that
probe's own sweep of table rows S, elements n and features F:

- `scalar_loop` (`tools/profiling/_bench_pallas.py:33`): S = n = 2^19, F = 1;
- `onehot_mxu` (`_bench_pallas.py:78`): S in {4096, 16384, 65536},
  n = 2^21, F = 2;
- `vector_rmw` (`_bench_pallas2.py:35` `bench`): S = n = 2^19, F = 1. The
  probe's (TN, unroll) pairs (8192, 1) and (8192, 4) are TPU tiling
  parameters with no meaning on the card, so the point runs once;
- `pallas_onehot` (`_bench_primitives.py:168`): S in {4096, 16384, 131072,
  2^19}, n = 2^21, F = 2;
- `pallas_scalar` (`_bench_primitives.py:241`): S in {4096, 2^19},
  n = 2^18, F = 1.

The output is the (S, F) table; the probes' f-blocked (Hpad, 128·F) and
(S/128, 128) layouts are TPU layouts and are not ported. Indices are
uniform in [0, S) from a seeded generator, shifted per launch as
(idx0 + j·977) mod S like the probes' `run_scan` (8 shifts, cycled); the
values are ones.

At every point both kernels run: `scatter_add` (global atomics) and
`hash_grad_small` (histograms in the shared memory of a cluster of 8
blocks, summed through distributed shared memory), except that on the
card `hash_grad_small` refuses a table whose histogram one cluster cannot
hold (S = 2^19 here; its entry is then `{"refused": ...}`). `route`
names the one the encode backward's level rule picks for a dense level of
S entries (S ≤ 2^15: `hash_grad_small`, else `scatter_add`), and `ms` is
that kernel's time. Each kernel is
checked against the plain version: exactly on the ones (their sums are
integers below 2^24), and on one random-normal value set with max abs
error ≤ 1e-5·(1 + max |plain|) and every untouched row exactly 0.0 in
both; a mismatch raises. Times are CUDA events over 50 launches queued
behind a sleep kernel, after 5 warm-up launches: `ms` of the allocating
wrapper (a zeroed table per launch, as the TPU probes' outputs and
`library_ms` have), `ms_into` of the in-place entry point adding into one
table; `library_ms` is one `torch.zeros(S, F).index_add_(0, idx, v)`,
`plain_ms` the kernels' plain version (`scatter_add.plain`: the
in-range mask, then `index_add_` into zeros);
`bound_ms` is the bytes n·(4 + 4F) + S·F·4 over 3.35 TB/s against n·F
float adds over 67 TFLOP/s, and `bound_into_ms`, for `ms_into`, the same
with a read and a write of each row the input adds to in place of the
S·F·4 bytes of the table's fill. One JSON line per point, with the card's name
and power limit from nvidia-smi.

`--device cpu` runs the plain versions (the wrappers take them for CPU
tensors) and measures no time; `--max-n` caps n (the tests use it). The
default device is cuda, which raises without a card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
from typing import Dict, List, Optional, Sequence

import torch

from ..device import resolve_device
from ..kernels import hash_grad_small, scatter_add
from ..ops.hash_encoding import SMALL_LEVEL_MAX_ENTRIES

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
ITERS = 50
SHIFTS = 8                     # `run_scan`'s k
SHIFT = 977

# section -> (file:line of the probe it ports, F, [(S, n), ...])
SECTIONS = {
    "scalar_loop": ("tools/profiling/_bench_pallas.py:33", 1,
                    [(1 << 19, 1 << 19)]),
    "onehot_mxu": ("tools/profiling/_bench_pallas.py:78", 2,
                   [(S, 1 << 21) for S in (4096, 16384, 65536)]),
    "vector_rmw": ("tools/profiling/_bench_pallas2.py:35", 1,
                   [(1 << 19, 1 << 19)]),
    "pallas_onehot": ("tools/profiling/_bench_primitives.py:168", 2,
                      [(S, 1 << 21) for S in (4096, 16384, 131072,
                                              1 << 19)]),
    "pallas_scalar": ("tools/profiling/_bench_primitives.py:241", 1,
                      [(S, 1 << 18) for S in (4096, 1 << 19)]),
}
KERNELS = {"scatter_add": scatter_add.scatter_add,
           "hash_grad_small": hash_grad_small.grad_small}
KERNELS_INTO = {"scatter_add": scatter_add.scatter_add_into,
                "hash_grad_small": hash_grad_small.grad_small_into}


def card_name_and_power() -> str:
    """`name, power limit` of card 0, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = ITERS) -> float:
    """Mean device ms per call: CUDA events around `iters` calls queued
    behind a sleep kernel, after 5 warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def scatter_bound(n: int, S: int, F: int):
    """(least ms, what bounds it) for (n,) int32 idx + (n, F) f32 in and
    (S, F) f32 out: bytes over the memory rate vs n·F float adds."""
    t_bytes = (n * 4 + n * F * 4 + S * F * 4) / HBM_BYTES_PER_S
    t_ops = n * F / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rows_added_to(idx: torch.Tensor, v: torch.Tensor, S: int) -> int:
    """The rows that an in-place add changes: distinct indices in [0, S)
    with a value that is not all zero."""
    keep = (idx >= 0) & (idx < S) & (v != 0).any(1)
    return int(torch.unique(idx[keep]).numel())


def scatter_bound_into(n: int, F: int, rows: int):
    """(least ms, what bounds it) of adding in place into an (S, F) table
    that is already zeroed: (n,) int32 idx + (n, F) f32 read once, and
    each of the `rows` rows that the input adds to read and written once;
    bytes over the memory rate vs n·F float adds."""
    t_bytes = (n * 4 + n * F * 4 + 2 * rows * F * 4) / HBM_BYTES_PER_S
    t_ops = n * F / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def level_rule(S: int) -> str:
    """The kernel the encode backward sends a dense level of S entries."""
    return ("hash_grad_small" if S <= SMALL_LEVEL_MAX_ENTRIES
            else "scatter_add")


def check_against_plain(name: str, got: torch.Tensor, want: torch.Tensor,
                        idx: torch.Tensor, S: int, exact: bool) -> float:
    """Raise unless `got` agrees with the plain version's `want`; returns
    the max abs error. `exact`: bitwise equality; else max abs error ≤
    1e-5·(1 + max |plain|) and every untouched row exactly 0.0 in both."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name} at S={S}: not exactly the plain "
                                 f"version (max abs error {err})")
        return err
    tol = 1e-5 * (1.0 + float(want.abs().max()))
    keep = (idx >= 0) & (idx < S)
    untouched = torch.bincount(idx[keep].long(), minlength=S) == 0
    if not (err <= tol and bool((got[untouched] == 0).all())
            and bool((want[untouched] == 0).all())):
        raise AssertionError(f"{name} at S={S}: max abs error {err} > "
                             f"{tol}, or an untouched row is not exactly "
                             f"0.0")
    return err


def in_place_view(S: int, F: int, dev: torch.device,
                  gen: torch.Generator, nonzero: bool = False,
                  misaligned: bool = False, pad: int = 3):
    """(buffer, view): a flat float32 buffer of random sentinel values,
    and the contiguous (S, F) view of its middle that an in-place entry
    point adds into, with `pad` rows of sentinels on both sides. The view
    is zeroed, or keeps random contents (`nonzero`); it starts on an
    8-byte boundary, or 4 bytes past one (`misaligned`)."""
    start = -(-pad * F // 2) * 2 + int(misaligned)
    buf = torch.randn(start + (S + pad) * F, generator=gen, device=dev)
    view = buf[start:start + S * F].view(S, F)
    if not nonzero:
        view.zero_()
    return buf, view


def check_in_place(name: str, fn_into, buf: torch.Tensor,
                   view: torch.Tensor, idx: torch.Tensor,
                   v: torch.Tensor) -> float:
    """`fn_into(view, idx, v)` against the plain version on a copy of the
    view: every float of `buf` outside the view keeps its bits, every row
    of the view that no element touches keeps its bits, and the view is
    within max abs error ≤ 1e-5·(1 + max |plain|) of the plain version.
    Raises on a mismatch; returns the max abs error."""
    before = buf.clone()
    want = scatter_add.plain_into(view.clone(), idx, v)
    fn_into(view, idx, v)
    if buf.is_cuda:
        torch.cuda.synchronize()
    start = (view.data_ptr() - buf.data_ptr()) // 4
    outside = torch.ones(buf.numel(), dtype=torch.bool, device=buf.device)
    outside[start:start + view.numel()] = False
    bits, bits0 = buf.view(torch.int32), before.view(torch.int32)
    S = view.shape[0]
    keep = (idx >= 0) & (idx < S)
    untouched = torch.bincount(idx[keep].long(), minlength=S) == 0
    view0 = bits0[start:start + view.numel()].view(view.shape)
    err = float((view - want).abs().max()) if view.numel() else 0.0
    tol = 1e-5 * (1.0 + float(want.abs().max()))
    if not torch.equal(bits[outside], bits0[outside]):
        raise AssertionError(f"{name}: wrote outside its (S, F) view")
    if not torch.equal(view.view(torch.int32)[untouched], view0[untouched]):
        raise AssertionError(f"{name}: changed a row no element touches")
    if not err <= tol:
        raise AssertionError(f"{name} in place at S={S}: max abs error "
                             f"{err} > {tol}")
    return err


def run_point(section: str, S: int, n: int, F: int, dev: torch.device,
              card: Optional[str], seed: int) -> Dict:
    replaces = SECTIONS[section][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    idx0 = torch.randint(0, S, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    idxs = [(idx0 + j * SHIFT) % S for j in range(SHIFTS)]
    ones = torch.ones(n, F, device=dev)
    normal = torch.randn(n, F, generator=gen, device=dev)
    on_card = dev.type == "cuda"
    per_kernel = {}
    for name, fn in KERNELS.items():
        if (on_card and name == "hash_grad_small"
                and not hash_grad_small.takes(S, F)):
            per_kernel[name] = {"refused": "histogram over a cluster's "
                                           "shared memory"}
            continue
        got = fn(idxs[0], ones, S)
        check_against_plain(name, got, scatter_add.plain(idxs[0], ones, S),
                            idxs[0], S, exact=True)
        got = fn(idxs[1], normal, S)
        err = check_against_plain(name, got,
                                  scatter_add.plain(idxs[1], normal, S),
                                  idxs[1], S, exact=False)
        ms = ms_into = None
        if on_card:
            shifts = itertools.cycle(idxs)
            ms = time_ms(lambda: fn(next(shifts), ones, S))
            out = torch.zeros(S, F, device=dev)
            ms_into = time_ms(lambda: KERNELS_INTO[name](out, next(shifts),
                                                         ones))
        per_kernel[name] = {"ms": ms, "ms_into": ms_into, "max_abs_err": err,
                            "ns_per_el": None if ms is None else ms * 1e6 / n}
    library_ms = None
    plain_ms = None
    if on_card:
        shifts = itertools.cycle(idxs)
        library_ms = time_ms(lambda: torch.zeros(S, F, device=dev)
                             .index_add_(0, next(shifts), ones))
        plain_ms = time_ms(lambda: scatter_add.plain(next(shifts), ones, S))
    bound_ms, bound_by = scatter_bound(n, S, F)
    bound_into_ms, _ = scatter_bound_into(n, F, rows_added_to(idx0, ones, S))
    route = level_rule(S)
    return {"section": section, "replaces": replaces, "S": S, "n": n,
            "F": F, "route": route, "ms": per_kernel[route]["ms"],
            "ms_into": per_kernel[route]["ms_into"],
            "ns_per_el": per_kernel[route]["ns_per_el"],
            "bound_ms": bound_ms, "bound_into_ms": bound_into_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "plain_ms": plain_ms, "kernels": per_kernel,
            "device": str(dev), "card": card}


def run(sections: Sequence[str], dev: torch.device,
        max_n: Optional[int] = None, emit=print) -> List[Dict]:
    """Every point of `sections`; `emit` gets one JSON line per point."""
    card = card_name_and_power() if dev.type == "cuda" else None
    rows = []
    for seed, (section, (S, n)) in enumerate(
            (s, p) for s in sections for p in SECTIONS[s][2]):
        n = n if max_n is None else min(n, max_n)
        row = run_point(section, S, n, SECTIONS[section][1], dev, card, seed)
        emit(json.dumps(row))
        rows.append(row)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*",
                    help=f"any of {', '.join(SECTIONS)} (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-n", type=int, default=None)
    args = ap.parse_args(argv)
    unknown = set(args.sections) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    run(args.sections or list(SECTIONS), resolve_device(args.device),
        args.max_n, emit=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
