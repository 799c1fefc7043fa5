"""Time the library primitives of the JAX package's primitive probes, each
as its one PyTorch call.

    python -m rnb_neus2_torch.tools.bench_primitives [section ...]
        [--device cuda|cpu]

Sections, from `tools/profiling/_bench_primitives.py` (`scatter`,
`gather`, `sort`, `misc`: :49-165) and `_bench_primitives2.py`
(`scatter`, `gather`, `sort`, `sharded`, `slice_gather`, `bigtable`:
:46-232); a section of both files runs the rows of both, each row naming
the file and line of the probe it ports:

- `scatter`: `.at[idx].add(v, mode="drop")` and sorted `segment_sum` →
  `index_add_` into a zeroed table (every index is in range, so "drop"
  drops nothing), by row width, source count, bf16, sorted indices, and
  two width-1 scatters (one level at F = 2);
- `gather`: `tab[idx]` → `index_select`, by row width;
- `sort`: `sort_key_val` → `torch.sort` of the keys and the payload
  gathered by the order; `argsort` → `torch.argsort`; `cumsum`;
- `misc`: `cumsum`, and the one-hot product `one_hot(idx, 4096).T @ v`
  → `torch.matmul` in bf16;
- `sharded`: B `vmap`ped scatters summed → B `index_add_`s summed;
- `slice_gather`: `vmap(dynamic_slice)` of (2, 2) and flat 4-slices →
  `unfold` of the table, indexed;
- `bigtable`: gather and width-1 scatter on a 2^25-row table.

Sizes are the JAX probes' (N_EL = 2^21 elements, S_BIG = 2^19 rows, 2^25
rows for `bigtable`); each section function takes them as arguments. The
probes' `lax.scan` rotations and chained inputs, a way round the TPU
runtime's memoization, are not ported: a row's time is CUDA events over
its calls queued behind a sleep kernel (`bench_scatter.time_ms`). Each
row's result is checked against its known sum (ones in, so every sum is
an integer count) or order; a mismatch raises. One JSON line per row,
with the card's name and power limit. `--device cpu` runs every call
once at the sizes given and measures no time.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import torch

from ..device import resolve_device
from .bench_scatter import card_name_and_power, time_ms

N_EL = 1 << 21
S_BIG = 1 << 19
S_HUGE = 1 << 25
P1 = "tools/profiling/_bench_primitives.py"
P2 = "tools/profiling/_bench_primitives2.py"


def _idx(n: int, s: int, dev, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(0, s, (n,), generator=gen, device=dev,
                         dtype=torch.int64)


def _row(rows: List[Dict], source: str, op: str, fn: Callable,
         check: Callable, n: int, **info) -> None:
    """Run `fn` once, check its result, time it on the card, append the
    row."""
    out = fn()
    if not check(out):
        raise AssertionError(f"{op} ({source}): wrong result")
    ms = time_ms(fn, iters=20) if _out_device(out).type == "cuda" else None
    rows.append({"source": source, "op": op, "n": n, **info, "ms": ms,
                 "ns_per_el": None if ms is None else ms * 1e6 / n})


def _out_device(out) -> torch.device:
    return (out[0] if isinstance(out, tuple) else out).device


def _sum_is(want: float):
    return lambda out: float(out.float().sum()) == float(want)


def _scatter(idx, v, S, dtype=torch.float32):
    shape = (S,) if v.dim() == 1 else (S, v.shape[1])
    return torch.zeros(shape, dtype=dtype, device=v.device) \
        .index_add_(0, idx, v)


def scatter(dev, n_el: int = N_EL, s_big: int = S_BIG) -> List[Dict]:
    rows: List[Dict] = []
    for w in (2, 4, 8, 16, 32, 128):                       # P1 :51
        n = n_el // w
        idx, v = _idx(n, s_big, dev, 7), torch.ones(n, w, device=dev)
        _row(rows, f"{P1}:51", "index_add_", lambda: _scatter(idx, v, s_big),
             _sum_is(n * w), n, width=w)
    for n in (n_el >> 4, n_el >> 2, n_el):                 # P1 :67
        idx, v = _idx(n, s_big, dev, 11), torch.ones(n, device=dev)
        _row(rows, f"{P1}:67", "index_add_", lambda: _scatter(idx, v, s_big),
             _sum_is(n), n, width=1)
    idx = _idx(n_el, s_big, dev, 13)
    for dt in (torch.float32, torch.bfloat16):             # P1 :77
        v = torch.ones(n_el, dtype=dt, device=dev)
        _row(rows, f"{P1}:77", "index_add_",
             lambda: _scatter(idx, v, s_big, dt),
             lambda out: out.float().sum() > 0, n_el, width=1,
             dtype=str(dt).split(".")[1])
    srt, v = torch.sort(_idx(n_el, s_big, dev, 17))[0], \
        torch.ones(n_el, device=dev)
    for line, what in ((88, "at[].add, sorted"), (96, "segment_sum")):
        _row(rows, f"{P1}:{line}", f"index_add_ (sorted indices; {what})",
             lambda: _scatter(srt, v, s_big), _sum_is(n_el), n_el, width=1)
    idx = _idx(n_el, s_big, dev, 0)
    _row(rows, f"{P2}:53", "index_add_", lambda: _scatter(idx, v, s_big),
         _sum_is(n_el), n_el, width=1)
    for w in (2, 4, 8, 16, 32):                            # P2 :57
        n = n_el // w
        vr = torch.ones(n, w, device=dev)
        _row(rows, f"{P2}:57", "index_add_",
             lambda: _scatter(idx[:n], vr, s_big), _sum_is(n * w), n,
             width=w)
    _row(rows, f"{P2}:66", "2x index_add_ (one level, F=2)",
         lambda: _scatter(idx, v, s_big) + _scatter(idx, v * 2, s_big),
         _sum_is(3 * n_el), n_el, width=1)
    _row(rows, f"{P2}:75", "sort + index_add_",
         lambda: _scatter(torch.sort(idx)[0], v, s_big), _sum_is(n_el),
         n_el, width=1)
    return rows


def gather(dev, n_el: int = N_EL, s_big: int = S_BIG) -> List[Dict]:
    rows: List[Dict] = []
    idx = _idx(n_el, s_big, dev, 19)
    for w in (2, 4, 8, 16, 32, 128, 256):                  # P1 :104
        n = n_el // w
        tab = torch.ones(s_big, w, device=dev)
        _row(rows, f"{P1}:104", "index_select",
             lambda: tab.index_select(0, idx[:n]), _sum_is(n * w), n,
             width=w)
    for w in (2, 8, 16):                                   # P1 :116
        tab = torch.ones(s_big, w, device=dev)
        _row(rows, f"{P1}:116", "index_select",
             lambda: tab.index_select(0, idx), _sum_is(n_el * w), n_el,
             width=w)
    for w in (2, 8, 16, 32, 128, 256):                     # P2 :93
        n = min(n_el // max(w // 2, 1), n_el)
        tab = torch.ones(s_big, w, device=dev)
        _row(rows, f"{P2}:93", "index_select",
             lambda: tab.index_select(0, idx[:n]), _sum_is(n * w), n,
             width=w)
    for w in (2, 16, 256):                                 # P2 :102
        n = min(n_el >> 3, n_el)
        tab = torch.ones(s_big, w, device=dev)
        _row(rows, f"{P2}:102", "index_select",
             lambda: tab.index_select(0, idx[:n]), _sum_is(n * w), n,
             width=w)
    return rows


def _sorted_pair(out) -> bool:
    keys, vals = out
    return bool((keys[1:] >= keys[:-1]).all()) and bool((vals == 1).all())


def _sort_key_val(k, v):
    keys, order = torch.sort(k)
    return keys, v[order]


def sort(dev, n_el: int = N_EL, s_big: int = S_BIG) -> List[Dict]:
    rows: List[Dict] = []
    k = _idx(n_el, s_big, dev, 29).to(torch.int32)
    v = torch.ones(n_el, device=dev)
    _row(rows, f"{P1}:132", "sort + payload gather",
         lambda: _sort_key_val(k, v), _sorted_pair, n_el)
    _row(rows, f"{P1}:141", "argsort", lambda: torch.argsort(k),
         lambda o: bool((k[o][1:] >= k[o][:-1]).all()), n_el)
    _row(rows, f"{P2}:116", "sort + payload gather",
         lambda: _sort_key_val(k, v), _sorted_pair, n_el)
    kf = k.float()
    _row(rows, f"{P2}:119", "cumsum", lambda: torch.cumsum(kf, 0),
         lambda o: abs(float(o[-1]) / float(kf.double().sum()) - 1) < 1e-4,
         n_el)
    return rows


def misc(dev, n_el: int = N_EL) -> List[Dict]:
    rows: List[Dict] = []
    x = torch.ones(n_el, device=dev)
    _row(rows, f"{P1}:151", "cumsum", lambda: torch.cumsum(x, 0),
         lambda o: float(o[-1]) == n_el, n_el)
    n = n_el // 8
    idx = _idx(n, 4096, dev, 37)
    v = torch.ones(n, 2, device=dev, dtype=torch.bfloat16)

    def onehot():
        oh = torch.nn.functional.one_hot(idx, 4096).to(torch.bfloat16)
        return torch.matmul(oh.T, v)
    # bf16 sums are exact to 256: check the row counts where they fit
    count = torch.bincount(idx, minlength=4096).float()
    _row(rows, f"{P1}:161", "one_hot.T @ v (bf16 matmul)", onehot,
         lambda o: bool((o.float()[count <= 256, 0]
                         == count[count <= 256]).all()), n, S=4096)
    return rows


def sharded(dev, n_el: int = N_EL, s_big: int = S_BIG) -> List[Dict]:
    rows: List[Dict] = []
    idx = _idx(n_el, s_big, dev, 3)
    v = torch.ones(n_el, device=dev)
    for b in (1, 4, 16, 64):                               # P2 :137
        m = n_el // b

        def op(b=b, m=m):
            return sum(_scatter(idx[i * m:(i + 1) * m], v[i * m:(i + 1) * m],
                                s_big) for i in range(b))
        _row(rows, f"{P2}:137", f"{b} index_add_ summed", op,
             _sum_is(n_el), n_el, width=1, shards=b)
    n = n_el // 16
    vr = torch.ones(n, 16, device=dev)
    for b in (4, 16):                                      # P2 :150
        m = n // b

        def op(b=b, m=m):
            return sum(_scatter(idx[i * m:(i + 1) * m], vr[i * m:(i + 1) * m],
                                s_big) for i in range(b))
        _row(rows, f"{P2}:150", f"{b} index_add_ summed", op,
             _sum_is(n * 16), n, width=16, shards=b)
    return rows


def slice_gather(dev, n_el: int = N_EL, s_big: int = S_BIG) -> List[Dict]:
    rows: List[Dict] = []
    idx = _idx(n_el, s_big, dev, 4)
    n = n_el // 2
    tab = torch.ones(s_big, 2, device=dev)
    starts = idx[:n].clamp(0, s_big - 2)
    # (s_big - 1, 2, 2): every window of 2 rows; window s = rows s, s + 1
    windows = tab.unfold(0, 2, 1).transpose(1, 2)
    _row(rows, f"{P2}:173", "unfold (2, 2) windows, indexed",
         lambda: windows[starts], _sum_is(n * 4), n)
    flat = torch.ones(s_big * 2, device=dev)
    fstarts = (idx[:n] * 2).clamp(0, s_big * 2 - 4)
    fwin = flat.unfold(0, 4, 1)
    _row(rows, f"{P2}:184", "unfold flat 4-windows, indexed",
         lambda: fwin[fstarts], _sum_is(n * 4), n)
    return rows


def bigtable(dev, n_el: int = N_EL, s_huge: int = S_HUGE) -> List[Dict]:
    rows: List[Dict] = []
    idx = _idx(n_el, s_huge, dev, 5)
    tab = torch.ones(s_huge, 2, device=dev)
    _row(rows, f"{P2}:199", "index_select (2^25-row table)",
         lambda: tab.index_select(0, idx), _sum_is(n_el * 2), n_el, width=2)
    del tab
    v = torch.ones(n_el, device=dev)
    _row(rows, f"{P2}:215", "index_add_ (2^25-row table)",
         lambda: _scatter(idx, v, s_huge), _sum_is(n_el), n_el, width=1)
    return rows


SECTIONS = {"scatter": scatter, "gather": gather, "sort": sort,
            "misc": misc, "sharded": sharded, "slice_gather": slice_gather,
            "bigtable": bigtable}


def run(sections: Optional[List[str]] = None, device: str = "cuda",
        sizes: Optional[Dict[str, int]] = None) -> List[Dict]:
    """Rows of the named sections (all by default). `sizes` overrides
    the section functions' size arguments (n_el, s_big, s_huge) where
    they take them."""
    dev = resolve_device(device)
    card = card_name_and_power() if dev.type == "cuda" else None
    out = []
    for name in sections or list(SECTIONS):
        fn = SECTIONS[name]
        kw = {k: v for k, v in (sizes or {}).items()
              if k in fn.__code__.co_varnames[:fn.__code__.co_argcount]}
        for row in fn(dev, **kw):
            out.append({"section": name, **row, "card": card})
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*",
                    help=f"default: all of {', '.join(SECTIONS)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.sections) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    for row in run(args.sections or None, args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
