"""The training march and its two-pass compaction as four CUDA kernels:
wrapper, launch counters and the kernels' loops in PyTorch (`walk_twin`).

Replaces the JAX package's `march_flat` (rnb_neus2_tpu/ops/ray_march.py:
203) in both of its branches: the blocked two-phase march at cone 0
(`_march_flat_blocked`, :286; `REPLACES`), which every default-config
training path takes, and the single-phase ladder (cone > 0 with a 1-D
bitfield, the aabb_scale > 1 option; or `blocked=False`). XLA compiled
both; the TPU ran no Pallas kernel there. `csrc/march.cu` holds the
kernels, their design and the bound.

`march_flat` is the wrapper that `ops/ray_march.march_flat` calls for
CUDA tensors; it returns the seven `FlatSamples` fields, every one bit for
bit equal to the plain version's (`ops/ray_march.march_flat_plain`, the
port's CPU path) on the same card tensors. It launches
`march_coarse_kernel` (the blocked path only), `march_count_kernel`,
`march_scan_kernel` and `march_write_kernel` on the current stream, each
counted by its `LaunchCounter`, reads nothing back to the host, and raises on
what the kernels do not take: a cascaded (C, G³) bitfield, rays that
require grad (no caller differentiates through the march), other dtypes,
shapes or devices.

`walk_twin` is the kernels' loops transcribed in PyTorch, vectorized
over rays (one row per warp, a boolean row per ballot): the coarse grid,
the count pass, the scan over tiles and the write pass, in the kernels'
order and float operations. The tests hold it, and the plain version,
against the JAX package bit for bit; it runs on any device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE
from .build import LaunchCounter, load_library

SOURCE = "march.cu"
LIBRARY = "march"
REPLACES = ("rnb_neus2_tpu/ops/ray_march.py:203",
            "rnb_neus2_tpu/ops/ray_march.py:286")

# csrc/march.cu's plan: WARPS rays (one warp each) per block of the count
# and write passes, SCAN_TILE rays per block of the scan; the coarse grid's
# kernel holds a fine grid of MAX_SIDE cells a side at most
WARPS, SCAN_TILE, MAX_SIDE = 8, 1024, 1024
BLOCK = 8          # ladder points per block (ops/ray_march.BLOCK)


coarse_kernel = LaunchCounter("march_coarse")
count_kernel = LaunchCounter("march_count")
scan_kernel = LaunchCounter("march_scan")
write_kernel = LaunchCounter("march_write")
COUNTERS = (coarse_kernel, count_kernel, scan_kernel, write_kernel)


class _Args(ctypes.Structure):
    """csrc/march.cu's MarchArgs."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ray_o", "ray_d", "u_start", "bitfield", "coarse", "t", "dt",
        "ray_id", "valid", "seg_start", "n_valid", "ray_kept", "work")] + [
        ("S", ctypes.c_longlong)] + [(n, ctypes.c_int) for n in (
            "R", "K", "KB", "NB", "blocked", "geometric", "g", "f",
            "cg")] + [(n, ctypes.c_float) for n in (
                "lo", "hi", "lo_m", "hi_m", "dt_min", "dt_max", "cone",
                "inv_dt_min", "t_switch", "growth")]


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_library(LIBRARY, [SOURCE])
    for name in ("coarse", "count", "scan", "write"):
        fn = getattr(lib, f"march_{name}_launch")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.march_work_words.argtypes = [ctypes.c_int]
    lib.march_work_words.restype = ctypes.c_longlong
    lib.march_error_string.argtypes = [ctypes.c_int]
    lib.march_error_string.restype = ctypes.c_char_p
    return lib


def _f32(x: float) -> float:
    return float(np.float32(x))


class Plan(NamedTuple):
    """One call's shape and the plain version's float32 constants (computed
    in double, rounded once), as `_Args` takes them."""

    R: int
    S: int
    K: int            # effective ladder points
    KB: int           # blocks of BLOCK points
    NB: int           # flagged blocks a ray walks (blocked path)
    blocked: bool
    geometric: bool   # cone > 0: the ladder's geometric phase
    g: int            # fine grid side
    f: int            # fine cells per coarse cell along an axis
    cg: int           # coarse grid side
    lo: float
    hi: float
    lo_m: float       # lo − 8·dt_min
    hi_m: float       # hi + 8·dt_min
    dt_min: float
    dt_max: float
    cone: float
    inv_dt_min: float  # float32(1) / float32(dt_min)
    t_switch: float   # dt_min / cone
    growth: float     # 1 + cone


def plan(ray_o, bitfield, n_ladder: int, n_slots: int, cone_angle: float,
         aabb_scale: float = 1.0, blocked: Optional[bool] = None) -> Plan:
    """The kernels' `Plan` of a `march_flat` call: the path the plain
    version takes (`ops/ray_march._takes_blocked`), its K and NB."""
    from ..ops import ray_march as rm

    R = ray_o.shape[0]
    K = rm.effective_ladder_points(n_ladder, cone_angle, aabb_scale)
    if blocked is None:
        blocked = rm._takes_blocked(K, cone_angle, bitfield.dim())
    if blocked and cone_angle != 0.0:
        raise ValueError("the blocked march is exact only at cone 0 "
                         f"(got {cone_angle})")
    g = round(bitfield.shape[-1] ** (1.0 / 3.0))
    f = max(1, g // 64)
    lo, hi = rm._cube(aabb_scale)
    margin = BLOCK * MIN_CONE_STEPSIZE
    geometric = cone_angle > 0.0
    return Plan(
        R=R, S=n_slots, K=K, KB=K // BLOCK,
        NB=rm._blocked_nb(R, K // BLOCK), blocked=bool(blocked),
        geometric=geometric, g=g, f=f, cg=g // f, lo=_f32(lo), hi=_f32(hi),
        lo_m=_f32(lo - margin), hi_m=_f32(hi + margin),
        dt_min=_f32(MIN_CONE_STEPSIZE), dt_max=_f32(MAX_CONE_STEPSIZE),
        cone=_f32(cone_angle),
        inv_dt_min=float(np.float32(1.0) / np.float32(MIN_CONE_STEPSIZE)),
        t_switch=_f32(MIN_CONE_STEPSIZE / cone_angle) if geometric else 0.0,
        growth=_f32(1.0 + cone_angle))


def check_inputs(ray_o, ray_d, bitfield, u_start, n_slots: int) -> None:
    """Raise on what the kernels do not take, but for the device
    (`prepare` checks it last)."""
    if bitfield.dim() != 1:
        raise ValueError(
            "the march kernels take a 1-D (G³,) bitfield: marching a "
            f"cascaded {tuple(bitfield.shape)} bitfield is not ported to "
            "the card (no training path passes one)")
    if ray_o.requires_grad or ray_d.requires_grad:
        raise ValueError("the march kernels take rays without a gradient: "
                         "no caller differentiates through the march; "
                         "march under a frozen transform and form the "
                         "positions with sample_positions")
    R = ray_o.shape[0]
    if ray_o.shape != (R, 3) or ray_d.shape != (R, 3) \
            or u_start.shape != (R,) or R < 1 or n_slots < 1:
        raise ValueError(f"shapes {tuple(ray_o.shape)}, {tuple(ray_d.shape)},"
                         f" {tuple(u_start.shape)} and {n_slots} slots: want "
                         "(R, 3), (R, 3), (R,) with R ≥ 1 and S ≥ 1")
    g = round(bitfield.shape[0] ** (1.0 / 3.0))
    if g ** 3 != bitfield.shape[0] or g % max(1, g // 64) or g > MAX_SIDE:
        raise ValueError(f"a bitfield of {bitfield.shape[0]} cells is not a "
                         f"cube of side ≤ {MAX_SIDE} that the coarse grid "
                         "divides")
    bad = [n for n, x in (("ray_o", ray_o), ("ray_d", ray_d),
                          ("u_start", u_start)) if x.dtype != torch.float32]
    if bad or bitfield.dtype != torch.bool:
        raise TypeError(f"the march kernels take float32 rays and jitter and "
                        f"a bool bitfield: {bad or bitfield.dtype}")


class Prepared(NamedTuple):
    """One call's tensors (kept alive while the kernels may read them),
    its plan and the ctypes struct that points the kernels at them."""

    plan: Plan
    inputs: tuple     # o, d, u, bitfield (contiguous)
    outputs: tuple    # t, dt, ray_id, valid, seg_start, n_valid, ray_kept
    coarse: Optional[torch.Tensor]
    work: torch.Tensor
    args: _Args


def prepare(ray_o, ray_d, bitfield, u_start, n_ladder: int, n_slots: int,
            cone_angle: float, aabb_scale: float = 1.0,
            blocked: Optional[bool] = None) -> Prepared:
    """Check the inputs, plan the call and allocate its outputs
    (`torch.empty`: the kernels write every entry)."""
    check_inputs(ray_o, ray_d, bitfield, u_start, n_slots)
    p = plan(ray_o, bitfield, n_ladder, n_slots, cone_angle, aabb_scale,
             blocked)
    devs = {x.device for x in (ray_o, ray_d, bitfield, u_start)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the march kernels take tensors on one CUDA "
                         f"device: {devs}")
    dev, R, S = ray_o.device, p.R, p.S
    inputs = tuple(x.contiguous() for x in (ray_o, ray_d, u_start,
                                            bitfield))
    empty = lambda n, dtype: torch.empty(n, dtype=dtype, device=dev)
    outputs = (empty(S, torch.float32), empty(S, torch.float32),
               empty(S, torch.int64), empty(S, torch.bool),
               empty(R, torch.int64), empty(R, torch.int64),
               empty(R, torch.bool))
    coarse = empty(p.cg ** 3, torch.bool) if p.blocked else None
    work = empty(_library().march_work_words(R), torch.int64)
    ptr = lambda x: None if x is None else x.data_ptr()
    args = _Args(*map(ptr, inputs), ptr(coarse), *map(ptr, outputs),
                 ptr(work),
                 S, R, p.K, p.KB, p.NB, int(p.blocked), int(p.geometric),
                 p.g, p.f, p.cg, p.lo, p.hi, p.lo_m, p.hi_m, p.dt_min,
                 p.dt_max, p.cone, p.inv_dt_min, p.t_switch, p.growth)
    return Prepared(p, inputs, outputs, coarse, work, args)


def _launch(prep: Prepared, name: str, counter: LaunchCounter) -> None:
    lib = _library()
    dev = prep.work.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"march_{name}_launch")(
            ctypes.addressof(prep.args), stream)
    if err != 0:
        raise RuntimeError(f"march_{name} launch failed: "
                           f"{lib.march_error_string(err).decode()} ({err})")
    counter.launches += 1


def launch_coarse(prep: Prepared) -> None:
    _launch(prep, "coarse", coarse_kernel)


def launch_count(prep: Prepared) -> None:
    _launch(prep, "count", count_kernel)


def launch_scan(prep: Prepared) -> None:
    _launch(prep, "scan", scan_kernel)


def launch_write(prep: Prepared) -> None:
    _launch(prep, "write", write_kernel)


def run(prep: Prepared) -> tuple:
    """The call's launches in order; returns its outputs."""
    if prep.plan.blocked:
        launch_coarse(prep)
    launch_count(prep)
    launch_scan(prep)
    launch_write(prep)
    return prep.outputs


def march_flat(ray_o, ray_d, bitfield, u_start, n_ladder: int, n_slots: int,
               cone_angle: float, aabb_scale: float = 1.0,
               blocked: Optional[bool] = None) -> tuple:
    """`ops/ray_march.march_flat` on CUDA tensors: (t, dt, ray_id, valid,
    seg_start, n_valid, ray_kept)."""
    return run(prepare(ray_o, ray_d, bitfield, u_start, n_ladder, n_slots,
                       cone_angle, aabb_scale, blocked))


# ---------------------------------------------------------------------------
# the kernels' loops in PyTorch
# ---------------------------------------------------------------------------

def _coarse_twin(bits: torch.Tensor, p: Plan) -> torch.Tensor:
    """march_coarse_kernel: coarse cell c is set when a fine cell of coarse
    cells c − 1 to c + 1 (per axis) is, i.e. the any over the window
    [(c − 1)·f, (c + 2)·f) of each axis (the kernel ORs y and z, then x:
    the order of an OR does not matter)."""
    x = bits.reshape(1, 1, p.g, p.g, p.g).to(torch.float32)
    pooled = torch.nn.functional.max_pool3d(x, 3 * p.f, stride=p.f,
                                            padding=p.f)
    return (pooled > 0).reshape(-1)


class _Rays(NamedTuple):
    o: torch.Tensor       # (n, 3)
    d: torch.Tensor
    startt: torch.Tensor  # (n,)
    alive: torch.Tensor   # (n,) bool


def _start_twin(o, d, u, p: Plan) -> _Rays:
    """ray_start."""
    inv = torch.tensor(1.0, dtype=torch.float32) / d
    t0 = (p.lo - o) * inv
    t1 = (p.hi - o) * inv
    nan = (torch.isnan(t0) | torch.isnan(t1)).any(dim=1)
    tmin = torch.fmin(t0, t1).amax(dim=1)
    tmax = torch.fmax(t0, t1).amin(dim=1)
    alive = ~nan & (tmax > tmin)
    tmin = torch.clamp_min(tmin, 0.0)
    dt0 = torch.clamp(tmin * p.cone, p.dt_min, p.dt_max)
    return _Rays(o, d, tmin + dt0 * u, alive)


def _ladder_twin(startt: torch.Tensor, k: torch.Tensor, p: Plan):
    """ladder_t: startt (n, 1), k (n, m) or (m,) int."""
    kf = k.to(torch.float32)
    t_const = startt + kf * p.dt_min
    if not p.geometric:
        return t_const
    n0 = torch.ceil(torch.clamp_min(p.t_switch - startt, 0.0)
                    * p.inv_dt_min)
    t_sw = startt + n0 * p.dt_min
    growth = torch.tensor(p.growth, dtype=torch.float32, device=kf.device)
    return torch.where(kf < n0, t_const,
                       t_sw * torch.pow(growth, kf - n0))


def _position(rays: _Rays, t: torch.Tensor) -> torch.Tensor:
    return rays.o[:, None, :] + t[..., None] * rays.d[:, None, :]


def _within(pos, lo, hi) -> torch.Tensor:
    return ((pos >= lo) & (pos <= hi)).all(dim=-1)


def _cell_index(pos: torch.Tensor, n: int) -> torch.Tensor:
    c = torch.clamp((pos * n).to(torch.int64), 0, n - 1)
    return c[..., 0] + n * (c[..., 1] + n * c[..., 2])


def _fine(rays: _Rays, t, bits, p: Plan) -> torch.Tensor:
    pos = _position(rays, t)
    inside = _within(pos, p.lo, p.hi)
    # a cell is read only inside the cube
    return inside & bits[torch.where(inside, _cell_index(pos, p.g), 0)]


def _walk_twin(rays: _Rays, bits, coarse, p: Plan, reads=None):
    """`walk` for every row at once: per row its count and, in walk order,
    (row, rank, t) of each valid point. `reads`, a dict, gathers the
    bitfield and coarse cells the walk reads."""
    n = rays.startt.shape[0]
    dev = rays.startt.device
    lane = torch.arange(32, device=dev)
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    rows, ranks, ts = [], [], []
    startt = rays.startt[:, None]

    def ballot(v, t, has):
        nonlocal count
        if reads is not None:
            pos = _position(rays, t)
            inside = has & _within(pos, p.lo, p.hi)
            reads["fine"].append(_cell_index(pos, p.g)[inside])
        rank = count[:, None] + torch.cumsum(v.to(torch.int64), 1) - v.long()
        r, j = torch.nonzero(v, as_tuple=True)
        rows.append(r)
        ranks.append(rank[r, j])
        ts.append(t[r, j])
        count = count + v.sum(dim=1)

    if not p.blocked:
        for k0 in range(0, p.K, 32):
            k = (k0 + lane)[None, :].expand(n, 32)
            has = (k < p.K) & rays.alive[:, None]
            t = _ladder_twin(startt, k, p)
            ballot(has & _fine(rays, t, bits, p), t, has)
        return count, rows, ranks, ts
    nsel = torch.zeros(n, dtype=torch.int64, device=dev)
    for b0 in range(0, p.KB, 32):
        on = rays.alive & (nsel < p.NB)          # the warp's loop runs
        if not bool(on.any()):
            break
        b = (b0 + lane)[None, :].expand(n, 32)
        has = (b < p.KB) & on[:, None]
        pos = _position(rays, _ladder_twin(startt, b * BLOCK
                                           + (BLOCK - 1) // 2, p))
        inside = has & _within(pos, p.lo_m, p.hi_m)
        cidx = torch.where(inside, _cell_index(pos, p.cg), 0)
        if reads is not None:
            reads["coarse"].append(cidx[inside])
        flag = inside & coarse[cidx]
        take = torch.minimum(flag.sum(dim=1), p.NB - nsel)
        rank = torch.cumsum(flag.to(torch.int64), 1) - flag.long()
        chosen = flag & (rank < take[:, None])
        sel = torch.zeros(n, 33, dtype=torch.int64, device=dev)
        sel.scatter_(1, torch.where(chosen, rank, 32), b.contiguous())
        for j0 in range(0, int(take.max()), 32 // BLOCK):
            j = (j0 + lane // BLOCK)[None, :].expand(n, 32)
            has_j = j < take[:, None]
            k = torch.gather(sel, 1, torch.clamp_max(j, 32)) * BLOCK \
                + lane % BLOCK
            t = _ladder_twin(startt, k, p)
            ballot(has_j & _fine(rays, t, bits, p), t, has_j)
        nsel = nsel + take
    return count, rows, ranks, ts


def _scan_twin(n_valid: torch.Tensor, S: int):
    """march_scan_kernel: each count block's sum, each tile's offset (the
    sum of the earlier blocks' sums), its inclusive scan; ray_kept, the
    kept rays' seg_start (−1 elsewhere: the write pass's) and the total."""
    R = n_valid.shape[0]
    nb = -(-R // WARPS)
    sums = torch.nn.functional.pad(n_valid, (0, nb * WARPS - R)) \
        .reshape(nb, WARPS).sum(dim=1)
    cum = torch.empty_like(n_valid)
    for first in range(0, R, SCAN_TILE):
        offset = sums[:first // WARPS].sum()
        cum[first:first + SCAN_TILE] = offset + torch.cumsum(
            n_valid[first:first + SCAN_TILE], 0)
    kept = cum <= S
    seg_start = torch.where(kept, cum - n_valid, -1)
    nxt = torch.cat([cum[1:], cum.new_full((1,), S + 1)])
    at = kept & (nxt > S)                     # the boundary ray, if any
    total = cum[at].sum() if bool(at.any()) else cum.new_zeros(())
    return kept, seg_start, total


def walk_twin(ray_o, ray_d, bitfield, u_start, n_ladder: int, n_slots: int,
              cone_angle: float, aabb_scale: float = 1.0,
              blocked: Optional[bool] = None, reads: Optional[dict] = None):
    """The kernels' four launches in PyTorch on any device; returns the
    seven `FlatSamples` fields (t, dt, ray_id, valid, seg_start, n_valid,
    ray_kept). `reads`, a dict, receives the cells each pass reads, flat
    indices, one per read: "fine" and "coarse" of the count pass,
    "write_fine" and "write_coarse" of the write pass."""
    if bitfield.dim() != 1:
        raise ValueError("the march kernels take a 1-D (G³,) bitfield")
    p = plan(ray_o, bitfield, n_ladder, n_slots, cone_angle, aabb_scale,
             blocked)
    R, S, dev = p.R, p.S, ray_o.device
    rays = _start_twin(ray_o, ray_d, u_start, p)
    coarse = _coarse_twin(bitfield, p) if p.blocked else None
    passes = ({"fine": [], "coarse": []}, {"fine": [], "coarse": []})
    n_valid, *_ = _walk_twin(rays, bitfield, coarse, p, passes[0])
    ray_kept, seg_start, total = _scan_twin(n_valid, S)
    # the write pass: the kept rays with samples walk again
    walkers = torch.nonzero(ray_kept & (n_valid > 0)).flatten()
    sub = _Rays(*(x[walkers] for x in rays))
    _, rows, ranks, ts = _walk_twin(sub, bitfield, coarse, p, passes[1])
    if reads is not None:
        for prefix, got in zip(("", "write_"), passes):
            for key, idx in got.items():
                reads[prefix + key] = torch.cat(idx) if idx else \
                    torch.zeros(0, dtype=torch.int64, device=dev)
    seg_start = torch.where(ray_kept, seg_start, total)
    t = torch.zeros(S, dtype=torch.float32, device=dev)
    ray_id = torch.full((S,), R, dtype=torch.int64, device=dev)
    valid = torch.zeros(S, dtype=torch.bool, device=dev)
    if rows:
        r = walkers[torch.cat(rows)]
        slot = seg_start[r] + torch.cat(ranks)
        t[slot] = torch.cat(ts)
        ray_id[slot] = r
        valid[slot] = True
    dt = torch.clamp(t * p.cone, p.dt_min, p.dt_max)
    return t, dt, ray_id, valid, seg_start, n_valid, ray_kept
