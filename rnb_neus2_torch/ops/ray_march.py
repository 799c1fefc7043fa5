"""Ray marching as a fixed-shape ladder: global compaction for training,
dense per-ray compaction for rendering (port of
`rnb_neus2_tpu/ops/ray_march.py`).

Both the occupied step and the empty-space skip of the reference's march
(testbed_nerf.cu:1216-1387) keep t on one deterministic ladder
t_{k+1} = t_k + max(t_k·cone, dt_min) seeded at the jittered entry point,
so the visited sample set is exactly {ladder points inside the AABB that
land in occupied cells}. All rays' samples pack into one S-slot buffer
(S = the 2^18 target batch); a ray that would overflow the remaining budget
is dropped whole (:1352-1356).

Every output is an integer, a bool or the closed-form ladder t, computed
with the JAX package's float32 operations in the same order, so the march
equals the JAX package's bit for bit. At cone 0 the two-phase blocked path
runs: a dilated coarse-grid probe per 8-point block, then fine occupancy
inside each ray's first NB = min(K/8, max(32, 2^20/R)) flagged blocks.

`march` (the inference renderer's) keeps each ray's first M valid ladder
points in order, an (R, M) layout; it too equals the JAX package's bit for
bit.

On CUDA tensors `march_flat` runs the hand-written kernels of
`kernels/march.py` (`csrc/march.cu`), bit for bit with the plain version
(`march_flat_plain`, the CPU path); they take a 1-D bitfield only.

`aabb_scale` > 1 marches the cube [0.5 ∓ aabb_scale/2]; given a (C, G³)
bitfield, both marches consult the cascaded occupancy grid with the
reference's mip selection (testbed_nerf.cu:569-583, 755-790). The JAX
package's trainer passes neither, so at aabb_scale > 1 it trains on the
unit cube and a 1-D bitfield at cone 1/256 (the single-phase path).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE
from ..geom.camera import ray_aabb
from ..grid import occupancy
from ..kernels import march as march_kernels


class FlatSamples(NamedTuple):
    """Globally compacted sample buffer (S slots). Integer fields are
    int64."""

    t: torch.Tensor          # (S,) sample distance along its ray
    dt: torch.Tensor         # (S,) step size
    ray_id: torch.Tensor     # (S,) owner ray; R (sentinel) for unused
    valid: torch.Tensor      # (S,) slot holds a real sample
    seg_start: torch.Tensor  # (R,) first slot of each ray (= offsets)
    n_valid: torch.Tensor    # (R,) per-ray occupied count BEFORE drops
    ray_kept: torch.Tensor   # (R,) ray survived the budget drop


class MarchedRays(NamedTuple):
    t: torch.Tensor        # (R, M) sample distances (ladder points)
    dt: torch.Tensor       # (R, M) step sizes at those points
    valid: torch.Tensor    # (R, M) sample exists
    n_valid: torch.Tensor  # (R,) occupied-sample count (pre-truncation)


def ladder_t_at(startt: torch.Tensor, k: torch.Tensor,
                cone_angle: float) -> torch.Tensor:
    """Closed-form ladder point k (any int tensor broadcastable with
    startt). Phase 1 (t < dt_min/cone): t_k = startt + k·dt_min; phase 2:
    geometric, t_{k+1} = t_k·(1+cone)."""
    k = k.to(torch.float32)
    dt_min = MIN_CONE_STEPSIZE
    if cone_angle <= 0.0:
        return startt + k * dt_min
    t_switch = dt_min / cone_angle
    n0 = torch.ceil(torch.clamp_min(t_switch - startt, 0.0) / dt_min)
    t_const = startt + k * dt_min
    t_sw = startt + n0 * dt_min
    t_geom = t_sw * torch.pow(
        torch.tensor(1.0 + cone_angle, dtype=torch.float32,
                     device=startt.device), k - n0)
    return torch.where(k < n0, t_const, t_geom)


def t_ladder(startt: torch.Tensor, n_points: int,
             cone_angle: float) -> torch.Tensor:
    """(R,) start distances → (R, K) ladder; closed form, no scan."""
    k = torch.arange(n_points, device=startt.device)[None, :]
    return ladder_t_at(startt[:, None], k, cone_angle)


def _step_size(t: torch.Tensor, cone_angle: float) -> torch.Tensor:
    return torch.clamp(t * cone_angle, MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE)


def _start(ray_o, ray_d, u_start, cone_angle, lo, hi):
    tmin, tmax = ray_aabb(ray_o, ray_d, lo, hi)
    tmin = torch.clamp_min(tmin, 0.0)
    dt0 = _step_size(tmin, cone_angle)
    return tmin, tmax, tmin + dt0 * u_start


def _cube(aabb_scale: float):
    return 0.5 - aabb_scale / 2.0, 0.5 + aabb_scale / 2.0


def _ladder_valid(ray_o, ray_d, bitfield, u_start, n_ladder, cone_angle,
                  aabb_scale: float = 1.0):
    """(R, K) ladder t, dt, valid, the per-ray valid count, and startt.
    A (C, G³) bitfield is looked up across its cascades."""
    lo, hi = _cube(aabb_scale)
    tmin, tmax, startt = _start(ray_o, ray_d, u_start, cone_angle, lo, hi)
    t = t_ladder(startt, n_ladder, cone_angle)               # (R, K)
    dt = _step_size(t, cone_angle)
    pos = ray_o[:, None, :] + t[..., None] * ray_d[:, None, :]
    inside = torch.all((pos >= lo) & (pos <= hi), dim=-1)
    inside &= (tmax > tmin)[:, None]
    if bitfield.dim() == 2:
        occ = occupancy.lookup_cascaded(bitfield, pos, dt)
    else:
        occ = occupancy.lookup(bitfield, pos)
    valid = inside & occ
    return t, dt, valid, valid.sum(dim=1), startt


def effective_ladder_points(n_ladder: int, cone_angle: float,
                            aabb_scale: float = 1.0) -> int:
    """Tight static bound on the ladder points any ray can place inside the
    marched cube (unit-norm ray directions); trimming K to it is bit-exact
    because the points past the exit are masked."""
    diag = aabb_scale * math.sqrt(3.0)
    dt_min = MIN_CONE_STEPSIZE
    if cone_angle <= 0.0:
        need = int(math.ceil(diag / dt_min))
    else:
        t_switch = dt_min / cone_angle
        n0 = math.ceil(t_switch / dt_min)
        geo = (math.log(diag / t_switch) / math.log1p(cone_angle)
               if diag > t_switch else 0.0)
        need = int(n0 + math.ceil(geo))
    return min(n_ladder, max(need + 8, 1))   # +8 jitter/rounding margin


def march(ray_o: torch.Tensor, ray_d: torch.Tensor, bitfield: torch.Tensor,
          u_start: torch.Tensor, n_ladder: int, max_samples: int,
          cone_angle: float, aabb_scale: float = 1.0) -> MarchedRays:
    """Dense per-ray compaction: the first M valid samples of each ray, in
    ladder order (the JAX package's order-preserving top-k; the keys are
    distinct, so `torch.topk` picks the same indices). ray_d must be
    unit-norm; the ladder is trimmed as in `march_flat`, which drops only
    points that are never valid."""
    n_ladder = effective_ladder_points(n_ladder, cone_angle, aabb_scale)
    max_samples = min(max_samples, n_ladder)
    t, dt, valid, n_valid, _ = _ladder_valid(ray_o, ray_d, bitfield, u_start,
                                             n_ladder, cone_angle, aabb_scale)
    k = torch.arange(n_ladder, device=ray_o.device)[None, :]
    key = torch.where(valid, -k, -(n_ladder + k))        # valid sort first
    sel = torch.topk(key, max_samples, dim=1, sorted=True).indices
    take = lambda a: torch.gather(a, 1, sel)
    return MarchedRays(t=take(t), dt=take(dt), valid=take(valid),
                       n_valid=n_valid)


BLOCK = 8          # fine ladder points per coarse block (blocked path)


def _coarse_dilated(bitfield: torch.Tensor, grid_size: int):
    """Pool the fine bitfield to ~64³ and dilate by one coarse cell (3³
    any-pool): a conservative coarse occupancy. Returns (flat, cgrid)."""
    g = grid_size
    f = max(1, g // 64)
    cg = g // f
    b3 = bitfield.reshape(cg, f, cg, f, cg, f).any(dim=5).any(dim=3) \
        .any(dim=1)
    p = torch.nn.functional.pad(b3, (1, 1, 1, 1, 1, 1), value=False)
    dil = torch.zeros_like(b3)
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                dil = dil | p[dx:dx + cg, dy:dy + cg, dz:dz + cg]
    return dil.reshape(-1), cg


def _blocked_nb(R: int, n_blocks: int) -> int:
    """Per-R block budget: full coverage (exact) up to R = 8192; above
    that each ray keeps its FIRST NB coarse-occupied blocks."""
    return min(n_blocks, max(32, (1 << 20) // max(R, 1)))


def _compact(valid, n_valid, n_slots):
    """Slot-side reconstruction shared by both paths. valid: (R, C) bool
    on the per-ray lattice. Returns the FlatSamples integer fields and the
    lattice index j of each slot's sample."""
    R, C = valid.shape
    dev = valid.device
    cum = torch.cumsum(n_valid, 0)
    ray_kept = cum <= n_slots                 # drop whole overflowing rays
    counts = torch.where(ray_kept, n_valid, torch.zeros_like(n_valid))
    offsets = torch.cumsum(counts, 0) - counts                  # (R,)
    total = counts.sum()
    slot_ids = torch.arange(n_slots, device=dev)
    valid_flat = slot_ids < total
    # ray id of each slot: forward fill of each kept ray's id written at
    # its segment start
    ray_ids = torch.arange(R, device=dev)
    seg_write = ray_kept & (n_valid > 0)
    where = torch.where(seg_write, offsets, torch.full_like(offsets, n_slots))
    starts = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, where, ray_ids, reduce="amax",
                        include_self=True)[:n_slots]
    rid_flat = torch.where(valid_flat, torch.cummax(starts, 0).values,
                           torch.full_like(starts, R))
    # lattice index of each slot's sample: binary search of its intra-ray
    # rank in the ray's running valid count
    rank1 = torch.cumsum(valid.to(torch.int64), dim=1).reshape(-1)
    rid_c = torch.clamp_max(rid_flat, R - 1)
    j1 = slot_ids - offsets[rid_c] + 1        # 1-based intra-ray rank
    lo = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    hi = torch.full((n_slots,), C - 1, dtype=torch.int64, device=dev)
    base = rid_c * C
    # An unused slot has no answer and its search runs past the lattice;
    # its index is clamped (JAX clamps out-of-range gathers the same way)
    # and its result is discarded by the callers.
    last = R * C - 1
    for _ in range(max(1, (C - 1).bit_length())):
        mid = (lo + hi) >> 1
        ge = rank1[torch.clamp_max(base + mid, last)] >= j1
        lo = torch.where(ge, lo, mid + 1)     # first j with rank1 ≥ j1
        hi = torch.where(ge, mid, hi)
    return rid_flat, rid_c, valid_flat, offsets, ray_kept, \
        torch.clamp_max(lo, C - 1)


def _takes_blocked(K: int, cone_angle: float, bitfield_dim: int) -> bool:
    """blocked=None's path: the two-phase march at cone 0 with a 1-D
    bitfield, the single-phase ladder otherwise."""
    return (cone_angle == 0.0 and bitfield_dim == 1 and K % BLOCK == 0
            and K >= 64)


def march_flat(ray_o: torch.Tensor, ray_d: torch.Tensor,
               bitfield: torch.Tensor, u_start: torch.Tensor, n_ladder: int,
               n_slots: int, cone_angle: float, aabb_scale: float = 1.0,
               blocked: bool | None = None) -> FlatSamples:
    """Global compaction into a fixed S-slot buffer with whole-ray drops
    on budget overflow (the reference's count + atomicAdd compaction,
    testbed_nerf.cu:1332-1364). ray_d must be unit-norm. blocked=None takes
    the two-phase path at cone 0 with a 1-D bitfield (bitwise identical to
    the single-phase ladder whenever NB == K/8, i.e. R ≤ 8192), the
    single-phase ladder otherwise.

    CUDA tensors go through the hand-written kernels
    (`kernels/march.march_flat`, bit for bit with the plain version; they
    raise on a cascaded bitfield and on rays that require grad), CPU
    tensors through `march_flat_plain`."""
    if ray_o.device.type == "cuda":
        return FlatSamples(*march_kernels.march_flat(
            ray_o, ray_d, bitfield, u_start, n_ladder, n_slots, cone_angle,
            aabb_scale, blocked))
    return march_flat_plain(ray_o, ray_d, bitfield, u_start, n_ladder,
                            n_slots, cone_angle, aabb_scale, blocked)


def march_flat_plain(ray_o: torch.Tensor, ray_d: torch.Tensor,
                     bitfield: torch.Tensor, u_start: torch.Tensor,
                     n_ladder: int, n_slots: int, cone_angle: float,
                     aabb_scale: float = 1.0,
                     blocked: bool | None = None) -> FlatSamples:
    """`march_flat` in plain PyTorch on any device: the port's CPU path and
    the kernels' specification (bit for bit with the JAX package)."""
    K = effective_ladder_points(n_ladder, cone_angle, aabb_scale)
    if blocked is None:
        blocked = _takes_blocked(K, cone_angle, bitfield.dim())
    if blocked:
        return _march_flat_blocked(ray_o, ray_d, bitfield, u_start, K,
                                   n_slots, cone_angle, aabb_scale)
    t, dt, valid, n_valid, startt = _ladder_valid(
        ray_o, ray_d, bitfield, u_start, K, cone_angle, aabb_scale)
    rid_flat, rid_c, valid_flat, offsets, ray_kept, k_flat = _compact(
        valid, n_valid, n_slots)
    t_flat = torch.where(valid_flat,
                         ladder_t_at(startt[rid_c], k_flat, cone_angle), 0.0)
    return FlatSamples(t=t_flat, dt=_step_size(t_flat, cone_angle),
                       ray_id=rid_flat, valid=valid_flat, seg_start=offsets,
                       n_valid=n_valid, ray_kept=ray_kept)


def _march_flat_blocked(ray_o, ray_d, bitfield, u_start, K: int,
                        n_slots: int, cone_angle: float,
                        aabb_scale: float = 1.0) -> FlatSamples:
    """Two-phase march (cone 0). Phase A probes each ray's K/8 block
    midpoints against the dilated coarse occupancy (a proven superset).
    Phase B keeps each ray's first NB flagged blocks (order-preserving
    top-k) and reads fine occupancy only inside them; the slot-side
    reconstruction runs on the compact (R, NB·8) lattice and maps back to
    ladder indices through the block map."""
    if cone_angle != 0.0:
        raise ValueError("the blocked march is exact only at cone 0 "
                         f"(got {cone_angle})")
    R = ray_o.shape[0]
    dev = ray_o.device
    B = BLOCK
    KB = K // B
    NB = _blocked_nb(R, KB)
    lo, hi = _cube(aabb_scale)
    g = round(bitfield.shape[0] ** (1.0 / 3.0))
    coarse, cg = _coarse_dilated(bitfield, g)
    tmin, tmax, startt = _start(ray_o, ray_d, u_start, cone_angle, lo, hi)

    # ---- phase A: block flags ------------------------------------------
    kmid = torch.arange(KB, device=dev)[None, :] * B + (B - 1) // 2
    t_mid = ladder_t_at(startt[:, None], kmid, cone_angle)      # (R, KB)
    pos_mid = ray_o[:, None, :] + t_mid[..., None] * ray_d[:, None, :]
    margin = B * MIN_CONE_STEPSIZE
    inside_sup = torch.all((pos_mid >= lo - margin)
                           & (pos_mid <= hi + margin), dim=-1)
    inside_sup &= (tmax > tmin)[:, None]
    cell = torch.clamp((pos_mid * cg).to(torch.int64), 0, cg - 1)
    cidx = cell[..., 0] + cg * (cell[..., 1] + cg * cell[..., 2])
    flags = inside_sup & coarse[cidx]                           # (R, KB)

    # ---- phase B: first NB flagged blocks, fine occupancy ---------------
    bids = torch.arange(KB, device=dev)[None, :]
    key = torch.where(flags, -bids, -(KB + bids))               # distinct
    sel = torch.topk(key, NB, dim=1, sorted=True).indices       # (R, NB)
    sel_on = torch.gather(flags, 1, sel)                        # (R, NB)
    kf = sel[..., None] * B + torch.arange(B, device=dev)       # (R,NB,B)
    t_f = ladder_t_at(startt[:, None, None], kf, cone_angle)
    pos = ray_o[:, None, None, :] + t_f[..., None] * ray_d[:, None, None, :]
    inside = torch.all((pos >= lo) & (pos <= hi), dim=-1)
    valid = inside & occupancy.lookup(bitfield, pos) & sel_on[..., None]
    valid = valid.reshape(R, NB * B)
    n_valid = valid.sum(dim=1)

    rid_flat, rid_c, valid_flat, offsets, ray_kept, j_flat = _compact(
        valid, n_valid, n_slots)
    # ladder index through the block map: sel[rid, j//B]·B + j%B
    sel_flat = sel.reshape(-1)[rid_c * NB + j_flat // B]
    k_flat = sel_flat * B + j_flat % B
    t_flat = torch.where(valid_flat,
                         ladder_t_at(startt[rid_c], k_flat, cone_angle), 0.0)
    return FlatSamples(t=t_flat, dt=_step_size(t_flat, cone_angle),
                       ray_id=rid_flat, valid=valid_flat, seg_start=offsets,
                       n_valid=n_valid, ray_kept=ray_kept)
