"""Render paths of the inherited instant-ngp Sdf and Volume modes (port of
`rnb_neus2_tpu/render/sdf_volume_render.py`).

SDF mode (reference: src/testbed_sdf.cu):
- sphere tracing with a fixed trip count and alive masks
  (advance_pos_kernel_sdf, :150-222: pos += predicted_distance·dir,
  converged when the step falls under maximum_distance);
- soft shadow rays toward the sun with the min-visibility estimator
  (prepare_shadow_rays / write_shadow_ray_result, :234-297);
- Disney-BRDF-lite shading (evaluate_shading, :78-147) with the
  reference's default BRDFParams (sdf.h:61-71), the sun/sky/checkerboard
  floor palette of shade_kernel_sdf (:299-360) and its render modes
  (ao, shade, depth, positions, normals, cost).

Volume mode (reference: src/testbed_volume.cu):
- ratio tracking (volume_render_kernel_step, :330-392): exponential
  free-flight steps of mean distance_scale/majorant, per-event alpha =
  min(density/majorant, 1)·T, front-to-back, ending at opacity 0.99 or on
  leaving the cube; events emit a constant albedo, as the JAX package's
  density-only VolumeField does;
- the procedural sun/sky envmap behind (proc_envmap, :47-62).

Every tracer runs over all pixels at once with a fixed trip count, as in
the JAX package. The free-flight uniforms come from an explicit
`torch.Generator`, or are given (`uniforms`), which the tests use to
inject the JAX package's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class BRDFParams:
    """include/neural-graphics-primitives/sdf.h:61-71 defaults."""

    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 1.0
    roughness: float = 0.5
    sheen: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    basecolor: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    ambientcolor: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _mix(a, b, t):
    return a + (b - a) * t


def _schlick(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    return (m * m) ** 2 * m


def _g1(ndoth, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    if a >= 1.0:
        return torch.full_like(ndoth, 1.0 / math.pi)
    return (a2 - 1.0) / (math.pi * math.log(a2) * t)


def _g2(ndoth, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (math.pi * t * t)


def _smith_ggx(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + torch.sqrt(a + b - a * b))


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def evaluate_shading(base_color, ambient_color, light_color,
                     brdf: BRDFParams, L, V, N, metallic=None, specular=None,
                     roughness=None) -> torch.Tensor:
    """evaluate_shading (testbed_sdf.cu:78-147). Colors and L/V/N are
    (..., 3); the scalar overrides carry the floor's material."""
    ndotl = torch.sum(N * L, dim=-1)
    shape = ndotl.shape
    metallic = torch.broadcast_to(_vec(
        brdf.metallic if metallic is None else metallic, ndotl), shape)
    specular = torch.broadcast_to(_vec(
        brdf.specular if specular is None else specular, ndotl), shape)
    roughness = torch.broadcast_to(_vec(
        brdf.roughness if roughness is None else roughness, ndotl), shape)
    ndotv = torch.sum(N * V, dim=-1)
    H = L + V
    H = H / torch.linalg.norm(H, dim=-1, keepdim=True)
    ndoth = torch.sum(N * H, dim=-1)
    ldoth = torch.sum(L * H, dim=-1)

    fl, fv = _schlick(ndotl), _schlick(ndotv)
    amb = ambient_color * _mix(0.2, fv, metallic)[..., None] * base_color

    luminance = torch.sum(base_color * _vec([0.3, 0.6, 0.1], ndotl), dim=-1)
    ctint = base_color / (luminance[..., None] + 1e-5)
    cspec0 = _mix(torch.ones_like(ctint) * (specular * 0.08)[..., None],
                  base_color, metallic[..., None])
    fd90 = 0.5 + 2.0 * ldoth * ldoth * roughness
    fd = _mix(1.0, fd90, fl) * _mix(1.0, fd90, fv)

    fss90 = ldoth * ldoth * roughness
    fss = _mix(1.0, fss90, fl) * _mix(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp_min(ndotl + ndotv, 1e-6) - 0.5)
                 + 0.5)

    a = torch.clamp_min(roughness * roughness, 0.001)
    ds = _g2(ndoth, a)
    fh = _schlick(ldoth)
    fs = _mix(cspec0, torch.ones_like(cspec0), fh[..., None])
    gs = _smith_ggx(ndotl, a) * _smith_ggx(ndotv, a)

    fsheen = fh[..., None] * brdf.sheen * torch.ones_like(ctint)

    dr = _g1(ndoth, _mix(0.1, 0.001, brdf.clearcoat_gloss))
    fr = _mix(0.04, 1.0, fh)
    gr = _smith_ggx(ndotl, 0.25) * _smith_ggx(ndotv, 0.25)
    ccs = 0.25 * brdf.clearcoat * gr * fr * dr

    diffuse = ((1.0 / math.pi) * _mix(fd, ss, brdf.subsurface)[..., None]
               * base_color + fsheen)
    out = (diffuse * (1.0 - metallic)[..., None]
           + (gs * ds)[..., None] * fs + ccs[..., None])
    lit = out * light_color * torch.clamp_min(ndotl, 0.0)[..., None] + amb
    # the reference returns only the ambient term when the surface faces
    # away from the light or the camera
    facing = (ndotl >= 0.0) & (ndotv >= 0.0)
    return torch.where(facing[..., None], lit, amb)


# ---------------------------------------------------------------------------
# cameras + sphere tracing
# ---------------------------------------------------------------------------

def orbit_camera(theta: float = 0.6, phi: float = 0.4, radius: float = 1.6,
                 center=(0.5, 0.5, 0.5), device="cpu"):
    """A look-at camera about the unit cube (the facade's default view):
    (rot (3, 3), eye (3,)), computed in numpy float32 as the JAX
    package does."""
    c = np.asarray(center, np.float32)
    eye = c + radius * np.asarray([
        math.cos(phi) * math.sin(theta),
        math.sin(phi),
        math.cos(phi) * math.cos(theta)], np.float32)
    fwd = c - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd], axis=1)  # columns = x, y, z axes
    return (torch.as_tensor(rot, device=device),
            torch.as_tensor(eye, device=device))


def camera_rays(rot: torch.Tensor, eye: torch.Tensor, W: int, H: int,
                fov_deg: float = 50.0):
    """Pixel-centre rays (x right, y down, z forward): (o, d), each
    (H·W, 3)."""
    focal = 0.5 * W / math.tan(0.5 * math.radians(fov_deg))
    dev = rot.device
    u = (torch.arange(W, device=dev) + 0.5 - 0.5 * W) / focal
    v = (torch.arange(H, device=dev) + 0.5 - 0.5 * H) / focal
    vv, uu = torch.meshgrid(v, u, indexing="ij")                # (H, W)
    d_cam = torch.stack([uu, vv, torch.ones_like(uu)], -1).reshape(-1, 3)
    d = d_cam @ rot.T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.broadcast_to(eye, d.shape), d


def _aabb_enter(o, d, lo=0.0, hi=1.0):
    inv = 1.0 / d
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.clamp_min(tmin, 0.0), tmax


def _in_box(p):
    return torch.all((p >= 0.0) & (p <= 1.0), dim=-1)


@torch.no_grad()
def sphere_trace(sdf_fn: Callable, o, d, n_steps: int = 80,
                 zero_offset: float = 0.0, distance_scale: float = 0.95,
                 maximum_distance: float = 5e-5,
                 track_visibility: bool = False,
                 shadow_sharpness: float = 2048.0):
    """advance_pos_kernel_sdf (testbed_sdf.cu:150-222) over all rays at
    once, `n_steps` trips: each alive ray advances by the scaled predicted
    distance until the step drops under maximum_distance. Returns
    (positions, hit, steps taken, min visibility)."""
    t_enter, t_exit = _aabb_enter(o, d)
    pos = o + (t_enter + 1e-4)[:, None] * d
    alive = inside = t_enter < t_exit
    n = o.shape[0]
    steps = torch.zeros(n, dtype=torch.int32, device=o.device)
    minvis = torch.ones(n, device=o.device)
    prev = torch.full((n,), 1e10, device=o.device)
    total = torch.zeros(n, device=o.device)
    for _ in range(n_steps):
        dist = (sdf_fn(pos) - zero_offset) * distance_scale
        newpos = pos + dist[:, None] * d
        if track_visibility:
            # soft shadows (advance_pos_kernel_sdf:199-208)
            y = dist * dist / (2.0 * prev)
            dd = torch.sqrt(torch.clamp_min(dist * dist - y * y, 0.0))
            vis = shadow_sharpness * dd / torch.clamp_min(total - y, 1e-6)
            minvis = torch.where(alive & (dist > 0),
                                 torch.minimum(minvis, vis), minvis)
            prev = torch.where(alive, dist, prev)
            total = torch.where(alive, total + dist, total)
        converged = torch.abs(dist) <= maximum_distance
        pos = torch.where(alive[:, None], newpos, pos)
        steps = steps + alive.to(torch.int32)
        alive = alive & _in_box(newpos) & ~converged
    in_box = _in_box(pos)
    hit = inside & in_box & ~alive
    # occluded shadow rays (still alive = reached something) see 0
    if track_visibility:
        minvis = torch.where(~alive & in_box, torch.zeros_like(minvis),
                             torch.clamp(minvis, 0.0, 1.0))
    else:
        minvis = torch.clamp(minvis, 0.0, 1.0)
    return pos, hit, steps, minvis


SUN_COLOR = (255.0 / 255.0, 225.0 / 255.0, 195.0 / 255.0)      # :341
SKY_COLOR = (195.0 / 255.0, 215.0 / 255.0, 255.0 / 255.0)      # :342
DEFAULT_SUN_DIR = (1.0 / math.sqrt(3.0),) * 3                  # testbed.h:543
DEFAULT_UP_DIR = (0.0, 1.0, 0.0)                               # testbed.h:542


def _sdf_normal(sdf_fn: Callable, pos: torch.Tensor) -> torch.Tensor:
    """∇sdf at `pos` by autograd through the field (the position
    cotangent of its encoding)."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sdf_fn(p).sum(), p)
    return g


def render_sdf(sdf_fn: Callable, W: int = 256, H: int = 256,
               mode: str = "shade", brdf: BRDFParams = BRDFParams(),
               rot=None, eye=None, fov_deg: float = 50.0,
               sun_dir=DEFAULT_SUN_DIR, up_dir=DEFAULT_UP_DIR,
               floor_y: float = -10.0, n_steps: int = 80,
               shadows: bool = True, device="cpu"):
    """A whole SDF frame (render_sdf + shade_kernel_sdf): (H, W, 4) RGBA
    and (H, W) depth. `sdf_fn` maps (N, 3) positions to (N,) distances;
    the camera defaults to `orbit_camera` on `device`."""
    if rot is None or eye is None:
        rot, eye = orbit_camera(device=device)
    o, d = camera_rays(rot, eye, W, H, fov_deg)
    pos, hit, steps, _ = sphere_trace(sdf_fn, o, d, n_steps=n_steps)

    sun = _vec(sun_dir, pos)
    sun = sun / torch.linalg.norm(sun)
    up = _vec(up_dir, pos)

    grad = _sdf_normal(sdf_fn, pos)
    normal = grad / torch.clamp_min(
        torch.linalg.norm(grad, dim=-1, keepdim=True), 1e-9)
    floor = (pos[:, 1] < floor_y + 1e-3) & (d[:, 1] < 0.0)
    normal = torch.where(floor[:, None], _vec([0.0, 1.0, 0.0], pos), normal)

    depth = torch.sum((pos - eye) * rot[:, 2], dim=-1)

    if mode == "shade":
        if shadows:
            # shadow rays toward the sun (prepare_shadow_rays: the origin
            # offset out of the surface along the normal)
            so = pos + normal * 1e-3
            _, _, _, vis = sphere_trace(sdf_fn, so,
                                        torch.broadcast_to(sun, so.shape),
                                        n_steps=n_steps,
                                        track_visibility=True)
        else:
            vis = torch.ones_like(pos[:, 0])
        skyam = -torch.sum(normal * up, dim=-1) * 0.5 + 0.5
        suncol = _vec(SUN_COLOR, pos) * 4.0 * vis[:, None]
        skycol = _vec(SKY_COLOR, pos) * 4.0 * skyam[:, None]
        base = _vec(brdf.basecolor, pos) ** 2
        amb = _vec(brdf.ambientcolor, pos) * skycol
        check_size = 8.0
        check = ((torch.floor(check_size * pos[:, 0]).to(torch.int32)
                  ^ torch.floor(check_size * pos[:, 2]).to(torch.int32))
                 & 1).to(torch.float32) * 0.6 + 0.2
        floorcol = torch.stack([check ** 3, check ** 2, check], dim=-1)
        zero, one, half = (torch.zeros_like(check), torch.ones_like(check),
                           torch.full_like(check, 0.5))
        color = evaluate_shading(
            torch.where(floor[:, None], floorcol, base), amb, suncol, brdf,
            torch.broadcast_to(sun, pos.shape), -d, normal,
            metallic=torch.where(floor, zero, zero + brdf.metallic),
            specular=torch.where(floor, one, zero + brdf.specular),
            roughness=torch.where(floor, half, zero + brdf.roughness))
    elif mode == "ao":
        color = torch.broadcast_to((0.92 ** steps.to(torch.float32))[:, None],
                                   pos.shape)
    elif mode == "depth":
        color = torch.broadcast_to(depth[:, None], pos.shape)
    elif mode == "positions":
        color = (pos - 0.5) / 2.0 + 0.5
    elif mode == "normals":
        color = 0.5 * normal + 0.5
    elif mode == "cost":
        color = torch.broadcast_to((steps / 30.0)[:, None], pos.shape)
    else:
        raise ValueError(f"unknown SDF render mode {mode!r}")

    rgba = torch.cat([torch.where(hit[:, None], color,
                                  torch.zeros_like(color)),
                      hit[:, None].to(torch.float32)], dim=-1)
    return (rgba.reshape(H, W, 4).detach(),
            torch.where(hit, depth, torch.zeros_like(depth)).reshape(H, W))


# ---------------------------------------------------------------------------
# volume rendering (testbed_volume.cu)
# ---------------------------------------------------------------------------

def proc_envmap(d, up, sun, skycol) -> torch.Tensor:
    """The procedural sun/sky background (testbed_volume.cu:47-62)."""
    skyam = torch.sum(d * up, dim=-1) * 0.5 + 0.5
    sunam = torch.clamp_min(torch.sum(d * sun, dim=-1), 0.0) ** 64
    sun_rgb = _vec([255.0 / 255.0, 215.0 / 255.0, 195.0 / 255.0], d)
    return skycol * skyam[:, None] + sun_rgb * (20.0 * sunam[:, None])


def free_flight_uniforms(n_events: int, n_rays: int,
                         generator: torch.Generator | None = None,
                         device="cpu") -> torch.Tensor:
    """(n_events, n_rays) uniforms in [1e-7, 1) for the free-flight
    steps."""
    u = torch.rand((n_events, n_rays), generator=generator, device=device)
    return torch.clamp_min(u * (1.0 - 1e-7) + 1e-7, 1e-7)


@torch.no_grad()
def render_volume(density_fn: Callable, W: int = 256, H: int = 256,
                  rot=None, eye=None, fov_deg: float = 50.0,
                  generator: torch.Generator | None = None,
                  uniforms: torch.Tensor | None = None,
                  global_majorant: float = 1.0,
                  distance_scale: float = 1.0, albedo: float = 0.95,
                  sky_col=(0.05, 0.25, 0.5), sun_dir=DEFAULT_SUN_DIR,
                  up_dir=DEFAULT_UP_DIR, max_events: int = 128,
                  device="cpu") -> torch.Tensor:
    """Ratio tracking (volume_render_kernel_step, testbed_volume.cu:
    330-392) → (H, W, 4) RGBA: `max_events` free-flight steps per ray of
    length −log(u)·distance_scale/majorant, alpha = min(density/majorant,
    1)·T per event, finished at opacity 0.99 or outside the cube; the
    remaining transmittance sees the procedural envmap. `uniforms`
    ((max_events, H·W) in (0, 1]) default to `free_flight_uniforms` from
    `generator`."""
    if rot is None or eye is None:
        rot, eye = orbit_camera(device=device)
    o, d = camera_rays(rot, eye, W, H, fov_deg)
    n = o.shape[0]
    if uniforms is None:
        uniforms = free_flight_uniforms(max_events, n, generator, o.device)
    t_enter, t_exit = _aabb_enter(o, d)
    alive = t_enter < t_exit
    pos = o + (t_enter + 1e-5)[:, None] * d
    scale = distance_scale / global_majorant

    sun = _vec(sun_dir, o)
    sun = sun / torch.linalg.norm(sun)
    up = _vec(up_dir, o)
    sky = _vec(sky_col, o)

    rgb = torch.zeros((n, 3), device=o.device)
    opa = torch.zeros(n, device=o.device)
    for i in range(max_events):
        step = -torch.log(uniforms[i]) * scale
        newpos = pos + step[:, None] * d
        in_box = _in_box(newpos)
        ext = torch.clamp_max(density_fn(newpos) / global_majorant, 1.0)
        alpha = torch.where(alive & in_box, ext * (1.0 - opa),
                            torch.zeros_like(opa))
        rgb = rgb + albedo * alpha[:, None]
        opa = opa + alpha
        alive = alive & in_box & (opa <= 0.99)
        pos = torch.where(alive[:, None], newpos, pos)
    rgb = rgb + (1.0 - opa)[:, None] * proc_envmap(d, up, sun, sky)
    rgba = torch.cat([rgb, torch.ones((n, 1), device=o.device)], dim=-1)
    return rgba.reshape(H, W, 4)
