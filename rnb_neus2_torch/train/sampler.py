"""Training ray-batch assembly (port of
`rnb_neus2_tpu/train/sampler.py:sample_ray_batch`).

- image choice: stratified img = i·n_images / n_rays;
- pixel: uniform continuous xy per ray, texel at floor(xy·res), snapped to
  the pixel center by default (testbed.h:650);
- with an error map and either of its knobs on (off by default, as in
  the reference, testbed.h:663-664), images and pixels are drawn from
  the error map's CDFs instead (`error_map.sample`);
- black-pixel skip: texels whose premultiplied linear red ≤ 0 are dropped
  when u_skip ≥ 0.9 (testbed_nerf.cu:1264-1266);
- per-ray light index in {0,1,2}, from a stream of its own under a
  non-zero `light_prng_salt` (`draw_uniforms`);
- an optional `ray_transform` (o, d) → (o, d) maps the rays into the
  canonical frame before the march (the dynamic scene's rigid delta,
  testbed_nerf.cu:1311-1323);
- ray march with jittered start (ops/ray_march.py).

The random numbers come from an explicit `torch.Generator`, or are handed
in as `RayUniforms` (the tests feed both packages the same numbers; JAX's
key splits cannot be reproduced in torch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MarchConfig
from ..geom.camera import rays_from_pixels
from ..io.dataset import TrainingDataset
from ..ops import ray_march
from ..render.losses import RayBatch


class RayUniforms(NamedTuple):
    xy: torch.Tensor          # (R, 2) in [0, 1): (x, y)
    skip: torch.Tensor        # (R,) in [0, 1)
    start: torch.Tensor       # (R,) in [0, 1)
    light_idx: torch.Tensor   # (R,) int in {0, 1, 2}
    # (R,) in [0, 1): the image draw of error-map proportional sampling,
    # which reads xy as its (u_x, u_y); None on the default path
    img: torch.Tensor | None = None


def draw_uniforms(n_rays: int, generator: torch.Generator | None,
                  device, proportional: bool = False,
                  light_generator: torch.Generator | None = None
                  ) -> RayUniforms:
    """The step's random numbers; `proportional` adds the image draw of
    error-map sampling after the others. With `light_generator` (a
    non-zero `light_prng_salt`) the light index comes from it; `generator`
    draws its own all the same, so that every other draw is unchanged."""
    draw = lambda *shape: torch.rand(shape, generator=generator,
                                     device=device)
    xy, skip, start = draw(n_rays, 2), draw(n_rays), draw(n_rays)
    light = torch.randint(0, 3, (n_rays,), generator=generator,
                          device=device)
    if light_generator is not None:
        light = torch.randint(0, 3, (n_rays,), generator=light_generator,
                              device=device)
    return RayUniforms(xy=xy, skip=skip, start=start, light_idx=light,
                       img=draw(n_rays) if proportional else None)


def sample_ray_batch(dataset: TrainingDataset, bitfield: torch.Tensor,
                     n_rays: int, n_slots: int, march_cfg: MarchConfig,
                     generator: torch.Generator | None = None,
                     uniforms: RayUniforms | None = None,
                     emap_state=None, emap_image_prop: bool = False,
                     emap_focal_prop: bool = False, ray_transform=None):
    """Returns (RayBatch, FlatSamples, positions (S, 3), (img, xy)).

    With `emap_state` and one of the emap_*_prop knobs, images and pixels
    come from the error map's CDFs (`error_map.sample` on the uniforms'
    `img` and `xy`)."""
    W, H = dataset.resolution
    n_img = dataset.n_images
    dev = dataset.device
    proportional = emap_state is not None and (emap_image_prop
                                               or emap_focal_prop)
    u = uniforms if uniforms is not None else draw_uniforms(
        n_rays, generator, dev, proportional)

    if proportional:
        from . import error_map
        img, xy, pdf = error_map.sample(
            emap_state, n_rays, u.img, u.xy[:, 1].contiguous(),
            u.xy[:, 0].contiguous(),
            emap_image_prop, emap_focal_prop)
    else:
        img = (torch.arange(n_rays, device=dev) * n_img) // n_rays
        xy = u.xy
        pdf = torch.ones(n_rays, device=dev)
    px = torch.clamp((xy[:, 0] * W).to(torch.int64), 0, W - 1)
    py = torch.clamp((xy[:, 1] * H).to(torch.int64), 0, H - 1)
    if march_cfg.snap_to_pixel_centers:
        xy = torch.stack([(px + 0.5) / W, (py + 0.5) / H], dim=1) \
            .to(torch.float32)

    flat = (img * H + py) * W + px
    gather = lambda a: a.reshape((-1,) + tuple(a.shape[3:]))[flat]
    normal_gt = gather(dataset.normals)
    albedo_gt = gather(dataset.albedos)
    alpha_n = gather(dataset.alpha_normal)
    alpha_a = gather(dataset.alpha_albedo)
    skip_cand = gather(dataset.skip_candidate)
    alive = ~(skip_cand & (u.skip >= 0.9))

    ray_o, ray_d = rays_from_pixels(dataset.cameras, img, xy)
    if ray_transform is not None:
        ray_o, ray_d = ray_transform(ray_o, ray_d)
    samples = ray_march.march_flat(ray_o, ray_d, bitfield, u.start,
                                   march_cfg.n_ladder, n_slots,
                                   march_cfg.cone_angle)
    alive &= samples.n_valid > 0

    # one (R, 8) gather hands every per-sample consumer its ray attributes
    full_alive = alive & samples.ray_kept
    attrs = torch.cat([ray_d, full_alive[:, None].to(torch.float32), ray_o,
                       ray_d.new_zeros(n_rays, 1)], dim=1)     # (R, 8)
    rid = torch.clamp_max(samples.ray_id, n_rays - 1)
    s_attr = attrs[rid]                                        # (S, 8)
    pos = s_attr[:, 4:7] + samples.t[:, None] * s_attr[:, 0:3]
    pos = torch.clamp(pos, 0.0, 1.0)

    batch = RayBatch(
        ray_o=ray_o, ray_d=ray_d,
        alive=alive,
        normal_gt=normal_gt, albedo_gt=albedo_gt,
        mask_color=(alpha_a > 0.99).to(torch.float32),
        mask_gt=(alpha_n > 0.99).to(torch.float32),
        rot_c2w=dataset.cameras.rot_c2w[img],
        light_idx=u.light_idx,
        pdf=pdf,
        sample_attrs=s_attr,
    )
    return batch, samples, pos, (img, xy)


def sample_positions(ray_o: torch.Tensor, ray_d: torch.Tensor,
                     samples) -> torch.Tensor:
    """(S, 3) positions o[rid] + t·d[rid] clipped to [0, 1], differentiable
    wrt the rays (trainable rays: the rigid delta, camera refinement).
    The clip is min(max(·, 0), 1), whose gradient at an exact boundary is
    0.5, as `jnp.clip`'s; `torch.clamp` gives 1 there. The gathers are
    index_selects: their backward is an index_add, where that of
    `ray_o[rid]` serializes on the padded slots' one row."""
    rid = torch.clamp_max(samples.ray_id, ray_o.shape[0] - 1)
    p = ray_o.index_select(0, rid) \
        + samples.t[:, None] * ray_d.index_select(0, rid)
    return torch.minimum(torch.maximum(p, p.new_zeros(())), p.new_ones(()))
