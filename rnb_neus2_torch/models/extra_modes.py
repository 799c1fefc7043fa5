"""The inherited instant-ngp testbed workloads: image, mesh-SDF and volume
fitting (port of `rnb_neus2_tpu/models/extra_modes.py`; the reference's
src/testbed_image.cu, testbed_sdf.cu and testbed_volume.cu, picked by
ETestbedMode).

- `ImageField`: a 2-D multiresolution hash grid (`Hash2D`) and an MLP
  fitted to an RGB(A) image (train_image, testbed_image.cu:220);
- `SdfField`: NeusField's SDF branch ("hash") or the Takikawa octree
  encoding and a small MLP ("takikawa") fitted to the mesh's signed
  distances (closest point and ray-stab sign from `io/raycast.py`), with
  the volumetric IoU;
- `VolumeField`: a density fitted to a dense voxel grid.

Every table gradient goes through the port's two scatter kernels: the
3-D hash grids through `hash_encoding.encode` (`hash_grad_small` for the
dense small levels, `scatter_add` for the rest), the 2-D grid's 4 corners
and the octree's 8 through `ops/gather.py` (`scatter_add`). The MLPs are
plain PyTorch. Each `fit` is optax's `adam(lr, b1=0.9, b2=0.99,
eps=1e-15)` (`train/optimizer.Adam`) over a flat parameter dict, as in
the JAX package. Parameters are a dict name → tensor; an MLP's matrices
are "mlp.0", "mlp.1", ….

Batches: `ImageField` and `VolumeField` draw their points from a
`torch.Generator` seeded with seed + 1 (the JAX package splits
PRNGKey(seed + 1) per step); `fit(..., draws=f)` takes f(step) → the
step's (batch, 2) or (batch, 3) uniforms instead, which the tests use to
inject the JAX package's draws. `SdfField` samples on the host with numpy
exactly as the JAX package does (`sample_points`, replaceable the same
way).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config import HashGridConfig, NetworkConfig
from ..device import resolve_device
from ..ops import hash_encoding, takikawa
from ..ops.gather import gather_rows
from ..ops.mlp import apply_mlp, init_mlp, xavier_uniform
from ..train.optimizer import Adam

_PRIMES_2D = (1, 2654435761)
_U32 = 0xFFFFFFFF

Params = Dict[str, torch.Tensor]


def _mlp(params: Params) -> List[torch.Tensor]:
    n = sum(1 for k in params if k.startswith("mlp."))
    return [params[f"mlp.{i}"] for i in range(n)]


def _adam(lr: float, params: Params) -> Adam:
    return Adam(params, lr, b1=0.9, b2=0.99, eps=1e-15)


def _step(opt: Adam, params: Params, loss_fn: Callable[[Params],
                                                       torch.Tensor]):
    """One optax-order Adam step of `loss_fn` → (new params, loss)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return opt.step(params, dict(zip(leaves, grads))), loss.detach()


class Hash2D:
    """The 2-D multiresolution hash encoding of image fitting."""

    def __init__(self, n_levels=8, f=2, log2_size=16, base=16, top=1024):
        self.n_levels, self.f = n_levels, f
        s = math.exp(math.log(top / base) / max(n_levels - 1, 1))
        self.scales, self.sizes, self.offsets, self.hashed = [], [], [], []
        off = 0
        for lvl in range(n_levels):
            scale = base * s ** lvl - 1.0
            res = int(np.ceil(scale)) + 1
            dense = -(-res * res // 8) * 8
            size = min(dense, 1 << log2_size)
            self.scales.append(float(res - 1))
            self.sizes.append(size)
            self.offsets.append(off)
            self.hashed.append(res * res > size)
            off += size
        self.n_entries = off

    def init_table(self, generator: torch.Generator | None = None,
                   device="cpu") -> torch.Tensor:
        u = torch.rand((self.n_entries, self.f), generator=generator,
                       device=device)
        return u * 2e-4 - 1e-4

    def encode(self, table: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
        """(N, 2) in [0, 1] → (N, n_levels·f): per level the bilinear blend
        of the 4 corner rows, whose table gradient is one `scatter_add`
        launch (`gather_rows`)."""
        corners = torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]],
                               device=xy.device)
        on = corners[None] > 0
        outs = []
        for lvl in range(self.n_levels):
            p = xy * np.float32(self.scales[lvl]) + 0.5
            p0 = torch.floor(p)
            frac = p - p0
            cpos = p0.to(torch.int64)[:, None, :] + corners[None]
            if self.hashed[lvl]:
                h = cpos[..., 0] ^ ((cpos[..., 1] * _PRIMES_2D[1]) & _U32)
                idx = h % self.sizes[lvl]
            else:
                res = int(self.scales[lvl]) + 1
                idx = (cpos[..., 0] + cpos[..., 1] * res) % self.sizes[lvl]
            feats = gather_rows(table, idx + self.offsets[lvl])    # (N,4,f)
            w = torch.prod(torch.where(on, frac[:, None, :],
                                       1.0 - frac[:, None, :]), dim=-1)
            outs.append(torch.sum(feats * w[..., None], dim=1))
        return torch.cat(outs, dim=1)


class ImageField:
    """2-D image fitting (testbed_image.cu train_image)."""

    def __init__(self, n_channels=3, width=64, device=None):
        self.enc = Hash2D()
        self.n_channels = n_channels
        self.width = width
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> Params:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dims = [self.enc.n_levels * self.enc.f, self.width, self.width,
                self.n_channels]
        params = {"table": self.enc.init_table(gen, self.device)}
        for i, w in enumerate(init_mlp(dims, gen, self.device)):
            params[f"mlp.{i}"] = w
        return params

    def apply(self, params: Params, xy: torch.Tensor) -> torch.Tensor:
        return apply_mlp(_mlp(params), self.enc.encode(params["table"], xy))

    def fit(self, image: np.ndarray, n_steps=500, batch=1 << 14, lr=1e-2,
            seed=0, params: Optional[Params] = None, state=None,
            return_state=False, draws: Optional[Callable] = None):
        H, W, _ = image.shape
        dev = self.device
        img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
        if params is None:
            params = self.init(seed)
        opt = state if state is not None else _adam(lr, params)
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            draws = lambda _: torch.rand((batch, 2), generator=gen,
                                         device=dev)
        loss = torch.zeros((), device=dev)
        for i in range(n_steps):
            xy = draws(i)
            px = torch.clamp((xy[:, 0] * W).to(torch.int64), 0, W - 1)
            py = torch.clamp((xy[:, 1] * H).to(torch.int64), 0, H - 1)
            target = img[py, px]
            params, loss = _step(opt, params, lambda p: torch.mean(
                (self.apply(p, xy) - target) ** 2))
        if return_state:
            return params, opt, float(loss)
        return params, float(loss)

    @torch.no_grad()
    def render(self, params: Params, W: int, H: int) -> np.ndarray:
        ys, xs = np.mgrid[0:H, 0:W]
        xy = torch.as_tensor(np.stack([(xs.ravel() + 0.5) / W,
                                       (ys.ravel() + 0.5) / H], 1),
                             dtype=torch.float32, device=self.device)
        return self.apply(params, xy).cpu().numpy().reshape(H, W, -1)


class _SdfOf(nn.Module):
    """A NeusField whose forward is its SDF, for `functional_call`."""

    def __init__(self, field):
        super().__init__()
        self.field = field

    def forward(self, x):
        return self.field.sdf(x)


class SdfField:
    """Mesh-SDF fitting (testbed_sdf.cu): ground-truth distances from the
    native BVH (closest point, parity sign), surface-biased samples, IoU.

    encoding: "hash" (the NeusField hash grid and SDF MLP, default) or
    "takikawa" (the octree feature encoding of `ops/takikawa.py` and a
    64-wide MLP, the reference's Takikawa otype)."""

    def __init__(self, grid: HashGridConfig | None = None,
                 net: NetworkConfig | None = None, encoding: str = "hash",
                 octree_depth: int = 7, octree_starting_level: int = 3,
                 device=None):
        if encoding not in ("hash", "takikawa"):
            raise ValueError(f"encoding {encoding!r}: 'hash' or 'takikawa'")
        self.encoding = encoding
        self.grid = grid or HashGridConfig(n_levels=8, top_resolution=256)
        self.net = net or NetworkConfig()
        self.device = resolve_device(device)
        self.octree_depth = octree_depth
        self.octree_starting_level = octree_starting_level
        self.octree = None
        self.caster = None
        self.params: Optional[Params] = None
        self._sdf_module = None

    def init(self, vertices=None, faces=None, seed: int = 0) -> Params:
        """Fresh parameters: the NeusField's (hash) or, for "takikawa",
        the octree over (vertices, faces), its vertex table and the MLP."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.encoding == "takikawa":
            self.octree = takikawa.build_triangle_octree(
                vertices, faces, self.octree_depth,
                self.octree_starting_level)
            n_in = self.octree.n_output_dims
            return {"table": takikawa.init_takikawa_params(
                        self.octree, generator=gen, device=self.device),
                    "mlp.0": xavier_uniform(64, n_in, gen, self.device),
                    "mlp.1": xavier_uniform(64, 64, gen, self.device),
                    "mlp.2": xavier_uniform(1, 64, gen, self.device)}
        from .neus_field import NeusField
        field = NeusField(self.grid, self.net, self.device, gen)
        self._sdf_module = _SdfOf(field)
        return {k: p.detach() for k, p in field.named_parameters()}

    def _sdf(self, params: Params, pts: torch.Tensor) -> torch.Tensor:
        if self.encoding == "takikawa":
            enc = takikawa.encode(params["table"], pts, self.octree)
            return apply_mlp(_mlp(params), enc)[:, 0]
        if self._sdf_module is None:
            from .neus_field import NeusField
            self._sdf_module = _SdfOf(NeusField(self.grid, self.net,
                                                self.device))
        return torch.func.functional_call(
            self._sdf_module, {f"field.{k}": v for k, v in params.items()},
            (pts,))

    def sample_points(self, rng: np.random.Generator, tri: np.ndarray,
                      n: int, surface_frac: float) -> np.ndarray:
        """The JAX package's batch: surface points (random barycentric, a
        N(0, 0.02) offset) and uniform points, clipped to [0, 1]."""
        ns = int(n * surface_frac)
        fi = rng.integers(0, len(tri), ns)
        u = rng.random((ns, 2))
        flip = u.sum(1) > 1
        u[flip] = 1 - u[flip]
        p = (tri[fi, 0] + u[:, :1] * (tri[fi, 1] - tri[fi, 0])
             + u[:, 1:] * (tri[fi, 2] - tri[fi, 0]))
        p = p + rng.normal(scale=0.02, size=p.shape)
        q = rng.random((n - ns, 3))
        return np.clip(np.concatenate([p, q], 0), 0, 1).astype(np.float32)

    def fit(self, vertices, faces, n_steps=400, batch=1 << 13, lr=1e-3,
            seed=0, surface_frac=0.5, params: Optional[Params] = None,
            state=None, return_state=False):
        from ..io.raycast import RayCaster

        if self.caster is None:
            self.caster = RayCaster(vertices, faces)
        rng = np.random.default_rng(seed)
        if params is None:
            params = self.init(vertices, faces, seed)
        opt = state if state is not None else _adam(lr, params)
        tri = np.asarray(vertices)[np.asarray(faces)]
        dev = self.device
        loss = torch.zeros((), device=dev)
        for _ in range(n_steps):
            pts = self.sample_points(rng, tri, batch, surface_frac)
            target = torch.as_tensor(self.caster.signed_distance(pts),
                                     device=dev)
            x = torch.as_tensor(pts, device=dev)
            params, loss = _step(opt, params, lambda p: torch.mean(
                (self._sdf(p, x) - target) ** 2))
        self.params = params
        if return_state:
            return params, opt, float(loss)
        return params, float(loss)

    def render(self, params: Optional[Params] = None, W=256, H=256,
               mode="shade", **kw) -> np.ndarray:
        """A sphere-traced frame (testbed_sdf.cu render_sdf +
        shade_kernel_sdf) → (H, W, 4) float RGBA."""
        from ..render.sdf_volume_render import render_sdf

        p = {k: v.detach() for k, v in
             (self.params if params is None else params).items()}
        rgba, _ = render_sdf(lambda x: self._sdf(p, x), W, H, mode=mode,
                             device=self.device, **kw)
        return rgba.cpu().numpy()

    @torch.no_grad()
    def calculate_iou(self, n_samples=1 << 15, seed=0) -> float:
        """Volumetric IoU against the mesh (Testbed::calculate_iou)."""
        rng = np.random.default_rng(seed)
        pts = rng.random((n_samples, 3)).astype(np.float32)
        x = torch.as_tensor(pts, device=self.device)
        pred = (self._sdf(self.params, x) < 0).cpu().numpy()
        gt = self.caster.signed_distance(pts) < 0
        return float((pred & gt).sum()) / max(float((pred | gt).sum()), 1.0)


class VolumeField:
    """Dense-volume density fitting (testbed_volume.cu train_volume)."""

    def __init__(self, grid: HashGridConfig | None = None, width=64,
                 device=None):
        self.grid = grid or HashGridConfig(n_levels=8, top_resolution=256)
        self.static = hash_encoding.HashGridStatic(self.grid)
        self.width = width
        self.device = resolve_device(device)
        self.params: Optional[Params] = None

    def init(self, seed: int = 0) -> Params:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = {"table": hash_encoding.init_table(self.grid, gen,
                                                    self.device)}
        dims = [self.grid.output_dim, self.width, self.width, 1]
        for i, w in enumerate(init_mlp(dims, gen, self.device)):
            params[f"mlp.{i}"] = w
        return params

    def apply(self, params: Params, pts: torch.Tensor) -> torch.Tensor:
        enc = hash_encoding.encode(params["table"], pts, self.static)
        # exponential density activation (testbed_volume.cu)
        return torch.exp(torch.clamp(apply_mlp(_mlp(params), enc)[:, 0],
                                     -10.0, 10.0))

    def fit(self, volume: np.ndarray, n_steps=400, batch=1 << 13, lr=1e-2,
            seed=0, params: Optional[Params] = None, state=None,
            return_state=False, draws: Optional[Callable] = None):
        dev = self.device
        vol = torch.as_tensor(np.asarray(volume, np.float32), device=dev)
        X, Y, Z = volume.shape
        dims = torch.tensor([X, Y, Z], device=dev)
        if params is None:
            params = self.init(seed)
        opt = state if state is not None else _adam(lr, params)
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            draws = lambda _: torch.rand((batch, 3), generator=gen,
                                         device=dev)
        loss = torch.zeros((), device=dev)
        for i in range(n_steps):
            pts = draws(i)
            ijk = torch.minimum((pts * dims).to(torch.int64), dims - 1)
            target = vol[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
            params, loss = _step(opt, params, lambda p: torch.mean(
                (self.apply(p, pts) - target) ** 2))
        self.params = params
        if return_state:
            return params, opt, float(loss)
        return params, float(loss)

    def render(self, params: Optional[Params] = None, W=256, H=256, **kw
               ) -> np.ndarray:
        """A ratio-tracked frame of the fitted density against the
        procedural sun/sky (volume_render_kernel_step, testbed_volume.cu:
        330-392) → (H, W, 4) float RGBA."""
        from ..render.sdf_volume_render import render_volume

        p = self.params if params is None else params
        rgba = render_volume(lambda x: self.apply(p, x), W, H,
                             device=self.device, **kw)
        return rgba.cpu().numpy()
