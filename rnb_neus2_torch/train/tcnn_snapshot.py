"""CUDA-testbed snapshot interop: read/write the reference's msgpack layout
(port of `rnb_neus2_tpu/train/tcnn_snapshot.py`).

The reference saves `output/snapshot_<it>.msgpack` as nlohmann-JSON→msgpack
(src/testbed.cu:3280-3314): the network config dict plus a "snapshot" dict

  snapshot.n_params                int
  snapshot.params_binary           bin: fp16 little-endian inference params
  snapshot.density_grid_size       128 (NERF_GRIDSIZE)
  snapshot.density_grid_binary     bin: fp16 density grid
  snapshot.training_step, .loss
  snapshot.nerf.aabb_scale / .rgb.{rays_per_batch, measured_batch_size,...}
  snapshot.nerf.dataset            dataset metadata (json_binding.h)

params_binary layout = NerfNetwork::set_params order (nerf_network.h:540-581):
  density_network | rgb_network | pos_encoding | dir_encoding(0) | variance
with each FullyFusedMLP serialized as its weight matrices in construction
order — input layer (width, input_width_padded), hidden layers
(width, width), output (padded_output_width, width) — each ROW-MAJOR
(fully_fused_mlp.cu:783-817, GPUMatrix<T, RM>), and the hash table as
(n_entries, F) feature-minor rows (grid.h param indexing
`index*N_FEATURES_PER_LEVEL + f`).

Padded-input columns map to our split first-layer blocks:
  SDF  input = [xyz(0:3) | hash(3:3+LF) | zero pad] with width
       next_multiple(3+LF, 16) — 32 for the default L14·F2 config
       (nerf_network.h:47, minimum_alignment=16)
  RGB  input 48 = [sdf feats(0:16) | dir slot(16:32, dead `if (false)`
                   nerf_network.h:193-203) | xyz(32:35) | ∇sdf(35:38) | pad]

This module lets a user move a trained field between the CUDA testbed and
this port: `import_cuda_snapshot` loads a file into a `Trainer`;
`export_cuda_snapshot` writes a file the CUDA testbed's load_snapshot param
layout understands. The file is a plain msgpack map (str keys, bin
payloads, no flax ext types), written and read by `utils/msgpack_codec.py`:
its bytes equal the JAX package's export of the same state.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict

import numpy as np
import torch

from .. import interop
from ..config import NERF_MIN_OPTICAL_THICKNESS, TestbedConfig
from ..utils import msgpack_codec


@dataclasses.dataclass
class MlpShapes:
    sdf_in: int          # padded SDF-MLP input width (32 at the default)
    width: int           # 64
    sdf_out: int         # 16
    rgb_in: int          # 48
    rgb_hidden: int      # 2 hidden layers
    rgb_out: int         # 16
    n_feat: int          # hash features total (L·F = 28)
    n_entries: int       # hash table rows
    f_per_level: int     # 2

    @classmethod
    def from_config(cls, cfg: TestbedConfig) -> "MlpShapes":
        n_feat = cfg.grid.output_dim
        sdf_in = -(-(3 + n_feat) // 16) * 16        # nerf_network.h:47
        return cls(sdf_in=sdf_in, width=cfg.network.sdf_width,
                   sdf_out=cfg.network.n_output_dims, rgb_in=48,
                   rgb_hidden=cfg.network.rgb_hidden_layers,
                   rgb_out=cfg.network.n_output_dims,
                   n_feat=n_feat,
                   n_entries=cfg.grid.n_table_entries,
                   f_per_level=cfg.grid.n_features_per_level)

    def n_params(self) -> int:
        # variance is a TrainableBuffer of FOUR entries (entry 0 used;
        # nerf_network.h:70 `Matrix{4}`)
        w = self.width
        sdf = w * self.sdf_in + self.sdf_out * w
        rgb = (w * self.rgb_in + (self.rgb_hidden - 1) * w * w
               + self.rgb_out * w)
        return sdf + rgb + self.n_entries * self.f_per_level + 4


def params_to_tcnn_blob(params: Dict[str, torch.Tensor],
                        shapes: MlpShapes) -> np.ndarray:
    """The port's parameters (a `NeusField` state dict) → flat fp16 vector
    in NerfNetwork order."""
    tree = interop.params_to_jax(params)
    w = shapes.width
    out = []

    # density (SDF) network: first layer packs [xyz | enc | pad]
    w_x, w_enc = tree["sdf_mlp"][0]
    first = np.zeros((w, shapes.sdf_in), np.float32)
    first[:, 0:3] = w_x
    first[:, 3:3 + shapes.n_feat] = w_enc
    out.append(first.ravel())
    for m in tree["sdf_mlp"][1:]:
        out.append(np.asarray(m, np.float32).ravel())

    # rgb network: first layer packs [feats | dir slot | xyz | grad | pad]
    w_feat, w_xyz, w_grad = tree["rgb_mlp"][0]
    nf = w_feat.shape[1]
    first = np.zeros((w, shapes.rgb_in), np.float32)
    first[:, 0:nf] = w_feat
    first[:, 2 * nf:2 * nf + 3] = w_xyz
    first[:, 2 * nf + 3:2 * nf + 6] = w_grad
    out.append(first.ravel())
    for m in tree["rgb_mlp"][1:]:
        out.append(np.asarray(m, np.float32).ravel())

    out.append(np.asarray(tree["hash_table"], np.float32).ravel())
    var4 = np.zeros(4, np.float32)                 # 4-entry buffer, [0] used
    var4[0] = float(np.asarray(tree["variance"]).ravel()[0])
    out.append(var4)
    blob = np.concatenate(out).astype(np.float16)
    if blob.size != shapes.n_params():
        raise ValueError(f"{blob.size} parameters; the network layout "
                         f"expects {shapes.n_params()}")
    return blob


def tcnn_blob_to_params(blob: np.ndarray, shapes: MlpShapes,
                        template: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Flat fp16 NerfNetwork params → the port's parameters (float32, on
    the template's device, its names and shapes)."""
    w = shapes.width
    v = np.asarray(blob, np.float32)
    pos = 0

    def take(n, shape):
        nonlocal pos
        out = v[pos:pos + n].reshape(shape)
        pos += n
        return out

    rest = lambda prefix: [template[f"{prefix}.{i}"] for i in range(
        sum(k.startswith(prefix + ".") for k in template))]
    first = take(w * shapes.sdf_in, (w, shapes.sdf_in))
    sdf_mlp = [(first[:, 0:3], first[:, 3:3 + shapes.n_feat])]
    for m in rest("sdf_rest"):
        sdf_mlp.append(take(m.numel(), tuple(m.shape)))

    first = take(w * shapes.rgb_in, (w, shapes.rgb_in))
    nf = template["rgb_w_feat"].shape[1]
    rgb_mlp = [(first[:, 0:nf], first[:, 2 * nf:2 * nf + 3],
                first[:, 2 * nf + 3:2 * nf + 6])]
    for m in rest("rgb_rest"):
        rgb_mlp.append(take(m.numel(), tuple(m.shape)))

    table = take(shapes.n_entries * shapes.f_per_level,
                 (shapes.n_entries, shapes.f_per_level))
    variance = take(4, (4,))[:1]                   # entry 0 of the 4-buffer
    return interop.params_from_jax(
        {"hash_table": table, "sdf_mlp": sdf_mlp, "rgb_mlp": rgb_mlp,
         "variance": variance}, template["variance"].device)


def _morton_to_rowmajor_perm(g: int) -> np.ndarray:
    """perm[morton_code] = row-major index (x + g·y + g²·z).

    The reference keeps the density grid in Morton (z-curve) order —
    every grid kernel indexes it via tcnn::morton3D
    (testbed_nerf.cu:452-741) and the snapshot stores those bytes
    verbatim. The port keeps the grid row-major, so snapshot interop
    permutes."""
    m = np.arange(g ** 3, dtype=np.uint64)

    def compact(v: np.ndarray) -> np.ndarray:
        """Extract every 3rd bit (morton3D_invert)."""
        out = np.zeros_like(v)
        for b in range(21):
            out |= ((v >> np.uint64(3 * b)) & np.uint64(1)) << np.uint64(b)
        return out

    x = compact(m)
    y = compact(m >> np.uint64(1))
    z = compact(m >> np.uint64(2))
    return (x + g * y + g * g * z).astype(np.int64)


_IDENTITY_6D = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.float16)  # 8-buffer
_IDENTITY_MAT = np.array([1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0],
                         np.float16)                           # 12-buffer


def export_cuda_snapshot(path: str, trainer,
                         network_config: Dict[str, Any] | None = None
                         ) -> None:
    """Write a CUDA-testbed-layout msgpack snapshot from a `Trainer`.

    Inference (EMA) params go into params_binary, like the reference's
    m_params_inference (trainer.h:286). The density grid is permuted
    row-major → Morton (see _morton_to_rowmajor_perm). Global/local
    movement blobs are written as identity (static RNb scenes never
    accumulate movement) so the testbed's unconditional
    load_global_movement/load_local_movement (testbed.cu:3386-3390)
    find their keys."""
    shapes = MlpShapes.from_config(trainer.cfg)
    blob = params_to_tcnn_blob(trainer.inference_params, shapes)
    density = trainer.occ.density.detach().cpu().numpy().astype(np.float16)
    g = int(round(len(density) ** (1 / 3)))
    perm = _morton_to_rowmajor_perm(g)
    cfg = dict(network_config or {})
    cfg["snapshot"] = {
        "n_params": int(shapes.n_params()),
        "params_binary": blob.tobytes(),
        "density_grid_size": g,
        "density_grid_binary": density[perm].tobytes(),
        "training_step": int(trainer.step),
        "loss": float(trainer.loss_ema.value or 0.0),
        # accumulated global movement: row-major 3x3 identity in a
        # 12-wide TrainableBuffer + zero transition (nerf_network.h:76-78)
        "rotation": _IDENTITY_MAT.tobytes(),
        "transition": np.zeros(4, np.float16).tobytes(),
        # delta-network (local) params: identity 6D rotation in an
        # 8-wide buffer + zero transition (transform_network.h:32-35)
        "local_rotation": _IDENTITY_6D.tobytes(),
        "local_transition": np.zeros(4, np.float16).tobytes(),
        "nerf": {
            "aabb_scale": 1,
            "rgb": {
                "rays_per_batch": int(trainer.n_rays),
                "measured_batch_size": int(
                    trainer.cfg.train.target_batch_size),
                "measured_batch_size_before_compaction": int(
                    trainer.cfg.train.target_batch_size),
            },
        },
    }
    with open(path, "wb") as f:
        f.write(msgpack_codec.packb(cfg))


@torch.no_grad()
def import_cuda_snapshot(path: str, trainer) -> Dict[str, Any]:
    """Load a CUDA-testbed msgpack snapshot into a `Trainer` in place: the
    parameters and their EMA take the file's fp16 values (the Adam state
    is kept), the density grid comes back row-major with its bitfield
    against min(0.1, mean), and the step and ray count are the file's.
    Raises ValueError when the file's parameter count does not fit the
    trainer's network config.

    Returns the decoded snapshot dict for callers that need the dataset /
    counters metadata."""
    with open(path, "rb") as f:
        cfg = msgpack_codec.unpackb(f.read())
    snap = cfg["snapshot"]
    shapes = MlpShapes.from_config(trainer.cfg)
    blob = np.frombuffer(_bin(snap["params_binary"]), np.float16)
    if blob.size != shapes.n_params():
        raise ValueError(
            f"snapshot has {blob.size} params; this config expects "
            f"{shapes.n_params()} — network configs differ")
    params = tcnn_blob_to_params(blob, shapes, trainer.params)
    for k, p in trainer.params.items():
        p.copy_(params[k])
    trainer.opt.ema = {k: p.detach().clone()
                       for k, p in trainer.params.items()}
    if "density_grid_binary" in snap:
        morton = np.frombuffer(_bin(snap["density_grid_binary"]),
                               np.float16).astype(np.float32)
        # CUDA snapshots store the grid in Morton order; the port keeps it
        # row-major (see _morton_to_rowmajor_perm)
        g = int(snap.get("density_grid_size",
                         round(len(morton) ** (1 / 3))))
        density = np.empty_like(morton)
        density[_morton_to_rowmajor_perm(g)] = morton
        density = torch.as_tensor(density, device=trainer.device)
        mean = torch.clamp_min(density, 0.0).mean()
        bit = density > torch.clamp_max(mean, NERF_MIN_OPTICAL_THICKNESS)
        trainer.occ = trainer.occ._replace(density=density, bitfield=bit,
                                           mean_density=mean)
    trainer.step = int(snap.get("training_step", 0))
    rays = snap.get("nerf", {}).get("rgb", {}).get("rays_per_batch")
    if rays:
        trainer.n_rays = int(rays)
    # accumulated global movement: a static Trainer has no movement model —
    # warn instead of silently dropping a non-identity transform (the CUDA
    # testbed would bake it into the field queries)
    if "rotation" in snap:
        rot = np.frombuffer(_bin(snap["rotation"]), np.float16)[:9]
        tra = np.frombuffer(_bin(snap.get("transition", b"\0" * 8)),
                            np.float16)[:3]
        if (np.abs(rot.astype(np.float32)
                   - _IDENTITY_MAT[:9].astype(np.float32)).max() > 1e-3
                or np.abs(tra.astype(np.float32)).max() > 1e-3):
            warnings.warn(
                "CUDA snapshot carries a non-identity accumulated global "
                "movement; this static-scene Trainer does not apply it — "
                "use FrameSequenceTrainer for dynamic sequences")
    return snap


def _bin(v) -> bytes:
    """A binary field (msgpack bin) of a file from outside."""
    if not isinstance(v, bytes):
        raise TypeError(f"unexpected binary field type {type(v)}")
    return v
