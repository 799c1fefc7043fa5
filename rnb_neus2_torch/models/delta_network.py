"""Global rigid-motion model for dynamic scenes (DeltaNetwork; port of
`rnb_neus2_tpu/models/delta_network.py`).

Reference: include/neural-graphics-primitives/transform_network.h (6D
rotation representation) + src/rotation.cu (`rotation_6d_to_matrix`
Gram-Schmidt, :16-40). A frame's rigid transform maps its rays into the
canonical frame (global_movement_with_rotation_6d,
testbed_nerf.cu:162-230); the inverse maps the canonical mesh back
(transform_mesh_with_6d, testbed_nerf.cu:4316-4326).

The delta is a dict {"rotation6d": (6,), "translation": (3,)} of float32
tensors; every function is differentiable wrt it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..device import resolve_device


def init_delta_params(device=None) -> Dict[str, torch.Tensor]:
    """The identity on `device` (cuda unless asked)."""
    dev = resolve_device(device)
    return {"rotation6d": torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                                       device=dev),
            "translation": torch.zeros(3, device=dev)}


def rotation_6d_to_matrix(r6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt: first two (unnormalized) rotation-matrix columns →
    orthonormal frame (rotation.cu:16-40), the norms floored at 1e-12."""
    a1, a2 = r6[:3], r6[3:6]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1), 1e-12)
    a2p = a2 - torch.dot(b1, a2) * b1
    b2 = a2p / torch.clamp_min(torch.linalg.norm(a2p), 1e-12)
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=1)


def apply_rigid(delta: Dict[str, torch.Tensor], origins: torch.Tensor,
                dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays into the canonical frame (global_movement_with_rotation_6d)."""
    R = rotation_6d_to_matrix(delta["rotation6d"])
    return origins @ R.T + delta["translation"], dirs @ R.T


def apply_rigid_points(delta: Dict[str, torch.Tensor],
                       pts: torch.Tensor) -> torch.Tensor:
    R = rotation_6d_to_matrix(delta["rotation6d"])
    return pts @ R.T + delta["translation"]


def compose(acc: Dict[str, torch.Tensor],
            delta: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Accumulate frame movements: x ↦ R_d(R_a x + t_a) + t_d
    (nerf_network.h:973-1081 accumulation buffers)."""
    Ra = rotation_6d_to_matrix(acc["rotation6d"])
    Rd = rotation_6d_to_matrix(delta["rotation6d"])
    R = Rd @ Ra
    return {"rotation6d": torch.cat([R[:, 0], R[:, 1]]),
            "translation": Rd @ acc["translation"] + delta["translation"]}


def inverse_transform_points(delta: Dict[str, torch.Tensor],
                             pts: torch.Tensor) -> torch.Tensor:
    """Canonical → world (mesh vertices after training,
    transform_mesh_with_6d)."""
    R = rotation_6d_to_matrix(delta["rotation6d"])
    return (pts - delta["translation"]) @ R
