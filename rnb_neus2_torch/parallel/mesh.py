"""The devices of data-parallel training (port of
`rnb_neus2_tpu/parallel/mesh.py`).

The model (~12 M parameters, most of them the hash table) is replicated;
each replica marches and shades its own slice of the ray batch against its
slice of the sample budget, and the gradient is one sum over the replicas.
The loss keeps the single-device semantics exactly:

    global = Σ_replica [(color + mask)_replica] / R_global
             + ek_w · Σ_replica ek_replica / S_target

so each replica normalizes its partial loss by the global ray count and
the global sample target (`training_loss`'s `n_rays_divisor` and
`ek_samples_divisor`), and the sum of the replicas' gradients is the
gradient one device would compute on the whole batch. The occupancy
refresh splits its cells over the replicas the same way.

The JAX package builds a `Mesh` for `shard_map`; here the "mesh" is the
ordered list of devices that hold the replicas, driven from one process
(`parallel.trainer.ParallelTrainer`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device import resolve_device


def make_mesh(devices: Optional[Sequence] = None,
              n_chips: Optional[int] = None) -> List[torch.device]:
    """The replicas' devices, in replica order: `devices` as given (a
    device may repeat: two replicas on one card), else every CUDA device;
    the first `n_chips` of them when `n_chips` is set."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[...] (e.g. ['cpu', 'cpu']) "
                "to run the replicas elsewhere")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if n_chips:
        devices = list(devices)[:n_chips]
    return [resolve_device(d) for d in devices]
