"""Snapshot save and load: the full training state as msgpack (port of
`rnb_neus2_tpu/train/snapshot.py`).

The file is the JAX package's, key for key (reference: the msgpack
snapshot of src/testbed.cu:3280-3402): the network config, the master
and EMA parameters as the JAX field tree, the optax chain's state, the
density grid stored as float16 (:3300), the adaptive rays-per-batch
counter, the step, the random key and the divergence guard's meters. Maps
are written with sorted keys, as flax writes them, through the port's own
codec (`utils/msgpack_codec.py`; the card's host has no `msgpack` or
`flax`). Either package restores the other's file.

Random state. `rng_key` stays a uint32[2], so that JAX's `restore_trainer`
takes the file: the port writes two words hashed from its generator's
state. The generator's own state goes under an extra key,
`torch_rng_state`, which JAX does not read. A file without it (one that
JAX wrote), or one whose generator state is for another device, seeds the
port's generator with the 64-bit value (word 0 << 32) | word 1 of
`rng_key`: a resumed run draws a stream of its own, not JAX's. Under a
non-zero `light_prng_salt` the light index's generator goes under
`torch_light_rng_state`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import NERF_MIN_OPTICAL_THICKNESS
from .. import interop
from ..utils import msgpack_codec

SNAPSHOT_VERSION = 1

log = logging.getLogger("rnb_neus2_torch.train")


def _config_to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def _nan_or(value: Optional[float]) -> np.float32:
    return np.float32(np.nan if value is None else value)


def _rng_key(state: torch.Tensor) -> np.ndarray:
    """Two uint32 words hashed from the generator's state bytes."""
    digest = hashlib.blake2b(state.numpy().tobytes(), digest_size=8).digest()
    return np.frombuffer(digest, np.uint32).copy()


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _sorted(tree):
    """Every map with its keys sorted, as flax's `msgpack_serialize`
    writes them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def snapshot_payload(trainer) -> Dict[str, Any]:
    """The payload with the tensors left on their device (no host sync).
    `save_snapshot` materializes it inline; `AsyncSnapshotWriter` clones
    it on the device first and materializes it on a thread."""
    keep = lambda t: t
    chain, ema = interop.opt_state_to_jax(trainer.opt, keep)
    rng = trainer.generator.get_state()
    return {
        "version": np.int32(SNAPSHOT_VERSION),
        "step": np.int32(trainer.step),
        "n_rays": np.int32(trainer.n_rays),
        "config_json": _config_to_json(trainer.cfg),
        "params": interop.state_dict(interop.params_to_jax(trainer.params,
                                                           keep)),
        "ema_params": interop.state_dict(ema),
        "adam_state": chain,
        "density_grid": trainer.occ.density,
        "density_ema_step": np.asarray(trainer.occ.ema_step, np.int32),
        "rng_key": _rng_key(rng),
        "torch_rng_state": rng.numpy(),
        **({} if trainer.light_generator is None else {
            "torch_light_rng_state":
                trainer.light_generator.get_state().numpy()}),
        # the divergence guard's meters and floors, so that a resumed run
        # has a warm reference at once (the JAX package's snapshot.py
        # gives the runs that motivated each)
        "loss_ema": np.float32(trainer.loss_ema.value
                               if trainer.loss_ema._initialized else np.nan),
        "loss_ema_updates": np.int32(trainer.loss_ema.updates),
        "guard_degraded": np.bool_(trainer._guard_degraded_at is not None
                                   and not trainer.cfg.flags.apply_rgbplus),
        "guard_rearms_used": np.int32(trainer._guard_rearms_used),
        "ek_ema": np.float32(trainer.ek_ema.value
                             if trainer.ek_ema._initialized else np.nan),
        "ek_ema_updates": np.int32(trainer.ek_ema.updates),
        "guard_ek_floor": _nan_or(trainer._guard_ek_floor),
        "guard_ema_floor": _nan_or(trainer._guard_ema_floor),
    }


def _materialize(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Every tensor pulled to host numpy (waits for the device), the
    density grid as float16 (testbed.cu:3300), the keys sorted."""
    out = _map_tensors(payload, lambda t: t.detach().cpu().numpy())
    out["density_grid"] = out["density_grid"].astype(np.float16)
    return _sorted(out)


def save_snapshot(path: str, trainer) -> int:
    """Write the trainer's snapshot to `path`; returns its size in bytes."""
    blob = msgpack_codec.packb(_materialize(snapshot_payload(trainer)))
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


class AsyncSnapshotWriter:
    """Rolling snapshots off the training loop's path.

    `submit` clones the state on the device (queued on the stream, no host
    sync; the next step updates the live tensors in place) and hands the
    clones to a daemon thread, which pulls them, serializes them and
    rotates latest.tmp → latest → latest.prev, so that a failed write
    never costs the newest good generation. At most one write is in
    flight: a submit while one is running is skipped, and the next cadence
    boundary tries again."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def submit(self, latest_path: str, trainer, logger=None) -> bool:
        if self.busy():
            if logger:
                logger.info("rolling snapshot writer busy — skipping this "
                            "generation")
            return False
        payload = _map_tensors(snapshot_payload(trainer),
                               lambda t: t.detach().clone())
        self._thread = threading.Thread(
            target=self._write, args=(latest_path, payload, logger),
            daemon=True)
        self._thread.start()
        return True

    @staticmethod
    def _write(latest: str, payload: Dict[str, Any], logger=None) -> None:
        try:
            blob = msgpack_codec.packb(_materialize(payload))
            with open(latest + ".tmp", "wb") as f:
                f.write(blob)
            if os.path.exists(latest):
                os.replace(latest, latest + ".prev")
            os.replace(latest + ".tmp", latest)
        except Exception as e:      # the training loop must go on
            log.exception("async rolling snapshot failed")
            if logger:
                logger.error(f"async rolling snapshot failed: {e}")


def load_snapshot(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_codec.unpackb(f.read())


def _seed_from_key(generator: torch.Generator, key) -> None:
    k0, k1 = (int(w) for w in np.asarray(key, np.uint32))
    generator.manual_seed((k0 << 32) | k1)


@torch.no_grad()
def restore_trainer(trainer, snap: Dict[str, Any]) -> None:
    """In-place restore onto a freshly built Trainer of the same config
    (the caller builds it from this run's flags)."""
    dev = trainer.device
    params = interop.params_from_jax(snap["params"], dev)
    opt = interop.opt_state_from_jax(snap["adam_state"], snap["ema_params"],
                                     dev)
    if set(params) != set(trainer.params):
        raise ValueError(f"snapshot parameters {sorted(params)} do not "
                         f"match the trainer's {sorted(trainer.params)}")
    for k, p in trainer.params.items():
        if params[k].shape != p.shape:
            raise ValueError(f"snapshot parameter {k} has shape "
                             f"{tuple(params[k].shape)}, the trainer's "
                             f"{tuple(p.shape)}")
        p.copy_(params[k])
    # a data-parallel trainer copies them on to its other replicas
    broadcast = getattr(trainer, "broadcast_params", None)
    if broadcast is not None:
        broadcast()
    for name in ("mu", "nu", "ema") + (("steps",) if trainer.opt.sparse
                                       else ()):
        getattr(trainer.opt, name).update(opt[name])
    trainer.opt.count = opt["count"]
    trainer.step = int(snap["step"])
    trainer.n_rays = int(snap["n_rays"])

    # the float16 grid, and the bitfield rebuilt from it against
    # min(0.1, mean), as the JAX package's restore does
    density = torch.as_tensor(
        np.asarray(snap["density_grid"]).astype(np.float32), device=dev)
    if density.shape != trainer.occ.density.shape:
        raise ValueError(f"snapshot density grid has {density.numel()} "
                         f"cells, the trainer's "
                         f"{trainer.occ.density.numel()}")
    mean = torch.clamp_min(density, 0.0).mean()
    trainer.occ = trainer.occ._replace(
        density=density,
        bitfield=density > torch.clamp_max(mean, NERF_MIN_OPTICAL_THICKNESS),
        mean_density=mean, ema_step=int(snap["density_ema_step"]))

    state = snap.get("torch_rng_state")
    live = trainer.generator.get_state()
    if state is not None and np.asarray(state).size == live.numel():
        trainer.generator.set_state(torch.from_numpy(
            np.array(state, np.uint8)))
    else:
        _seed_from_key(trainer.generator, snap["rng_key"])
    light = snap.get("torch_light_rng_state")
    if light is not None and trainer.light_generator is not None:
        trainer.light_generator.set_state(torch.from_numpy(
            np.array(light, np.uint8)))

    ema_val = float(snap.get("loss_ema", np.nan))
    if math.isfinite(ema_val):
        trainer.loss_ema.set(ema_val, updates=int(snap.get(
            "loss_ema_updates", int(trainer.loss_ema.half_life))))
    ek_val = float(snap.get("ek_ema", np.nan))
    if math.isfinite(ek_val):
        trainer.ek_ema.set(ek_val, updates=int(snap.get(
            "ek_ema_updates", int(trainer.ek_ema.half_life))))
    ek_floor = float(snap.get("guard_ek_floor", np.nan))
    if math.isfinite(ek_floor):
        trainer._guard_ek_floor = ek_floor
    ema_floor = float(snap.get("guard_ema_floor", np.nan))
    if math.isfinite(ema_floor):
        trainer._guard_ema_floor = ema_floor
    # a run saved in degraded mode comes back degraded, with its re-arm
    # budget
    if bool(snap.get("guard_degraded", False)) \
            and trainer.cfg.flags.apply_rgbplus:
        trainer._set_rgbplus(False)
        trainer._guard_degraded_at = trainer.step
        trainer._guard_rearms_used = int(snap.get("guard_rearms_used", 0))
    # the restored state is the guard's first healthy checkpoint
    trainer.seed_guard()
