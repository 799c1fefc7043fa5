"""One rigid-delta gradient of a dynamic scene, PyTorch port against the
JAX package, both in float32 on the CPU, at full width: 8,192 rays, the
default `TestbedConfig` (14 levels, 2^19-entry tables, 2^18 sample
slots), on the same parameters and JAX's own draws.

The port's side is `FrameSequenceTrainer.delta_grad` (its sampler fed
JAX's uniforms); the JAX side is the loss of
`rnb_neus2_tpu/train/dynamic.py:_delta_step_fn` under `jax.grad`. The
field starts from the JAX package's init, moved to the scale of a
trained field (table entries N(0, 1e-3), hash-feature weights of the
first SDF layer N(0, 0.05)) so that every level's features and the
second-order terms of the position cotangent are live.

Not a test: a one-off measurement (minutes, several GB). Run from the
repo root:

    JAX_PLATFORMS=cpu python -m tests.torch_delta_grad_f32 [--rays 8192]
        [--key 11]

It prints one JSON line: the loss of both, and per delta leaf the
largest absolute difference and the relative error |g_port − g_jax| /
|g_jax| (vector norms). To tell a precision loss from conditioning it
also differentiates both losses wrt the sample positions (the delta held
fixed): `pos_cotangent_rel_err` is the per-sample cotangents' difference
relative to their norm, and `translation_cancellation` is
Σ_i |c_i| / |Σ_i c_i| per axis (the translation's gradient is the sum of
the samples' position cotangents c_i, apart from clipped positions),
the factor by which float32 rounding of the terms grows in the sum.
"""

import argparse
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.models import delta_network as jdn
from rnb_neus2_tpu.render.losses import training_loss as jtraining_loss
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train import dynamic as jdynamic
from rnb_neus2_tpu.train.sampler import sample_ray_batch as jsample
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train import dynamic
from rnb_neus2_torch.train import trainer as trainer_mod
from rnb_neus2_torch.train.sampler import RayUniforms


def _cfg(pkg):
    return pkg.TestbedConfig(
        network=pkg.NetworkConfig(stoch_corner_bwd=0),
        march=pkg.MarchConfig(cone_angle=1.0 / 256.0))


def _moved_params(jparams, seed=1):
    p = jax.tree_util.tree_map(np.array, jparams)
    rng = np.random.default_rng(seed)
    p["hash_table"] = (1e-3 * rng.standard_normal(
        p["hash_table"].shape)).astype(np.float32)
    w_x, w_enc = p["sdf_mlp"][0]
    p["sdf_mlp"][0] = (w_x, (0.05 * rng.standard_normal(
        w_enc.shape)).astype(np.float32))
    return p


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--key", type=int, default=11,
                    help="the JAX PRNG key of the ray batch")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    R = args.rays
    scene = dict(n_views=8, width=64, height=64, radius=0.2)

    jseq = jdynamic.FrameSequenceTrainer(jsphere(**scene), _cfg(jconfig))
    params = _moved_params(jseq.trainer.params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    delta_np = {"rotation6d": np.array([1.0, 0.01, -0.02, 0.015, 1.0, 0.01],
                                       np.float32),
                "translation": np.array([0.01, -0.02, 0.005], np.float32)}
    jdelta = {k: jnp.asarray(v) for k, v in delta_np.items()}
    jtr, cfg = jseq.trainer, jseq.cfg
    # occupied cells in a shell about the sphere of radius 0.2
    G = round(jtr.occ.bitfield.shape[0] ** (1.0 / 3.0))
    c = (np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1)
         .transpose(2, 1, 0, 3).reshape(-1, 3) + 0.5) / G
    r = np.linalg.norm(c - 0.5, axis=1)
    bitfield = jnp.asarray((r > 0.12) & (r < 0.3))
    key = jax.random.PRNGKey(args.key)
    loss_cfg = dataclasses.replace(cfg.loss, ek_loss_weight=0.0)

    # the JAX package's delta loss (dynamic.py:_delta_step_fn)
    frozen = jdelta
    batch, samples, _, _ = jsample(
        jtr.dataset, bitfield, key, R, cfg.train.target_batch_size,
        cfg.march, ray_transform=lambda o, dd: jdn.apply_rigid(frozen, o, dd))
    Rm = jdn.rotation_6d_to_matrix(frozen["rotation6d"])
    o_raw = (batch.ray_o - frozen["translation"]) @ Rm
    d_raw = batch.ray_d @ Rm

    def loss_fn(d):
        o2, d2 = jdn.apply_rigid(d, o_raw, d_raw)
        rid = jnp.minimum(samples.ray_id, R - 1)
        pos = jnp.clip(o2[rid] + samples.t[:, None] * d2[rid], 0.0, 1.0)
        batch2 = batch._replace(ray_o=o2, ray_d=d2, sample_attrs=None)
        out = jtr.field.apply(jparams, pos, valid_level=None,
                              differentiable_positions=True)
        return jtraining_loss(out, samples, batch2, cfg.flags, loss_cfg,
                              1.0)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jdelta)

    # the port's FrameSequenceTrainer.delta_grad on JAX's uniforms
    k_xy, k_skip, k_light, k_start = jax.random.split(key, 4)
    t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)
    uni = RayUniforms(xy=t(jax.random.uniform(k_xy, (R, 2))),
                      skip=t(jax.random.uniform(k_skip, (R,))),
                      start=t(jax.random.uniform(k_start, (R,))),
                      light_idx=t(jax.random.randint(k_light, (R,), 0, 3),
                                  torch.int64))
    seq = dynamic.FrameSequenceTrainer(sphere_dataset(**scene), _cfg(config),
                                       device="cpu")
    seq.trainer = trainer_mod.Trainer(
        seq.trainer.dataset, seq.cfg, device="cpu",
        params=interop.params_from_jax(params))
    seq.trainer.occ = seq.trainer.occ._replace(
        bitfield=torch.from_numpy(np.array(bitfield)))
    seq.delta = {k: torch.from_numpy(v) for k, v in delta_np.items()}
    real = dynamic.sample_ray_batch
    dynamic.sample_ray_batch = lambda *a, **k: real(
        *a, **{**k, "uniforms": uni})
    try:
        loss, g = seq.delta_grad(R)
    finally:
        dynamic.sample_ray_batch = real

    # the per-sample position cotangents of both losses
    rid = jnp.minimum(samples.ray_id, R - 1)
    o2, d2 = jdn.apply_rigid(jdelta, o_raw, d_raw)
    jpos = jnp.clip(o2[rid] + samples.t[:, None] * d2[rid], 0.0, 1.0)
    batch2 = batch._replace(ray_o=o2, ray_d=d2, sample_attrs=None)

    def pos_loss(p):
        out = jtr.field.apply(jparams, p, valid_level=None,
                              differentiable_positions=True)
        return jtraining_loss(out, samples, batch2, cfg.flags, loss_cfg,
                              1.0)[0]

    jc = np.asarray(jax.jit(jax.grad(pos_loss))(jpos), np.float64)
    from rnb_neus2_torch.ops.ray_march import FlatSamples
    from rnb_neus2_torch.render.losses import RayBatch, training_loss
    conv = lambda a: torch.from_numpy(
        np.array(a).astype(np.int64) if np.asarray(a).dtype == np.int32
        else np.array(a))
    tsamples = FlatSamples(*[conv(getattr(samples, f))
                             for f in FlatSamples._fields])
    tbatch = RayBatch(*[None if getattr(batch2, f) is None
                        else conv(getattr(batch2, f)) for f in batch2._fields])
    tpos = conv(jpos).requires_grad_(True)
    field = seq.trainer.field
    with field.frozen():
        tout = field(tpos, differentiable_positions=True)
        tl, _ = training_loss(tout, tsamples, tbatch, cfg.flags, loss_cfg,
                              1.0)
        (tc,) = torch.autograd.grad(tl, tpos)
    tc = tc.double().numpy()
    out = {"rays": R, "key": args.key, "samples_valid": int(np.asarray(samples.valid).sum()),
           "loss_port": float(loss), "loss_jax": float(jl), "leaves": {}}
    for k in delta_np:
        a = g[k].double().numpy()
        b = np.asarray(jg[k], np.float64)
        out["leaves"][k] = {
            "max_abs_diff": float(np.abs(a - b).max()),
            "rel_err": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            "norm_jax": float(np.linalg.norm(b))}
    out["pos_cotangent_rel_err"] = float(np.linalg.norm(tc - jc)
                                         / np.linalg.norm(jc))
    out["translation_cancellation"] = (np.abs(jc).sum(0)
                                       / np.abs(jc.sum(0))).tolist()
    # each package's translation gradient against the float64 sum of the
    # JAX package's per-sample cotangents (no sample is clipped here)
    ref = jc.sum(0)
    for name, gt in (("port", g["translation"].double().numpy()),
                     ("jax", np.asarray(jg["translation"], np.float64))):
        out[f"translation_rel_err_{name}_vs_f64_sum"] = float(
            np.linalg.norm(gt - ref) / np.linalg.norm(ref))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
