"""Parameters to and from the JAX package's layout.

The JAX package's field parameters are a tree
(`rnb_neus2_tpu/models/neus_field.py:76-99`):

  {"hash_table": (T, F),
   "sdf_mlp": [(w_x, w_enc), W1, ...],
   "rgb_mlp": [(w_feat, w_xyz, w_grad), W1, ...],
   "variance": (1,)}

`params_from_jax` takes that tree with numpy leaves (the caller converts
from JAX), or its flax state dict (lists and tuples as maps with keys "0",
"1", …), and returns the port's `NeusField` state dict; `params_to_jax` is
its inverse.

The optimizer state is the JAX package's optax chain
(`rnb_neus2_tpu/train/optimizer.py:make_optimizer`) as a flax state dict:

  {"0": {"inner_state": {}},                 masked L2 (no state)
   "1": {"count", "mu", "nu", "steps"},       sparse Adam
   "2": {"count"},                            the learning-rate schedule
   "3": {}}                                   scale(-1)

with `mu`, `nu` and `steps` laid out as the parameters, beside the EMA
parameters (`OptState.ema_params`); with `sparse_adam=False` the Adam
entry is optax's `ScaleByAdamState` {"count", "mu", "nu"}.
`opt_state_to_jax` and `opt_state_from_jax` convert it to and from the
port's `AdamChain`.

The dynamic scene's rigid delta is {"rotation6d": (6,), "translation":
(3,)} in both packages, and the camera refiner's parameters a
`CameraRefineParams` (rot, trans, exposure, focal): `tensors_from_numpy`
carries either, and `adam_state_from_jax` an optax `adam` state
({"0": ScaleByAdamState, "1": {}}, flax's state dict) into the port's
`Adam`. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _seq(x) -> list:
    """A list or tuple, or its flax state dict {"0": …, "1": …}, as a list."""
    if isinstance(x, dict):
        return [x[str(i)] for i in range(len(x))]
    return list(x)


def state_dict(tree):
    """flax's `to_state_dict` for a tree of dicts, lists and tuples: every
    list and tuple becomes a map with keys "0", "1", …"""
    if isinstance(tree, dict):
        return {k: state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    return tree


def params_from_jax(tree: Dict[str, Any], device="cpu", dtype=np.float32
                    ) -> Dict[str, torch.Tensor]:
    t = lambda a: torch.as_tensor(np.array(a, dtype), device=device)
    sdf, rgb = _seq(tree["sdf_mlp"]), _seq(tree["rgb_mlp"])
    out = {"hash_table": t(tree["hash_table"])}
    out["sdf_w_x"], out["sdf_w_enc"] = map(t, _seq(sdf[0]))
    for i, w in enumerate(sdf[1:]):
        out[f"sdf_rest.{i}"] = t(w)
    out["rgb_w_feat"], out["rgb_w_xyz"], out["rgb_w_grad"] = map(
        t, _seq(rgb[0]))
    for i, w in enumerate(rgb[1:]):
        out[f"rgb_rest.{i}"] = t(w)
    out["variance"] = t(tree["variance"])
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_to_jax(params: Dict[str, torch.Tensor], convert=_numpy
                  ) -> Dict[str, Any]:
    """The JAX field tree of a port state dict; `convert` maps each
    tensor to a leaf (numpy by default)."""
    n = lambda k: convert(params[k])
    rest = lambda prefix: [n(f"{prefix}.{i}") for i in range(
        sum(k.startswith(prefix + ".") for k in params))]
    return {
        "hash_table": n("hash_table"),
        "sdf_mlp": [(n("sdf_w_x"), n("sdf_w_enc"))] + rest("sdf_rest"),
        "rgb_mlp": [(n("rgb_w_feat"), n("rgb_w_xyz"), n("rgb_w_grad"))]
        + rest("rgb_rest"),
        "variance": n("variance"),
    }


def opt_state_to_jax(opt, convert=_numpy
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the optax chain's state dict, the EMA parameters' tree) of an
    `AdamChain`; the counts are int32 numpy scalars, `convert` maps each
    tensor to a leaf. A dense chain has no `steps`."""
    count = np.asarray(opt.count, np.int32)
    tree = lambda d: state_dict(params_to_jax(d, convert))
    adam = {"count": count, "mu": tree(opt.mu), "nu": tree(opt.nu)}
    if opt.sparse:
        adam["steps"] = tree(opt.steps)
    chain = {"0": {"inner_state": {}}, "1": adam,
             "2": {"count": count.copy()}, "3": {}}
    return chain, params_to_jax(opt.ema, convert)


def opt_state_from_jax(chain: Dict[str, Any], ema: Dict[str, Any],
                       device="cpu") -> Dict[str, Any]:
    """`AdamChain` fields (mu, nu, steps, ema: port state dicts; count:
    int) from the optax chain's state dict and the EMA parameters' tree.
    A chain without per-parameter `steps` (a dense-Adam snapshot) gets
    them at the global count, as the JAX package's restore does; a dense
    `AdamChain` does not read them."""
    adam = chain["1"]
    count = int(np.asarray(adam["count"]))
    mu = params_from_jax(adam["mu"], device)
    if "steps" in adam:
        steps = params_from_jax(adam["steps"], device, np.int32)
    else:
        steps = {k: torch.full(v.shape, count, dtype=torch.int32,
                               device=device) for k, v in mu.items()}
    return {"mu": mu, "nu": params_from_jax(adam["nu"], device),
            "steps": steps, "ema": params_from_jax(ema, device),
            "count": count}


def tensors_from_numpy(tree, device="cpu"):
    """A dict or NamedTuple of numpy arrays (the JAX package's delta or
    `CameraRefineParams`, converted by the caller) as float32 tensors in
    the same container."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    if isinstance(tree, tuple):
        return type(tree)(*(t(a) for a in tree))
    return {k: t(a) for k, a in tree.items()}


def adam_state_from_jax(state: Dict[str, Any], adam, device="cpu") -> None:
    """Load an optax `adam` state (flax's state dict of
    chain(scale_by_adam, scale_by_learning_rate): {"0": {"count", "mu",
    "nu"}, "1": {}}) into the port's `Adam` in place."""
    inner = state["0"]
    adam.count = int(np.asarray(inner["count"]))
    for name in ("mu", "nu"):
        live = getattr(adam, name)
        for k in live:
            live[k] = torch.as_tensor(np.array(inner[name][k], np.float32),
                                      device=device)
