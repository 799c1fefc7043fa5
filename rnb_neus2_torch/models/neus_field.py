"""NeuS field: hash encoding → SDF MLP → analytic ∇sdf → RGB (albedo) MLP
(port of `rnb_neus2_tpu/models/neus_field.py`).

Reimplements the reference's `NerfNetwork` (nerf_network.h):

- SDF-MLP input = [xyz−0.5 (3) | hash features (L·F)], applied as two
  blocks (w_x, w_enc) of the first layer (the padded 48-wide input's pad
  columns multiply zeros);
- sdf = sdf_mlp_out[0] + sdf_bias (nerf_network.h:225-232);
- ∇sdf computed in the forward pass, closed form: the encoding returns its
  position-jacobian and the MLP's jacobian is chained through the ReLU
  masks (nerf_network.h:163-190). Autograd of the training loss through
  that expression is the second-order path;
- RGB-MLP input = [sdf feature (16) | dir-encoding slot (16, always zeros,
  so not computed) | xyz (3) | ∇sdf (3)], first layer as three blocks
  (w_feat, w_xyz, w_grad);
- trainable scalar variance, init 0.3, inv_s = exp(10·v);
- geometric (SAL) init of the SDF MLP;
- `compute_dtype` "bfloat16": every product of the two MLPs and their
  jacobian chains on bfloat16-rounded operands with float32 accumulation,
  the JAX package's mixed precision (`ops/mlp.py:dot`); outputs, the ReLU
  masks, the first layer's xyz column in the jacobian (w_x, as JAX keeps
  it) and the table cotangent stay float32.

Parameters (float32 masters): `hash_table` (T, F); `sdf_w_x`, `sdf_w_enc`
and `sdf_rest.i`; `rgb_w_feat`, `rgb_w_xyz`, `rgb_w_grad` and
`rgb_rest.i`; `variance` (1,). `interop.py` maps them to and from the JAX
package's parameter tree.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
from torch import nn

from ..config import HashGridConfig, NetworkConfig
from ..device import resolve_device
from ..ops import hash_encoding
from ..ops.mlp import COMPUTE_DTYPES, apply_mlp, dot, xavier_uniform

# parameters that are matrices (L2 regularized, always updated by Adam)
MATRIX_PREFIXES = ("sdf_", "rgb_")


class NeusField(nn.Module):

    def __init__(self, grid: HashGridConfig, net: NetworkConfig,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if net.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {net.compute_dtype!r}: one of "
                             f"{COMPUTE_DTYPES}")
        dev = resolve_device(device)
        self.grid = grid
        self.net = net
        self.static = hash_encoding.HashGridStatic(grid)
        self._encode_jac_variants: Dict[int, object] = {}
        g = generator
        normal = lambda *shape: torch.randn(shape, generator=g, device=dev)

        self.hash_table = nn.Parameter(
            hash_encoding.init_table(grid, g, dev))
        # SDF MLP, SAL geometric init (utils/mlp_weights.txt structure):
        # hidden N(0, √2/√out) with zeros on the hash-feature columns of the
        # first layer; output ≡ √(π/fan_in) plus tiny symmetry noise
        W = net.sdf_width
        self.sdf_w_x = nn.Parameter(math.sqrt(2.0) / math.sqrt(W)
                                    * normal(W, 3))
        self.sdf_w_enc = nn.Parameter(torch.zeros(W, grid.output_dim,
                                                  device=dev))
        dims = [W] * net.sdf_hidden_layers + [net.n_output_dims]
        rest = []
        for i in range(1, len(dims)):
            n_in, n_out = dims[i - 1], dims[i]
            if i == len(dims) - 1:
                w = (torch.full((n_out, n_in), math.sqrt(math.pi / n_in),
                                device=dev) + 1e-5 * normal(n_out, n_in))
            else:
                w = math.sqrt(2.0) / math.sqrt(n_out) * normal(n_out, n_in)
            rest.append(nn.Parameter(w))
        self.sdf_rest = nn.ParameterList(rest)
        # RGB MLP: first-layer blocks with the reference's fan-in of 48
        a = math.sqrt(6.0 / (net.rgb_input_dim + net.rgb_width))
        unif = lambda *shape: (torch.rand(shape, generator=g, device=dev)
                               * (2 * a) - a)
        Wr = net.rgb_width
        self.rgb_w_feat = nn.Parameter(unif(Wr, net.n_output_dims))
        self.rgb_w_xyz = nn.Parameter(unif(Wr, 3))
        self.rgb_w_grad = nn.Parameter(unif(Wr, 3))
        dims = [Wr] * net.rgb_hidden_layers + [net.n_output_dims]
        self.rgb_rest = nn.ParameterList([
            nn.Parameter(xavier_uniform(dims[i], dims[i - 1], g, dev))
            for i in range(1, len(dims))])
        self.variance = nn.Parameter(
            torch.full((1,), net.variance_init, device=dev))

    def _encode_jac(self, x, valid_level, n_active=None):
        key = min(self.grid.n_levels, n_active or self.grid.n_levels)
        if key not in self._encode_jac_variants:
            self._encode_jac_variants[key] = \
                hash_encoding.make_encode_with_jacobian_cv(
                    self.static, key,
                    corner_samples=self.net.stoch_corner_bwd)
        return self._encode_jac_variants[key](self.hash_table, x,
                                              valid_level)

    # -- SDF ---------------------------------------------------------------

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return dot(a, b, self.net.compute_dtype)

    def sdf_features(self, x: torch.Tensor, valid_level: int | None = None,
                     n_active: int | None = None) -> torch.Tensor:
        """(N,3)→(N,16) raw SDF-MLP output (row 0 + bias = sdf)."""
        enc = hash_encoding.encode(self.hash_table, x, self.static,
                                   valid_level, n_active)
        h = torch.relu(self._dot(x - 0.5, self.sdf_w_x.T)
                       + self._dot(enc, self.sdf_w_enc.T))
        return apply_mlp(list(self.sdf_rest), h, self.net.compute_dtype)

    def sdf(self, x: torch.Tensor, valid_level: int | None = None,
            n_active: int | None = None) -> torch.Tensor:
        """(N,3)→(N,) signed distance (with bias; nerf_network.h:225-232)."""
        return self.sdf_features(x, valid_level, n_active)[:, 0] \
            + self.net.sdf_bias

    def sdf_and_grad(self, x: torch.Tensor, valid_level: int | None = None,
                     n_active: int | None = None,
                     differentiable_positions: bool = False):
        """sdf, analytic ∇sdf and the 16-wide SDF features from ONE hash
        gather, all differentiable wrt the parameters. Wrt x only with
        `differentiable_positions` (rays whose geometry is trainable): then
        the encode is `hash_encoding.encode_with_jacobian` (all levels,
        `n_active` ignored, the exact table gradient), and ∇sdf carries the
        encode's second-order term; the ReLU masks stay constants."""
        if differentiable_positions:
            enc, jac = hash_encoding.encode_with_jacobian(
                self.hash_table, x, self.static, valid_level)
        else:
            enc, jac = self._encode_jac(x, valid_level, n_active)
        dot_ = self._dot
        w_x, w_enc = self.sdf_w_x, self.sdf_w_enc
        pre = dot_(x - 0.5, w_x.T) + dot_(enc, w_enc.T)
        h = torch.relu(pre)
        act = (pre > 0).to(h.dtype)
        jh = [act * (w_x[None, :, d] + dot_(jac[d], w_enc.T))
              for d in range(3)]
        rest = list(self.sdf_rest)
        for wl in rest[:-1]:
            pre = dot_(h, wl.T)
            act = (pre > 0).to(h.dtype)
            h = torch.relu(pre)
            jh = [act * dot_(j, wl.T) for j in jh]
        w_out = rest[-1]
        feats = dot_(h, w_out.T)
        sdf = feats[:, 0] + self.net.sdf_bias
        grad = torch.stack([dot_(j, w_out[0]) for j in jh], dim=-1)
        return sdf, grad, feats

    # -- full field ---------------------------------------------------------

    def forward(self, x: torch.Tensor, valid_level: int | None = None,
                n_active: int | None = None,
                differentiable_positions: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Full forward: albedo_raw (N,3), sdf (N,), grad (N,3), variance
        (scalar) — the packed 16-wide output of nerf_network.h:225-250 as a
        dict."""
        sdf, grad, feats = self.sdf_and_grad(x, valid_level, n_active,
                                             differentiable_positions)
        dot_ = self._dot
        h = torch.relu(dot_(feats, self.rgb_w_feat.T)
                       + dot_(x, self.rgb_w_xyz.T)
                       + dot_(grad, self.rgb_w_grad.T))
        rgb_out = apply_mlp(list(self.rgb_rest), h, self.net.compute_dtype)
        return {
            "albedo_raw": rgb_out[:, :3],
            "sdf": sdf,
            "grad": grad,
            "variance": self.variance[0],
        }

    def density(self, x: torch.Tensor, valid_level: int | None = None,
                n_active: int | None = None) -> torch.Tensor:
        """sdf → NeuS density s·σ(s·sdf)·(1−σ(s·sdf))
        (common_operation.cuh:311-328), used for the occupancy grid."""
        sdf = self.sdf(x, valid_level, n_active)
        s = torch.exp(10.0 * self.variance[0])
        sig = torch.sigmoid(sdf * s)
        return s * sig * (1.0 - sig)

    @contextlib.contextmanager
    def frozen(self):
        """No parameter requires a gradient inside the block: a loss
        differentiated wrt other tensors (a rigid delta, camera
        corrections) then computes no table or weight gradient and
        launches no scatter kernel."""
        params = [p for p in self.parameters() if p.requires_grad]
        for p in params:
            p.requires_grad_(False)
        try:
            yield self
        finally:
            for p in params:
                p.requires_grad_(True)

    def matrix_names(self):
        """Names of the matrix parameters (the MLP weights)."""
        return [n for n, _ in self.named_parameters()
                if n.startswith(MATRIX_PREFIXES)]
