"""NeuS SDF→alpha conversion and per-ray compositing (port of
`rnb_neus2_tpu/render/neus.py`).

Section-based alpha from the logistic CDF of the SDF at the section
endpoints, with the cos-annealed direction·gradient estimate
(`src/testbed_nerf.cu:1652-1677`). `composite` is the renderer's
front-to-back compositing over an (R, K) sample layout; compositing over
the training's flat sample buffer lives in `render/losses.py:
training_loss`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TRANSMITTANCE_EPSILON


class CompositeOut(NamedTuple):
    alpha: torch.Tensor     # (R, K)
    weight: torch.Tensor    # (R, K) = alpha · T, zeroed for dropped samples
    trans: torch.Tensor     # (R, K) transmittance BEFORE each sample
    keep: torch.Tensor      # (R, K) sample kept (valid & T ≥ ε)


def sdf_to_alpha(sdf: torch.Tensor, true_cos: torch.Tensor, dt: torch.Tensor,
                 inv_s: torch.Tensor, cos_anneal_ratio) -> torch.Tensor:
    """Per-sample NeuS alpha.

    iter_cos = −(relu(−tc·0.5+0.5)·(1−a) + relu(−tc)·a); section endpoints
    sdf ± iter_cos·dt/2; alpha = clip((cdf_prev − cdf_next + 1e−5) /
    (cdf_prev + 1e−5), 0, 1).
    """
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dt * 0.5
    est_prev = sdf - iter_cos * dt * 0.5
    cdf_next = torch.sigmoid(est_next * inv_s)
    cdf_prev = torch.sigmoid(est_prev * inv_s)
    p = cdf_prev - cdf_next
    return torch.clamp((p + 1e-5) / (cdf_prev + 1e-5), 0.0, 1.0)


def composite(alpha: torch.Tensor, valid: torch.Tensor) -> CompositeOut:
    """Front-to-back compositing with the reference's termination rule: a
    sample takes part iff it is valid and the transmittance entering it is
    ≥ 1e−4 (the serial loop breaks at T < EPSILON,
    testbed_nerf.cu:1491-1494)."""
    alpha = torch.where(valid, alpha, 0.0)
    # exclusive cumulative product along the samples (T entering each)
    inc = torch.cumprod(1.0 - alpha, dim=-1)
    trans = torch.cat([torch.ones_like(inc[..., :1]), inc[..., :-1]], dim=-1)
    keep = valid & (trans >= TRANSMITTANCE_EPSILON)
    weight = torch.where(keep, alpha * trans, 0.0)
    return CompositeOut(alpha=alpha, weight=weight, trans=trans, keep=keep)
