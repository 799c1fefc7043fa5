"""Render buffer: sample accumulation and tonemapping, headless (port of
`rnb_neus2_tpu/render/buffer.py`; the reference's CudaRenderBuffer,
src/render_buffer.cu:217-332).

Progressive multi-sample accumulation into a float buffer, then the
tonemap pipeline: 1) decode to linear, 2) exposure in linear space
(×2^exposure), 3) the tonemap curve (Identity / ACES / Hable / Reinhard,
render_buffer.cu:254-310), 4) encode to the output color space. The GUI
and DLSS that the reference's buffer feeds are out of scope; this feeds
screenshots and fly-through frames.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class ColorSpace(enum.Enum):        # common.h:126-130
    LINEAR = "linear"
    SRGB = "srgb"


class TonemapCurve(enum.Enum):      # common.h:133-138
    IDENTITY = "identity"
    ACES = "aces"
    HABLE = "hable"
    REINHARD = "reinhard"


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """`io/image_io.py:srgb_to_linear` on tensors."""
    return torch.where(x <= 0.04045, x / 12.92,
                       ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """`io/image_io.py:linear_to_srgb` on tensors."""
    return torch.where(x < 0.0031308, 12.92 * x,
                       1.055 * torch.clamp_min(x, 0.0) ** 0.41666 - 0.055)


def _tonemap_curve(x: torch.Tensor, curve: TonemapCurve) -> torch.Tensor:
    """Rational-polynomial tonemap curves with the constants of
    render_buffer.cu:254-310:

    - ACES folds a 0.6 pre-exposure into its fitted constants
      (k0 = 0.6²·2.51, k1 = 0.6·0.03, ...);
    - Hable folds a 2× exposure bias and the W = 11.2 white scale into
      its rational coefficients;
    - Reinhard is x/(Y + 1) on the Rec.709 luminance, per pixel (not per
      channel)."""
    if curve == TonemapCurve.IDENTITY:
        return x
    x = torch.clamp_min(x, 0.0)
    if curve == TonemapCurve.ACES:
        k0 = 0.6 * 0.6 * 2.51
        k1 = 0.6 * 0.03
        k2 = 0.0
        k3 = 0.6 * 0.6 * 2.43
        k4 = 0.6 * 0.59
        k5 = 0.14
    elif curve == TonemapCurve.HABLE:
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        k0 = A * F - A * E
        k1 = C * B * F - B * E
        k2 = 0.0
        k3 = A * F
        k4 = B * F
        k5 = D * F * F
        w = 11.2
        white_scale = (k3 * w * w + k4 * w + k5) / (k0 * w * w + k1 * w + k2)
        k0 = 4.0 * k0 * white_scale
        k1 = 2.0 * k1 * white_scale
        k2 = k2 * white_scale
        k3 = 4.0 * k3
        k4 = 2.0 * k4
    else:  # REINHARD: x / (dot(lum, x) + 1), Rec.709 luminance
        lum = torch.tensor([0.2126, 0.7152, 0.0722], dtype=x.dtype,
                           device=x.device)
        y = torch.sum(x * lum, dim=-1, keepdim=True)
        return x / (y + 1.0)
    sq = x * x
    return (sq * k0 + k1 * x + k2) / (k3 * sq + k4 * x + k5)


def tonemap(color: torch.Tensor, exposure: float = 0.0,
            curve: TonemapCurve = TonemapCurve.IDENTITY,
            color_space: ColorSpace = ColorSpace.LINEAR,
            output_color_space: ColorSpace = ColorSpace.SRGB
            ) -> torch.Tensor:
    """The tonemap pipeline (render_buffer.cu:313-332): color (..., 3) in
    `color_space` → (..., 3) in `output_color_space`."""
    x = color
    if color_space == ColorSpace.SRGB:
        x = srgb_to_linear(x)
    x = x * (2.0 ** exposure)
    x = _tonemap_curve(x, curve)
    if output_color_space == ColorSpace.SRGB:
        x = linear_to_srgb(torch.clamp(x, 0.0, 1.0))
    return x


@dataclasses.dataclass
class RenderBuffer:
    """Progressive accumulation buffer (render_buffer.cu
    accumulate_kernel): accumulate() folds a frame into the running mean,
    acc ← acc + (frame − acc)/(spp + 1) (render_buffer.cu:217-251), in
    linear RGBA."""
    accumulation: torch.Tensor          # (H, W, 4) linear RGBA
    spp: int = 0

    @classmethod
    def create(cls, width: int, height: int, device="cpu") -> "RenderBuffer":
        return cls(torch.zeros((height, width, 4), dtype=torch.float32,
                               device=device), 0)

    def clear(self) -> "RenderBuffer":
        return RenderBuffer(torch.zeros_like(self.accumulation), 0)

    def accumulate(self, frame: torch.Tensor) -> "RenderBuffer":
        """frame: (H, W, 4) linear RGBA of this sample pass."""
        acc = self.accumulation
        acc = acc + (frame - acc) / (self.spp + 1)
        return RenderBuffer(acc, self.spp + 1)

    def tonemapped(self, exposure: float = 0.0,
                   curve: TonemapCurve = TonemapCurve.IDENTITY,
                   output_color_space: ColorSpace = ColorSpace.SRGB
                   ) -> torch.Tensor:
        """(H, W, 4) display image; alpha passes through untouched."""
        rgb = tonemap(self.accumulation[..., :3], exposure, curve,
                      ColorSpace.LINEAR, output_color_space)
        return torch.cat([rgb, self.accumulation[..., 3:]], dim=-1)
