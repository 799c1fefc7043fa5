"""Tracing and introspection (port of `rnb_neus2_tpu/utils/diagnostics.py`).

The reference keeps a loss-graph ring buffer (testbed.h:914,
update_loss_graph testbed.cu:1958) and per-hash-level parameter
histograms (LevelStats, testbed.h:221-235, gather_histograms
testbed.cu:3211). Equivalents here, and `profile_trace`, a
`torch.profiler` scope that records the card's kernels beside the host's
spans and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import List

import numpy as np
import torch


class LossGraph:
    """Fixed-size ring buffer of loss scalars (update_loss_graph)."""

    def __init__(self, capacity: int = 256):
        self.buf = np.zeros(capacity, np.float32)
        self.n = 0

    def update(self, value: float):
        self.buf[self.n % len(self.buf)] = value
        self.n += 1

    def values(self) -> np.ndarray:
        if self.n < len(self.buf):
            return self.buf[:self.n].copy()
        i = self.n % len(self.buf)
        return np.concatenate([self.buf[i:], self.buf[:i]])


@dataclass
class LevelStats:
    """Per-hash-level parameter statistics (testbed.h:221-235)."""

    level: int
    resolution: int
    n_params: int
    hashed: bool
    mean: float
    std: float
    min: float
    max: float
    frac_zero: float


def gather_level_stats(hash_table: torch.Tensor, static) -> List[LevelStats]:
    """Per-level summary of the table parameters (gather_histograms);
    `static` is the field's `HashGridStatic`."""
    table = hash_table.detach().cpu().numpy()
    out = []
    offsets = list(static.offsets) + [static.n_entries]
    for lvl in range(static.cfg.n_levels):
        chunk = table[offsets[lvl]:offsets[lvl + 1]]
        out.append(LevelStats(
            level=lvl,
            resolution=int(static.resolutions[lvl]),
            n_params=int(chunk.shape[0]),   # entries (×F floats each)
            hashed=bool(static.hashed[lvl]),
            mean=float(chunk.mean()),
            std=float(chunk.std()),
            min=float(chunk.min()),
            max=float(chunk.max()),
            frac_zero=float((chunk == 0).mean()),
        ))
    return out


def format_level_stats(stats: List[LevelStats]) -> str:
    lines = ["lvl  res   params    type  mean      std       max"]
    for s in stats:
        lines.append(f"{s.level:3d} {s.resolution:5d} {s.n_params:8d} "
                     f"{'hash' if s.hashed else 'dense'}  "
                     f"{s.mean:+.2e} {s.std:.2e} {s.max:+.2e}")
    return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda"):
    """A `torch.profiler` scope over the host and, on a CUDA `device`, the
    card; on exit the Chrome trace goes to `log_dir/trace.json`. Yields
    the profiler, whose `key_averages()` give the sums by name."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
