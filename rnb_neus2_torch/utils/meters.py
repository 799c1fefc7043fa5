"""Half-life EMA meter, the pipeline's logger and the per-stage timer
(port of `Ema`, `Logger` and `StageTimer` in
`rnb_neus2_tpu/utils/meters.py`; reference: Ema in common.h:245+)."""

from __future__ import annotations

import sys


class Ema:
    """Half-life based exponential moving average (common.h EEmaType)."""

    def __init__(self, half_life_steps: float = 50.0):
        self.half_life = max(half_life_steps, 1e-9)
        self.alpha = 0.5 ** (1.0 / self.half_life)
        self.value = 0.0
        self._initialized = False
        # updates since (re)initialization: a restore carries this along
        # with the value, so that a checkpoint taken before the first
        # update comes back uninitialized instead of set at 0.0
        self.updates = 0

    def update(self, x: float) -> float:
        if not self._initialized:
            self.value = float(x)
            self._initialized = True
        else:
            self.value = self.alpha * self.value + (1 - self.alpha) * float(x)
        self.updates += 1
        return self.value

    def set(self, x: float, updates: int = None):
        self.value = float(x)
        self._initialized = True
        if updates is not None:
            self.updates = int(updates)

    def reset(self):
        self.value = 0.0
        self._initialized = False
        self.updates = 0


class Logger:
    """[INFO]/[WARN]/[ERROR]-prefixed lines, as the pipeline's logger
    prints them (reference: SimpleLogger in rnb_neus2/pipeline.py:15-24)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def _emit(self, tag, msg):
        print(f"[{tag}] {msg}", file=self.stream, flush=True)

    def info(self, msg):
        self._emit("INFO", msg)

    def warning(self, msg):
        self._emit("WARN", msg)

    def error(self, msg):
        self._emit("ERROR", msg)


class StageTimer:
    """Wall-clock EMA per named stage (reference: m_training_prep_ms etc.,
    testbed.h:863-871)."""

    def __init__(self):
        self.meters = {}

    def observe(self, name: str, ms: float):
        self.meters.setdefault(name, Ema()).update(ms)

    def summary(self) -> dict:
        return {k: v.value for k, v in self.meters.items()}
