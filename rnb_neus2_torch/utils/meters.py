"""Half-life EMA meter (port of `Ema` in `rnb_neus2_tpu/utils/meters.py`;
reference: Ema in common.h:245+)."""

from __future__ import annotations


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
