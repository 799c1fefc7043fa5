"""Data-parallel training (port of `rnb_neus2_tpu/parallel/`)."""

from .mesh import make_mesh  # noqa: F401
from .trainer import ParallelTrainer  # noqa: F401
