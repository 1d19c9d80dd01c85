"""Frame-loop failure detection — the counterpart of ``check_finite`` in
``fluidsim_tpu/utils/profiling.py``."""

from __future__ import annotations

import math


def check_finite(metrics: dict, frame: int):
    """Raise on a non-finite kinetic energy or a collapsed dt, so a frame
    loop stops instead of silently diverging."""
    ke = float(metrics.get("kinetic_energy", 0.0))
    dt = float(metrics.get("dt", 1.0))
    if not math.isfinite(ke):
        raise FloatingPointError(
            f"non-finite kinetic energy at frame {frame}: {ke}")
    if dt <= 0 or not math.isfinite(dt):
        raise FloatingPointError(f"invalid dt at frame {frame}: {dt}")
