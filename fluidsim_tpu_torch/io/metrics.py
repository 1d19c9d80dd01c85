"""Structured per-frame metrics (the reference's stdout "2"/"3"/"DT"/"Error"
prints, ``fluid.cc:1383-1502`` / ``mpm.cc:1315-1428``, as machine-readable
JSONL plus human-readable console lines) — the counterpart of
``fluidsim_tpu/io/metrics.py``, with the same keys and console line.

A frame's 0-d tensors are stacked on their device and copied to the host
in one ``.tolist()``: one device-to-host copy a frame, not one per metric.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO

import torch


def _host_scalars(metrics: dict) -> dict:
    """The frame's 0-d tensors as Python floats (as ``float(v)`` gives
    them), read in one copy; Python numbers, strings and bools as they
    are; everything else (the occupancy grid) left out."""
    names = [k for k, v in metrics.items()
             if isinstance(v, torch.Tensor) and v.ndim == 0]
    values = (torch.stack([metrics[k].to(torch.float64) for k in names])
              .tolist() if names else [])
    rec = dict(zip(names, values))
    out = {}
    for k, v in metrics.items():        # keep the metrics' own key order
        if k in rec:
            out[k] = rec[k]
        elif isinstance(v, (int, float, str, bool)):
            out[k] = v
    return out


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True,
                 echo_every: int = 1):
        if path:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        self._fh: IO | None = open(path, "a") if path else None
        self._echo = echo
        self._every = max(1, echo_every)
        self._t0 = time.time()

    def log(self, frame: int, metrics: dict):
        rec = {"frame": frame, "wall_time": round(time.time() - self._t0, 3)}
        rec.update(_host_scalars(metrics))
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._echo and frame % self._every == 0:
            bits = " ".join(f"{k}={rec[k]:.5g}" if isinstance(rec[k], float)
                            else f"{k}={rec[k]}"
                            for k in ("dt", "error", "outer_iters", "cg_iters",
                                      "kinetic_energy", "max_speed")
                            if k in rec)
            print(f"frame {frame:4d} [{rec['wall_time']:8.1f}s] {bits}",
                  file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
