"""Timing, tracing and failure detection — the counterpart of
``fluidsim_tpu/utils/profiling.py``: ``sync``, ``PhaseTimer``, ``trace``
(``torch.profiler`` in place of ``jax.profiler``) and ``check_finite``."""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict

import torch


def sync(x):
    """Wait for the device work behind ``x`` (a tensor, or a dict, list or
    tuple of them): ``torch.cuda.synchronize`` of each CUDA device it
    touches; nothing for CPU tensors.  Returns ``x``."""
    leaves = (list(x.values()) if isinstance(x, dict)
              else list(x) if isinstance(x, (list, tuple)) else [x])
    devices = {v.device for v in leaves
               if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    return x


class PhaseTimer:
    """Accumulating per-phase wall-clock timer with throughput helpers."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.time()
        yield
        self.totals[name] += time.time() - t0
        self.counts[name] += 1

    def report(self, particles: int | None = None):
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            line = f"{name:24s} {t:8.3f}s total  {t / max(c, 1) * 1000:8.1f} ms/call ({c})"
            if particles and c:
                line += f"  {particles * c / t / 1e6:8.1f}M particle-steps/s"
            lines.append(line)
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block (host activity, and the CUDA
    kernels where a card is present), written as a Chrome trace to
    ``log_dir/trace.json`` when the block ends; a no-op for None.

    A process steps frames slower after the profiler has run in it (H100
    runs): time frames before a trace, never after one."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
