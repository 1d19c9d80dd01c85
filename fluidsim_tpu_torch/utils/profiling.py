"""Timing, tracing and failure detection — the counterpart of
``fluidsim_tpu/utils/profiling.py``: ``sync``, ``trace`` (``torch.profiler``
in place of ``jax.profiler``) and ``check_finite``, with the program's own
trace spans and host-wait counter.

Spans.  The frame marks its phases with ``span(name)``: inside
``tracing()`` (or ``trace(log_dir)``) each is a ``record_function`` range
``fs:<name>``, recorded by a running ``torch.profiler`` in the same trace as
the CUDA kernels, on one clock; a span's parent is the range that encloses
it, and every span of a frame nests in that frame's ``fs:frame``.  Outside
``tracing()`` a span is one shared no-op context: no range, no clock read,
no allocation.  ``attribute`` reads such a trace: each kernel's device time
goes to the innermost span around its launch.

Host waits.  Every read of a device value in a frame (``bool``, ``int``,
``float``) and every blocking upload of a host constant goes through
``host_wait(site, fn, ...)``, which counts it in ``host_wait.counts[site]``
(always, one integer increment, as the kernel wrappers' ``.launches``) and,
with tracing on, waits inside the span ``wait:<site>``.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import os
from collections import Counter, defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

PREFIX = "fs:"            # the program's ranges in a trace
WAIT = "wait:"            # the span name of a host wait: wait:<site>
RUNTIME = "cu"            # the CUDA runtime's and driver's calls: cuda*, cu*
_NOOP = contextlib.nullcontext()
_tracing = False


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


@contextlib.contextmanager
def tracing():
    """Record the program's spans for the block (nests; the state before it
    comes back after it)."""
    global _tracing
    before, _tracing = _tracing, True
    try:
        yield
    finally:
        _tracing = before


def span(name: str):
    """The range ``fs:<name>`` while tracing, else the shared no-op."""
    return record_function(PREFIX + name) if _tracing else _NOOP


def spanned(name: str, fn):
    """``fn`` itself while tracing is off, else ``fn`` called inside the span
    ``name`` (decided when wrapped: no cost a call when off)."""
    if not _tracing:
        return fn

    def call(*args, **kwargs):
        with record_function(PREFIX + name):
            return fn(*args, **kwargs)
    return call


def host_wait(site: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call that waits for the device (a read of
    a device value, a blocking upload), counted in ``host_wait.counts`` and
    made inside the span ``wait:<site>`` while tracing."""
    host_wait.counts[site] += 1
    if not _tracing:
        return fn(*args, **kwargs)
    with record_function(PREFIX + WAIT + site):
        return fn(*args, **kwargs)


host_wait.counts = Counter()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block (host activity, and the CUDA
    kernels where a card is present) with the program's spans on, written
    as a Chrome trace to ``log_dir/trace.json`` when the block ends; a
    no-op for None.

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
    with profile(activities=activities) as prof, tracing():
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(times, ranges):
    """For each host time of ``times`` (sorted), the name of the innermost
    of the properly nested ``ranges`` ((start, end, name)) that holds it,
    or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(events, window=None) -> dict:
    """What the program's spans hold in one ``torch.profiler`` trace
    (``events``: the profiler's ``events()``, times in microseconds).

    Each device operation counts for the innermost ``fs:`` span around its
    launch, the CUDA runtime or driver call that shares its correlation id
    (an operation without one counts as unattributed).  A parent's time is
    its self time: what its child spans launched is theirs.  An idle gap of
    the device timeline counts as wait idle when it starts while the host
    is inside an ``fs:wait:`` span.  The device-side copies of ranges (user
    annotations) are no device work.  ``window`` (start, end) clips the
    device timeline; None: from the first ``fs:`` range's start to the
    last end of a range or a device operation.  Returns seconds: the self
    device time of each span by name (``spans``, without the prefix), the
    device time launched outside every span (``unattributed_s``), the
    device time, the union of the device's operations (``busy_s``), the
    window, the wait idle in all and by the site of the wait its gap
    starts in (``wait_idle``), and how many ranges of each name the trace
    holds (``calls``)."""
    ranges, device, launches = [], [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (e.is_user_annotation or e.name.startswith(PREFIX)):
                device.append((a, b, e.id))
        elif e.name.startswith(PREFIX):
            ranges.append((a, b, e.name[len(PREFIX):]))
        elif e.name.startswith(RUNTIME):
            launches[e.id] = a
    if window is None:
        ends = [r[1] for r in ranges] + [d[1] for d in device]
        window = (min((r[0] for r in ranges), default=0.0),
                  max(ends, default=0.0))
    w0, w1 = window
    device = [(max(a, w0), min(b, w1), cid) for a, b, cid in device
              if b > w0 and a < w1]
    at = [launches.get(cid) for _a, _b, cid in device]
    known = sorted((t, i) for i, t in enumerate(at) if t is not None)
    names = _innermost([t for t, _i in known], ranges)
    spans = defaultdict(float)
    unattributed = sum(b - a for (a, b, _c), t in zip(device, at)
                       if t is None)
    for (_t, i), name in zip(known, names):
        a, b = device[i][:2]
        if name is None:
            unattributed += b - a
        else:
            spans[name] += b - a
    busy = _union([(a, b) for a, b, _c in device])
    waits = sorted((a, b, name[len(WAIT):]) for a, b, name in ranges
                   if name.startswith(WAIT))
    starts = [a for a, _b, _n in waits]
    gaps = zip([w0] + [b for _a, b in busy], [a for a, _b in busy] + [w1])
    wait_idle = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        if g1 > g0 and i >= 0 and waits[i][1] >= g0:
            wait_idle[waits[i][2]] += g1 - g0
    return {
        "spans": {k: v / 1e6 for k, v in spans.items()},
        "unattributed_s": unattributed / 1e6,
        "device_s": sum(b - a for a, b, _c in device) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "wait_idle_s": sum(wait_idle.values()) / 1e6,
        "wait_idle": {k: v / 1e6 for k, v in wait_idle.items()},
        "calls": dict(Counter(name for _a, _b, name in ranges)),
    }


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
