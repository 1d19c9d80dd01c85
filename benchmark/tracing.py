"""What the traced run reads: phase ranges around the program's calls, and
the summary of a ``torch.profiler`` trace of the frame loop.

Two ways to wrap the phases (the functions a frame calls, listed by each
system's ``PHASES``), both by ``wrapped``:

* labelled: a ``record_function`` range around each call and nothing
  else, so that the idle gaps of the profiled sub-window can be
  named after the phase the host was in, without a synchronise that would
  change the idle share;
* timed: the device synchronised at both ends of each call and its
  host-clock time added to the phase's wall (the method of
  ``fluidsim_tpu_torch/utils/frame_profile.py``): a phase's wall holds every
  kernel it launched, and the synchronises make that sub-window slower, so
  it gives the phase walls only.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import time
from collections import defaultdict

from torch.autograd import DeviceType
from torch.profiler import record_function

WINDOW = "bench:window"
FRAME = "bench:frame"
PHASE = "phase:"
OURS = ("bench:", PHASE)
TOP = 10
NAME = 120    # characters of a kernel's name kept in the breakdown
# host calls that wait for the device (a read of a device value is an
# asynchronous copy and one of these)
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy"}


@contextlib.contextmanager
def wrapped(phases, *, sync=None, walls=None):
    """Wrap each ``(phase, layer, module, function)`` of ``phases`` for the
    block: in a labelled range, or, with ``sync`` and ``walls`` (a dict),
    timed between synchronises into ``walls[phase]`` (seconds)."""
    saved = []
    for phase, _layer, modname, name in phases:
        mod = importlib.import_module(modname)
        fn = getattr(mod, name)
        if walls is None:
            @functools.wraps(fn)
            def call(*args, _fn=fn, _tag=PHASE + phase, **kwargs):
                with record_function(_tag):
                    return _fn(*args, **kwargs)
        else:
            @functools.wraps(fn)
            def call(*args, _fn=fn, _phase=phase, **kwargs):
                sync()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                sync()
                walls[_phase] += time.perf_counter() - t0
                return out
        saved.append((mod, name, fn))
        setattr(mod, name, call)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(t, ranges_sorted) -> bool:
    i = bisect.bisect_right(ranges_sorted, (t, float("inf"))) - 1
    return i >= 0 and ranges_sorted[i][0] <= t <= ranges_sorted[i][1]


def summarize(events) -> dict:
    """The numbers of one profiled sub-window (``events``: the profiler's
    ``events()``, times in microseconds): the window's span, the union of
    the device's operation intervals in it, their summed time, the device
    operations by time, the host's waits on the device inside the frames,
    NCCL's device time, and the longest idle gaps named by what the host
    was doing."""
    window = None
    frames, phases, host, device = [], [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(OURS) and e.device_type == DeviceType.CUDA:
            continue    # the profiler's device-side copy of a range of ours
        if e.device_type == DeviceType.CUDA:
            device.append((a, b, e.name))
        elif e.name == WINDOW:
            window = (a, b)
        elif e.name == FRAME:
            frames.append((a, b))
        elif e.name.startswith(PHASE):
            phases.append((a, b, e.name[len(PHASE):]))
        else:
            host.append((a, b, e.name))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window
    device = [(max(a, w0), min(b, w1), name) for a, b, name in device
              if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in device])
    by_op = defaultdict(float)
    nccl = 0.0
    for a, b, name in device:
        by_op[name] += b - a
        if "nccl" in name.lower():
            nccl += b - a
    frames.sort()
    syncs = sum(1 for a, _b, name in host
                if name in SYNC_CALLS and _inside(a, frames))
    gaps = [(b0, a1) for (_a0, b0), (a1, _b1) in zip(busy, busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_s": sum(by_op.values()) / 1e6,
        "nccl_s": nccl / 1e6,
        "host_syncs": syncs,
        "device_ops": [[name[:NAME], t / 1e6] for name, t in
                       sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_label(0.5 * (a + b), phases, host), (b - a) / 1e6]
                      for a, b in gaps],
    }


def _label(t, phases, host) -> str:
    """The phase the host was in at time ``t`` (a gap's middle) and its
    innermost call then (the one that started last among those that span
    ``t``)."""
    def innermost(spans):
        best = None
        for a, b, name in spans:
            if a <= t <= b and (best is None or a >= best[0]):
                best = (a, name)
        return None if best is None else best[1]

    phase = innermost(phases) or "between phases"
    call = innermost(host)
    return phase if call is None else f"{phase}: {call}"
