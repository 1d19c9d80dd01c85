"""Asynchronous per-frame VDB export — the counterpart of
``fluidsim_tpu/io/export.py``.

The reference writes ``simulation/mygrids<i>.vdb`` every frame from the
main loop (``fluid.cc:1503-1509``, ``mpm.cc:1433-1434``).  Here:

* a **sparse packer** (:func:`pack_active`, PyTorch on the grid's device)
  turns the dense occupancy grid into one uint8 buffer ``[count | bit-mask
  | compacted active values]``, the JAX package's buffer bit for bit.  The
  FLIP persistence rule (overwrite every non-solid cell,
  ``fluid.cc:1434-1448``: the written field is ``occ * ~solid``) is folded
  into the packer; MPM's rule (only cells with mass > 0.1,
  ``mpm.cc:1368-1382``) keeps a host-side persistent field.
* ``submit`` queues the pack and one non-blocking copy of the whole
  buffer into a pinned host buffer on the caller's stream, then records a
  CUDA event.  A **fetch thread** waits on the event and unpacks; an
  in-order **process thread** applies the persistence rule and hands the
  grid to the native encode/write queue (``io/native.py``).  The frame
  loop never blocks on the copy, the codec or the disk.

The JAX package's predictive head slice and its second fetch round trip
served a slow host link; over PCIe the whole packed frame (~2.4 MB at
129^3 with the default cap) is one copy, so the port fetches it whole.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def packed_size(ncells: int, cap: int) -> int:
    """Bytes of :func:`pack_active`'s buffer for ``ncells`` cells."""
    return 4 + (-(-ncells // 8) * 8) // 8 + 4 * min(cap, ncells)


def pack_active(grid: torch.Tensor, solid_flat: torch.Tensor | None,
                cap: int) -> torch.Tensor:
    """Sparse packer on the grid's device: dense (nx, ny, nz) f32 -> one
    uint8 buffer, with no read of the device.

    ``solid_flat``: flat bool mask of cells forced to 0 first (None to
    skip).  Layout: ``[count:int32 | bits:ncells/8 | vals:4*min(cap,
    ncells)]``, ``bits`` the little-endian bit-packed ``grid != 0`` mask
    and ``vals`` the values stably partitioned active-first (the active
    ones in flat order, then the inactive ones), cut to ``cap``.  If
    ``count > cap`` the active values are truncated: callers fall back to
    a dense fetch for that frame.

    The partition is a scatter to each cell's slot (its rank among the
    active cells, or ``count`` plus its rank among the inactive ones), the
    JAX package's stable sort on ``~active`` without the sort and without
    an output whose size depends on the data."""
    flat = grid.reshape(-1)
    if solid_flat is not None:
        flat = torch.where(solid_flat, 0.0, flat)
    n = flat.shape[0]
    npad = -(-n // 8) * 8
    act = flat != 0
    actp = torch.zeros(npad, dtype=torch.uint8, device=flat.device)
    actp[:n] = act
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=flat.device)
    bits = (actp.reshape(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)
    rank = torch.cumsum(act, 0, dtype=torch.int64)       # active at or before
    count = rank[-1:]
    idx = torch.arange(n, dtype=torch.int64, device=flat.device)
    slot = torch.where(act, rank - 1, count + idx - rank)
    vals = torch.empty_like(flat).scatter_(0, slot, flat)[:cap]
    return torch.cat([count.to(torch.int32).view(torch.uint8), bits,
                      vals.contiguous().view(torch.uint8)])


def unpack_active(buf: np.ndarray, shape, cap: int):
    """Host-side inverse of :func:`pack_active`.

    Returns ``(dense, count)``; ``dense`` is None when ``count > cap``
    (truncated packet — caller falls back to the dense fetch).
    """
    n = int(np.prod(shape))
    npad = -(-n // 8) * 8
    count = int(np.frombuffer(buf[:4].tobytes(), np.int32)[0])
    if count > cap:
        return None, count
    bits = buf[4:4 + npad // 8]
    mask = np.unpackbits(bits, bitorder="little")[:n].astype(bool)
    vals = np.frombuffer(buf[4 + npad // 8:].tobytes(), np.float32)
    dense = np.zeros(n, np.float32)
    dense[mask] = vals[:count]
    return dense.reshape(shape), count


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array of its own (never a view of a CPU tensor's memory)."""
    return t.detach().to("cpu", copy=True).numpy()


class AsyncFrameExporter:
    """Background per-frame VDB exporter (sparse fetch + write queue).

    ``submit(path, occ)`` queues one frame: ``occ`` is the occupancy tensor
    straight out of the step's metrics, on any device; the pack and the
    copy to the host are queued on the caller's stream, and the rest
    (unpack, persistence rule, encode, disk) happens on the worker threads.
    ``occ`` must not be changed in place until ``flush`` (a frame's
    occupancy never is): the dense copies below read it later.
    ``mode`` selects the reference's persistence rule: ``"flip"``
    overwrites all non-solid cells (stateless, fused into the packer),
    ``"mpm"`` only cells with value > 0.1.  With ``accum=True`` every
    frame's grid is kept for a final accumulated archive
    (``fluid.cc:1508-1509``).  ``dense_fetch=True`` copies the dense grid
    instead of the packed buffer.

    ``ref_topology=True`` reproduces the reference's FLIP *active
    topology* exactly: ``fluid.cc:1443-1445`` setValues EVERY non-solid
    voxel each frame (zeros included), so the reference file marks all
    non-solid voxels active.  The default (False) marks only nonzero
    voxels active — value-identical on read-back (inactive voxels return
    the 0 background) and cheaper to encode via the ACTIVE_MASK codec, but
    ``activeVoxelCount`` metadata and active-voxel iteration differ from
    the reference's output.  MPM topology matches the reference either way
    (only cells with mass > 0.1 are ever written, ``mpm.cc:1368-1382``,
    and those values are necessarily nonzero).

    Stream and lifetime: the packed buffer lands in one of ``depth + 2``
    host buffers (pinned for CUDA grids), each reused only after the fetch
    thread has copied the frame out of it, and read only after the event
    recorded behind its copy has completed.  A worker touches a device
    tensor only to copy the dense grid (``dense_fetch``, or a truncated
    packet), through the reference the queued frame holds, after that
    event.
    """

    def __init__(self, spec, solid_np, mode: str = "flip", cap: int | None = None,
                 compression: int | None = None, accum: bool = False,
                 depth: int = 4, dense_fetch: bool = False,
                 ref_topology: bool = False,
                 max_pending_bytes: int = 1 << 30):
        from fluidsim_tpu_torch.io.native import AsyncVdbWriter

        if mode not in ("flip", "mpm"):
            raise ValueError(f"mode {mode!r}: expected 'flip' or 'mpm'")
        self.spec = spec
        self.solid = np.asarray(solid_np, bool)
        self.mode = mode
        self.ref_topology = bool(ref_topology)
        ncells = int(np.prod(spec.shape))
        self.cap = int(cap) if cap else max(1, ncells // 4)
        self._hdr = 4 + (-(-ncells // 8) * 8) // 8
        self._nbytes = packed_size(ncells, self.cap)
        self.dense_fetch = bool(dense_fetch)
        self._solid_dev = {}             # device -> flat solid mask ("flip")
        self._persistent = (np.zeros(spec.shape, np.float32)
                            if mode == "mpm" else None)
        self._writer = AsyncVdbWriter(compression)
        self.accum_grids = [] if accum else None
        self.fallback_frames = 0
        # the whole packed buffer is fetched in one copy: no frame ever
        # needs a second fetch for the tail of its values, so this stays 0
        self.tail_fetches = 0
        self.max_pending = 0
        self.fetch_secs = 0.0          # cumulative wall in the fetch stage
        self.proc_secs = 0.0           # cumulative wall in the process stage
        self.submit_block_secs = 0.0   # main-loop time blocked on the queues
        # Host-memory budget for the encode/write queue: each queued
        # native job copies the dense values (4 B) + mask (1 B) per cell.
        # The process thread blocks while the writer backlog exceeds the
        # budget (backpressure_secs counts the wall); the bounded queues
        # then propagate the stall to submit_block_secs, so peak host
        # bytes stay <= budget + (depth + 2) frames.
        self._frame_bytes = 5 * ncells
        self.writer_cap_frames = max(2, int(max_pending_bytes)
                                     // self._frame_bytes)
        self.backpressure_secs = 0.0   # proc-thread wall spent throttling
        self._ring = None              # host buffers, made at the first submit
        self._free: queue.Queue = queue.Queue()
        self._depth = depth
        self._seq = 0
        self._fetch_q: queue.Queue = queue.Queue(maxsize=depth)
        self._proc_q: queue.Queue = queue.Queue(maxsize=depth + 2)
        self._err = None
        self._threads = [threading.Thread(target=self._fetch_loop,
                                          daemon=True),
                         threading.Thread(target=self._proc_loop,
                                          daemon=True)]
        for t in self._threads:
            t.start()

    @property
    def python_fallbacks(self) -> int:
        """Frames the writer wrote in Python because the native library
        did not build (0 when it did)."""
        return self._writer.python_fallbacks

    def counters(self) -> dict:
        return {k: getattr(self, k) for k in (
            "fallback_frames", "tail_fetches", "max_pending", "fetch_secs",
            "proc_secs", "submit_block_secs", "backpressure_secs",
            "python_fallbacks")}

    # ---- main-loop side ----

    def _make_ring(self, device: torch.device):
        pin = device.type == "cuda"
        self._ring = [torch.empty(self._nbytes, dtype=torch.uint8,
                                  pin_memory=pin)
                      for _ in range(self._depth + 2)]
        for i in range(len(self._ring)):
            self._free.put(i)

    def _solid_on(self, device: torch.device):
        if device not in self._solid_dev:
            self._solid_dev[device] = torch.as_tensor(
                self.solid.reshape(-1), device=device)
        return self._solid_dev[device]

    def submit(self, path: str, occ: torch.Tensor):
        if self._err is not None:
            raise RuntimeError("exporter worker failed") from self._err
        if tuple(occ.shape) != tuple(self.spec.shape):
            raise ValueError(f"grid of shape {tuple(occ.shape)}, expected "
                             f"{tuple(self.spec.shape)}")
        seq = self._seq
        self._seq += 1
        cuda = occ.device.type == "cuda"
        blocked = 0.0
        slot = None
        if not self.dense_fetch:
            if self._ring is None:
                self._make_ring(occ.device)
            t0 = time.monotonic()
            slot = self._free.get()
            blocked += time.monotonic() - t0
            packed = pack_active(
                occ, self._solid_on(occ.device) if self.mode == "flip"
                else None, self.cap)
            self._ring[slot].copy_(packed, non_blocking=cuda)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        t0 = time.monotonic()
        self._fetch_q.put((seq, path, slot, ready, occ))
        self.submit_block_secs += blocked + time.monotonic() - t0
        self.max_pending = max(
            self.max_pending,
            self._fetch_q.qsize() + self._proc_q.qsize()
            + self._writer.pending())

    def pending(self) -> int:
        return (self._fetch_q.qsize() + self._proc_q.qsize()
                + self._writer.pending())

    def flush(self):
        self._fetch_q.join()
        self._proc_q.join()
        self._writer.flush()
        if self._err is not None:
            raise RuntimeError("exporter worker failed") from self._err

    def close(self):
        if self._threads:
            self.flush()
            self._fetch_q.put(None)
            for t in self._threads:
                t.join()
            self._threads = []
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker side ----

    def _unpack(self, buf: np.ndarray):
        """(dense, mask) of a packed frame, copied out of ``buf``; (None,
        None) for a truncated packet."""
        n = int(np.prod(self.spec.shape))
        count = int(buf[:4].view(np.int32)[0])
        if count > self.cap:
            return None, None
        mask = np.unpackbits(buf[4:self._hdr], bitorder="little",
                             count=n).view(bool)
        dense = np.zeros(n, np.float32)
        dense[mask] = buf[self._hdr:self._hdr + 4 * count].view(np.float32)
        return dense.reshape(self.spec.shape), mask.reshape(self.spec.shape)

    def _fetch_loop(self):
        while True:
            item = self._fetch_q.get()
            if item is None:
                self._proc_q.put(None)
                self._fetch_q.task_done()
                return
            seq, path, slot, ready, occ = item
            try:
                t0 = time.monotonic()
                if ready is not None:
                    ready.synchronize()
                raw = slot is None             # dense fetch: solid not yet 0
                mask = None
                if slot is None:
                    dense = _host_copy(occ)
                else:
                    try:
                        dense, mask = self._unpack(self._ring[slot].numpy())
                    finally:
                        self._free.put(slot)
                    if dense is None:          # truncated: dense fallback
                        self.fallback_frames += 1
                        dense = _host_copy(occ)
                        raw = True
                del occ
                self.fetch_secs += time.monotonic() - t0
                self._proc_q.put((seq, path, dense, mask, raw))
            except BaseException as e:         # surface on next submit/flush
                self._err = e
            finally:
                self._fetch_q.task_done()

    def _proc_loop(self):
        # one fetch thread hands frames over in submission order, the order
        # the MPM persistence rule and the accumulated archive need
        while True:
            item = self._proc_q.get()
            if item is None:
                self._proc_q.task_done()
                return
            try:
                t0 = time.monotonic()
                self._write_one(*item[1:])
                self.proc_secs += time.monotonic() - t0
            except BaseException as e:         # surface on next submit/flush
                self._err = e
            finally:
                self._proc_q.task_done()

    def _write_one(self, path, dense, mask, raw):
        from fluidsim_tpu_torch.io.vdb import VdbGrid

        if self._writer.pending() >= self.writer_cap_frames:
            t0 = time.monotonic()
            while self._writer.pending() >= self.writer_cap_frames:
                time.sleep(0.002)
            self.backpressure_secs += time.monotonic() - t0

        # Active topology = nonzero cells: lets the ACTIVE_MASK codec
        # compact each leaf to its active values before zlib.  Inactive
        # voxels read back as the 0 background — value-identical to the
        # dense all-active form.
        if self.mode == "mpm":
            upd = (~self.solid) & (dense > 0.1)
            self._persistent[upd] = dense[upd]
            vals = self._persistent.copy()
            mask = vals != 0
        elif raw:
            vals = np.where(self.solid, np.float32(0.0), dense)
            mask = vals != 0
        else:
            vals = dense                        # solid rule fused in the pack
        if self.mode != "mpm" and self.ref_topology:
            # reference-faithful dense-active topology (see class doc)
            mask = ~self.solid
        g = VdbGrid(values=vals, origin=(-self.spec.bound,) * 3,
                    background=0.0, voxel_size=self.spec.dx, active=mask)
        self._writer.submit(path, g)
        if self.accum_grids is not None:
            self.accum_grids.append(g)
