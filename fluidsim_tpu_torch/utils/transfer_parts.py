"""The row-layout transfers, part by part — the counterpart of the JAX
package's ``scripts/profile_p2g_parts.py`` and ``scripts/sweep_transfer.py``.

    python3 -m fluidsim_tpu_torch.utils.transfer_parts [--bound 64] [--density 25] [--device cuda]

It steps ``FlipSim("water_cube_drop")`` 3 frames from seed 0, sorts the
particles with ``transfer_kernels.sort_by_cell`` (dense ids, ncells = n^3:
the port has no haloed layout) and runs and times:

- the P2G half: the row build, the (P, 27, 4) values ``w * [1, v]`` in
  ``pad_rows_with_ids(..., 2048)`` rows; the scatter K8b
  (``rows.scatter_rows_cm``); rows 0-107 viewed as (27, 4, n, n, n) through
  the shift-reduce K6b (``transfer_kernels.shift_reduce``);
- the G2P half: the field build (``transfer_kernels.gather_fields`` of
  fields of ones inside the wall); the table K7b
  (``transfer_kernels.shift_expand``), padded from 108 to 128 rows; the
  gather K8a (``rows.gather_rows_cm``, into the P2G rows); the 27-offset
  contraction ``sum_o w27t[o] * rows[:, 4o:4o+4]^T`` in offset order from 0;
- sweep_transfer's one configuration: K8a and K8b on rows of the sorted
  ``pos, vel`` tiled to 127 lanes and a (128, ncells) table of ones.

The JAX script's sweep over the TPU tiles ``(w, t, wc)`` has no counterpart:
the port's kernels take no such arguments.  Times are the median of
``REPS`` runs with CUDA events on the card, each queued behind a spin kernel
so that the events time the device and not the host's launches; on the CPU
(``--device cpu``) the host clock.  The last line is a JSON object with
every time, the card's name and the sizes.

The functions below take the sorted state and return the intermediates,
so the CPU tests run the same pipeline at a small bound.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import NamedTuple

import torch

from fluidsim_tpu_torch.models.flip import FlipSim
from fluidsim_tpu_torch.ops import rows as rw
from fluidsim_tpu_torch.ops import transfer_kernels as tk

ROW_T = 2048        # pad_rows_with_ids' chunk, as the JAX script pads its rows
FRAMES = 3          # frames stepped before the transfers
SEED = 0
REPS = 20           # timed runs per part
_SPIN_CYCLES = 20_000_000   # ~10 ms of spinning on the H100: longer than
                            # the host takes to enqueue any part


class RowState(NamedTuple):
    """Particles sorted by the dense flat id of their base cell, with their
    (27, P) stencil weights."""
    pos_s: torch.Tensor
    vel_s: torch.Tensor
    flat: torch.Tensor
    w27t: torch.Tensor
    bound: int
    wall: int

    @property
    def n(self) -> int:
        return 2 * self.bound + 1


def frame_state(bound: int, density: float, device) -> RowState:
    """``water_cube_drop`` at ``bound`` and ``density`` after ``FRAMES``
    frames, sorted."""
    sim = FlipSim("water_cube_drop", bound=bound, density=density, seed=SEED,
                  device=device)
    for _ in range(FRAMES):
        sim.step()
    bound = sim.params.bound
    pos_s, vel_s, flat = tk.sort_by_cell(sim.state.pos, sim.state.vel, bound)
    return RowState(pos_s, vel_s, flat, tk.masked_weights_cm(pos_s, bound),
                    bound, sim.params.wall)


def row_build(st: RowState) -> torch.Tensor:
    """(P_pad, 128) rows: the 108 values ``w_o * [1, v]`` (lane ``4o + g``)
    and the id lane."""
    u = tk._wv_values(st.w27t, st.vel_s).reshape(-1, 108)
    return rw.pad_rows_with_ids(st.flat, u, ROW_T)[0]


def row_p2g(st: RowState, u_rows: torch.Tensor):
    """K8b, then K6b on its rows 0-107: ``(d, acc)``, the (128, n^3) cell
    sums and the (4, n, n, n) P2G sums."""
    n = st.n
    d = rw.scatter_rows_cm(u_rows, st.flat, n ** 3)
    return d, tk.shift_reduce(d[:108].view(27, 4, n, n, n))


def field_build(st: RowState, fields: torch.Tensor) -> torch.Tensor:
    """K7b's (4, n, n, n) input: the (C <= 3, n, n, n) fields masked to the
    wall, and the mask."""
    return tk.gather_fields(fields, st.bound, st.wall)


def row_table(fm: torch.Tensor) -> torch.Tensor:
    """K7b's table as a (128, n^3) channel-major matrix, rows 108-127 zero."""
    table = tk.shift_expand(fm).view(108, -1)
    return torch.nn.functional.pad(table, (0, 0, 0, rw.LANES - 108))


def contract(st: RowState, rows: torch.Tensor) -> torch.Tensor:
    """(4, P): ``sum_o w27t[o] * rows[:P, 4o:4o+4]^T``, added in offset
    order from 0 — K7a's products in K7a's order."""
    p = st.flat.shape[0]
    out = torch.zeros((4, p), dtype=torch.float32, device=rows.device)
    for o in range(27):
        out = out + st.w27t[o][None] * rows[:p, 4 * o:4 * o + 4].T
    return out


def row_g2p(st: RowState, table_cm: torch.Tensor, init_rows: torch.Tensor):
    """K8a of the table into ``init_rows``' layout, then the contraction:
    ``(rows, out)``, the (P_pad, 128) rows and the (4, P) sums."""
    rows = rw.gather_rows_cm(table_cm, init_rows, st.flat)
    return rows, contract(st, rows)


def sweep_inputs(st: RowState):
    """sweep_transfer's inputs: rows of the sorted ``pos, vel`` tiled to 127
    lanes with the id lane (the JAX script's 21 tiles fill 126 of the 127
    its comment asks for), and a (128, n^3) table of ones."""
    vals = torch.cat([st.pos_s, st.vel_s], dim=1).repeat(1, 22)[:, :127]
    rows = rw.pad_rows_with_ids(st.flat, vals, ROW_T)[0]
    return rows, torch.ones((rw.LANES, st.n ** 3), dtype=torch.float32,
                            device=rows.device)


def time_ms(fn, device: torch.device) -> float:
    """Median time of ``fn()`` in ms over ``REPS`` runs after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def time_parts(st: RowState) -> dict:
    """Each part's time in ms, in pipeline order."""
    dev = st.flat.device
    n = st.n
    u_rows = row_build(st)
    d, _ = row_p2g(st, u_rows)
    ones3 = torch.ones((3, n, n, n), device=dev)
    fm = field_build(st, ones3)
    table = tk.shift_expand(fm)
    table_cm = row_table(fm)
    rows = rw.gather_rows_cm(table_cm, u_rows, st.flat)
    ms = {
        "row build": time_ms(lambda: row_build(st), dev),
        "scatter_rows_cm": time_ms(
            lambda: rw.scatter_rows_cm(u_rows, st.flat, n ** 3), dev),
        "shift_reduce": time_ms(
            lambda: tk.shift_reduce(d[:108].view(27, 4, n, n, n)), dev),
        "field build": time_ms(lambda: field_build(st, ones3), dev),
        "shift_expand": time_ms(lambda: tk.shift_expand(fm), dev),
        "table pad": time_ms(lambda: torch.nn.functional.pad(
            table.view(108, -1), (0, 0, 0, rw.LANES - 108)), dev),
        "gather_rows_cm": time_ms(
            lambda: rw.gather_rows_cm(table_cm, u_rows, st.flat), dev),
        "contraction": time_ms(lambda: contract(st, rows), dev),
    }
    del d, table, table_cm, rows
    s_rows, ones = sweep_inputs(st)
    ms["sweep gather_rows_cm"] = time_ms(
        lambda: rw.gather_rows_cm(ones, s_rows, st.flat), dev)
    ms["sweep scatter_rows_cm"] = time_ms(
        lambda: rw.scatter_rows_cm(s_rows, st.flat, n ** 3), dev)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", type=int, default=64)
    ap.add_argument("--density", type=float, default=25.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    st = frame_state(args.bound, args.density, dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (host clock)")
    p = st.flat.shape[0]
    print(f"{kind}: water_cube_drop bound {args.bound} density "
          f"{args.density}, frame {FRAMES}: P={p} ncells={st.n ** 3}")
    ms = time_parts(st)
    for name, t in ms.items():
        print(f"{name:22s} {t:9.4f} ms")
    print(json.dumps({"device": kind, "bound": args.bound,
                      "density": args.density, "particles": p,
                      "ncells": st.n ** 3, "ms": ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
