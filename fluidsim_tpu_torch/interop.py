"""Carry FLIP and MPM state between the JAX package and the port as numpy
arrays.

``state_from_numpy`` takes a JAX ``FlipState`` given as numpy arrays (keys
``pos``, ``vel``, ``dt``, ``t``, ``frame``, ``pressure``, and ``aff`` in
APIC mode) and builds the port's ``FlipState`` on a device; ``state_to_numpy``
goes back.  With ``FlipSim.from_state`` both packages can start a frame from
the same state.  ``mpm_state_from_numpy`` and ``mpm_state_to_numpy`` do the
same for ``MpmState`` (``pos``, ``vel``, ``FE``, ``FP``, ``volume``, ``dt``,
``t``, ``frame``); assign the result to ``MpmSim.state``.

``sharded_state_from_numpy`` and ``sharded_mpm_state_from_numpy`` take a
JAX ``ShardedFlipState`` or ``ShardedMpmState`` as numpy arrays (the
particle arrays ``(world * cap, ...)``, the FLIP pressure ``(world * nl, n,
n)``) and build one rank's state of the port's sharded sims; assign it to
the sim's ``state``.  ``sharded_state_to_numpy`` and
``sharded_mpm_state_to_numpy`` gather the ranks' states back into those
arrays (on every rank: all ranks call them together).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from fluidsim_tpu_torch.models.flip import FlipState
from fluidsim_tpu_torch.models.mpm import MpmState
from fluidsim_tpu_torch.parallel.flip_sharded import (SENTINEL,
                                                      ShardedFlipState)
from fluidsim_tpu_torch.parallel.halo import world
from fluidsim_tpu_torch.parallel.mpm_sharded import ShardedMpmState

_FLOAT_KEYS = ("pos", "vel", "dt", "t", "pressure")
_MPM_FLOAT_KEYS = ("pos", "vel", "FE", "FP", "volume", "dt", "t")
_PARTICLE_KEYS = ("pos", "vel", "alive")
_MPM_PARTICLE_KEYS = ("pos", "vel", "FE", "FP", "volume", "alive")


def state_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> FlipState:
    """Port ``FlipState`` on ``device`` from numpy arrays (f32; frame
    int32).  ``aff`` is carried when ``d`` holds it and it is not None."""
    f32 = {k: torch.tensor(np.asarray(d[k], dtype=np.float32), device=device)
           for k in _FLOAT_KEYS}
    frame = torch.tensor(np.asarray(d["frame"], dtype=np.int32), device=device)
    aff = d.get("aff")
    if aff is not None:
        aff = torch.tensor(np.asarray(aff, dtype=np.float32), device=device)
    return FlipState(frame=frame, aff=aff, **f32)


def state_to_numpy(state: FlipState) -> dict:
    """The state's arrays as host numpy arrays, keyed as ``state_from_numpy``
    reads them (``aff`` only when the state has one)."""
    keys = (*_FLOAT_KEYS, "frame") + (("aff",) if state.aff is not None else ())
    return {k: getattr(state, k).detach().cpu().numpy() for k in keys}


def mpm_state_from_numpy(d: Mapping[str, np.ndarray],
                         device="cuda") -> MpmState:
    """Port ``MpmState`` on ``device`` from numpy arrays (f32; frame int32).
    The volumes travel with the state, so a state taken after frame 0
    keeps them."""
    f32 = {k: torch.tensor(np.asarray(d[k], dtype=np.float32), device=device)
           for k in _MPM_FLOAT_KEYS}
    frame = torch.tensor(np.asarray(d["frame"], dtype=np.int32), device=device)
    return MpmState(frame=frame, **f32)


def mpm_state_to_numpy(state: MpmState) -> dict:
    """The state's arrays as host numpy arrays, keyed as
    ``mpm_state_from_numpy`` reads them."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in (*_MPM_FLOAT_KEYS, "frame")}


def _rank_slots(d, keys, rank: int, size: int, cap: int | None, fill: dict):
    """This rank's block of the (size * cap_in, ...) particle arrays.  With
    ``cap`` other than cap_in the block's alive rows move, in order, to the
    front of ``cap`` slots and the rest take ``fill`` (the dead slot)."""
    blocks = {k: np.split(np.asarray(d[k]), size)[rank] for k in keys}
    cap_in = blocks["alive"].shape[0]
    if cap is None or cap == cap_in:
        return blocks
    alive = blocks["alive"].astype(bool)
    k = int(alive.sum())
    if k > cap:
        raise ValueError(f"rank {rank} holds {k} particles, more than cap "
                         f"{cap}")
    out = {}
    for name, a in blocks.items():
        o = np.empty((cap,) + a.shape[1:], a.dtype)
        o[:] = fill[name]
        o[:k] = a[alive]
        out[name] = o
    return out


def _replicated(d, device):
    f32 = {k: torch.tensor(np.asarray(d[k], dtype=np.float32), device=device)
           for k in ("dt", "t")}
    f32["frame"] = torch.tensor(np.asarray(d["frame"], dtype=np.int32),
                                device=device)
    return f32


def _tensors(blocks, device):
    return {k: torch.tensor(v if k == "alive" else v.astype(np.float32),
                            dtype=torch.bool if k == "alive" else None,
                            device=device)
            for k, v in blocks.items()}


def sharded_state_from_numpy(d: Mapping[str, np.ndarray], rank: int,
                             size: int, cap: int | None = None,
                             device="cuda") -> ShardedFlipState:
    """Rank ``rank`` of ``size``'s ``ShardedFlipState`` from the JAX state's
    numpy arrays: its block of the particles (re-packed into ``cap`` slots
    when ``cap`` differs from the JAX sim's) and of the pressure."""
    fill = {"pos": SENTINEL, "vel": 0.0, "alive": False}
    blocks = _rank_slots(d, _PARTICLE_KEYS, rank, size, cap, fill)
    pressure = np.split(np.asarray(d["pressure"], dtype=np.float32),
                        size)[rank]
    return ShardedFlipState(
        pressure=torch.tensor(pressure, device=device),
        **_tensors(blocks, device), **_replicated(d, device))


def sharded_mpm_state_from_numpy(d: Mapping[str, np.ndarray], rank: int,
                                 size: int, cap: int | None = None,
                                 device="cuda") -> ShardedMpmState:
    """Rank ``rank`` of ``size``'s ``ShardedMpmState`` from the JAX state's
    numpy arrays, re-packed into ``cap`` slots as
    ``sharded_state_from_numpy``."""
    fill = {"pos": SENTINEL, "vel": 0.0, "FE": np.eye(3), "FP": np.eye(3),
            "volume": 0.0, "alive": False}
    blocks = _rank_slots(d, _MPM_PARTICLE_KEYS, rank, size, cap, fill)
    return ShardedMpmState(**_tensors(blocks, device),
                           **_replicated(d, device))


def _gather_rows(t: torch.Tensor, group=None) -> np.ndarray:
    """The ranks' blocks of ``t`` stacked in rank order (numpy)."""
    size = world(group)[1]
    if size == 1:
        return t.detach().cpu().numpy()
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(wire) for _ in range(size)]
    torch.distributed.all_gather(parts, wire, group=group)
    out = torch.cat(parts).cpu().numpy()
    return out.astype(bool) if t.dtype == torch.bool else out


def sharded_state_to_numpy(state: ShardedFlipState, group=None) -> dict:
    """The ranks' ``ShardedFlipState`` as the JAX state's numpy arrays."""
    out = {k: _gather_rows(getattr(state, k), group)
           for k in (*_PARTICLE_KEYS, "pressure")}
    out.update({k: getattr(state, k).detach().cpu().numpy()
                for k in ("dt", "t", "frame")})
    return out


def sharded_mpm_state_to_numpy(state: ShardedMpmState, group=None) -> dict:
    """The ranks' ``ShardedMpmState`` as the JAX state's numpy arrays."""
    out = {k: _gather_rows(getattr(state, k), group)
           for k in _MPM_PARTICLE_KEYS}
    out.update({k: getattr(state, k).detach().cpu().numpy()
                for k in ("dt", "t", "frame")})
    return out
