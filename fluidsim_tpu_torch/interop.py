"""Carry FLIP and MPM state between the JAX package and the port as numpy
arrays.

``state_from_numpy`` takes a JAX ``FlipState`` given as numpy arrays (keys
``pos``, ``vel``, ``dt``, ``t``, ``frame``, ``pressure``, and ``aff`` in
APIC mode) and builds the port's ``FlipState`` on a device; ``state_to_numpy``
goes back.  With ``FlipSim.from_state`` both packages can start a frame from
the same state.  ``mpm_state_from_numpy`` and ``mpm_state_to_numpy`` do the
same for ``MpmState`` (``pos``, ``vel``, ``FE``, ``FP``, ``volume``, ``dt``,
``t``, ``frame``); assign the result to ``MpmSim.state``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from fluidsim_tpu_torch.models.flip import FlipState
from fluidsim_tpu_torch.models.mpm import MpmState

_FLOAT_KEYS = ("pos", "vel", "dt", "t", "pressure")
_MPM_FLOAT_KEYS = ("pos", "vel", "FE", "FP", "volume", "dt", "t")


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
