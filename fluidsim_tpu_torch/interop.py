"""Carry FLIP state between the JAX package and the port as numpy arrays.

``state_from_numpy`` takes a JAX ``FlipState`` given as numpy arrays (keys
``pos``, ``vel``, ``dt``, ``t``, ``frame``, ``pressure``) and builds the
port's ``FlipState`` on a given device; ``state_to_numpy`` goes back.  With
``FlipSim.from_state`` both packages can start a frame from the same state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from fluidsim_tpu_torch.models.flip import FlipState

_FLOAT_KEYS = ("pos", "vel", "dt", "t", "pressure")


def state_from_numpy(d: Mapping[str, np.ndarray], device) -> FlipState:
    """Port ``FlipState`` on ``device`` from numpy arrays (f32; frame int32)."""
    f32 = {k: torch.tensor(np.asarray(d[k], dtype=np.float32), device=device)
           for k in _FLOAT_KEYS}
    frame = torch.tensor(np.asarray(d["frame"], dtype=np.int32), device=device)
    return FlipState(frame=frame, **f32)


def state_to_numpy(state: FlipState) -> dict:
    """The state's arrays as host numpy arrays, keyed as ``state_from_numpy``
    reads them."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in (*_FLOAT_KEYS, "frame")}
