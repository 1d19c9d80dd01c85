"""Exact checkpoint/resume — the counterpart of
``fluidsim_tpu/io/checkpoint.py``, in the same ``.npz`` layout: a
``__meta__`` JSON string (``state_class``, ``fields``, ``none_fields``,
``params``, ``extra``) and one ``field_<name>`` array per field that is not
None.  Fields are stored and loaded by name, so a checkpoint of the JAX
package loads here and one written here loads there, whatever order the
two state classes declare their fields in.

The reference has no checkpointing: its per-frame ``.vdb`` dumps hold only
the output grid, so particle state is lost.  Here a checkpoint is the whole
state (particles, deformation gradients, dt, frame index) plus the
parameters, and resume is bit-exact.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from fluidsim_tpu_torch.models.flip import require_f32


def save_checkpoint(path: str, state, params=None, extra: dict | None = None):
    """Write a state dataclass to ``.npz`` (tensors copied to the host);
    fields that are None (``aff`` outside APIC) are recorded as absent."""
    arrays = {}
    none_fields = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            none_fields.append(f.name)
        else:
            arrays[f"field_{f.name}"] = v.detach().cpu().numpy()
    meta = {
        "state_class": type(state).__name__,
        "fields": [f.name for f in dataclasses.fields(state)],
        "none_fields": none_fields,
        "params": dataclasses.asdict(params) if params is not None else None,
        "extra": extra or {},
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(path: str, state_cls, dtype=None, device="cuda"):
    """Rebuild a ``state_cls`` (the port's ``FlipState`` or ``MpmState``)
    on ``device``, field by field.  ``dtype`` (float32 only, as the port's
    frames) converts the float fields.  Returns ``(state, meta)``; raises
    ``ValueError`` for a checkpoint of another state class."""
    if dtype is not None:
        require_f32(dtype)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["state_class"] != state_cls.__name__:
            raise ValueError(
                f"checkpoint holds {meta['state_class']}, expected "
                f"{state_cls.__name__}")
        kwargs = {}
        for name in meta["fields"]:
            if name in meta.get("none_fields", []):
                kwargs[name] = None
                continue
            leaf = z[f"field_{name}"]
            if dtype is not None and leaf.dtype.kind == "f":
                leaf = leaf.astype(np.float32)
            kwargs[name] = torch.from_numpy(np.array(leaf)).to(device)
    return state_cls(**kwargs), meta
