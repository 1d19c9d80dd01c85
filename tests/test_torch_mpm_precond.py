"""The port's MPM frame with ``precond="jacobi"`` (the stiffness-diagonal
preconditioner, scattered through one more K1 launch a frame) against the
JAX package's, at ``mpm_cone`` bound 15.

Tolerances: ``tests/test_torch_mpm.py``'s ``_assert_frame_matches``
(kinetic energy rtol 1e-4, equal active cells and fallbacks, CG within 1
per solve, positions atol 1e-4, FE atol 1e-5), against the JAX fast path
from the seed and the Pallas branch (interpret mode) for one frame from
the fast path's state.
"""

import jax.numpy as jnp
import numpy as np
import torch

from fluidsim_tpu.models import mpm as jmpm
from fluidsim_tpu_torch import interop
from fluidsim_tpu_torch.models import mpm as tmpm
from test_torch_mpm import _assert_frame_matches


def test_mpm_jacobi_frames_match_jax():
    """Two frames from the seed against the fast path, then the third from
    the JAX state against the Pallas branch."""
    kw = dict(precond="jacobi", precond_gamma=1.5)
    jsim = jmpm.MpmSim("mpm_cone", density=40.0,
                       params=jmpm.MpmParams(fast_transfer=True, **kw))
    tsim = tmpm.MpmSim("mpm_cone", density=40.0, device="cpu",
                       params=tmpm.MpmParams(**kw))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(2):
            t, j = tsim.step(), jsim.step()
            _assert_frame_matches(t, j, tsim, jsim, 1)
        state = {k: np.array(getattr(jsim.state, k))
                 for k in ("pos", "vel", "FE", "FP", "volume", "dt", "t",
                           "frame")}
        jsim = jmpm.MpmSim("mpm_cone", density=40.0, params=jmpm.MpmParams(
            pallas_transfer=True, pallas_interpret=True, **kw))
        jsim.state = jmpm.MpmState(**{k: jnp.asarray(v)
                                      for k, v in state.items()})
        tsim.state = interop.mpm_state_from_numpy(state, device="cpu")
        t, j = tsim.step(), jsim.step()
        _assert_frame_matches(t, j, tsim, jsim, 1)
    finally:
        torch.set_num_threads(threads)
