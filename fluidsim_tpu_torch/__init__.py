"""fluidsim_tpu_torch — the FLIP liquid solver of ``fluidsim_tpu`` on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; the particle transfers and the pressure-solve
stencils are CUDA kernels (``csrc/``) built with ``nvcc`` at first use.  On
CPU tensors every kernel wrapper runs its plain PyTorch version instead, so
the package imports and runs without a GPU.  It never imports JAX.
"""

from fluidsim_tpu_torch.models.flip import FlipParams, FlipSim, FlipState
from fluidsim_tpu_torch.scenes import get_scene

__all__ = ["FlipParams", "FlipSim", "FlipState", "get_scene"]
