"""fluidsim_tpu_torch — the FLIP, PIC and APIC liquid solver and the snow
MPM solver of ``fluidsim_tpu`` on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; the particle transfers (with MPM's force
scatter and gradW gather) and the pressure-solve stencils are CUDA kernels
(``csrc/``) built with ``nvcc`` at first use.  On CPU tensors every
kernel wrapper runs its plain PyTorch version instead, so the package
imports and runs without a GPU.  It never imports JAX.
"""

from fluidsim_tpu_torch.models.flip import FlipParams, FlipSim, FlipState
from fluidsim_tpu_torch.models.mpm import MpmParams, MpmSim, MpmState
from fluidsim_tpu_torch.scenes import get_scene

__all__ = ["FlipParams", "FlipSim", "FlipState", "MpmParams", "MpmSim",
           "MpmState", "get_scene"]


def __getattr__(name):
    # the sharded sim and the tools load on first use, as the JAX
    # package's lazy names do
    if name == "ShardedFlipSim":
        from fluidsim_tpu_torch.parallel.flip_sharded import ShardedFlipSim
        return ShardedFlipSim
    if name == "mesh_to_sdf":
        from fluidsim_tpu_torch.ops.mesh import mesh_to_sdf
        return mesh_to_sdf
    if name == "raytrace_levelset":
        from fluidsim_tpu_torch.ops.raytrace import raytrace_levelset
        return raytrace_levelset
    if name == "volume_to_mesh":
        from fluidsim_tpu_torch.ops.volume_to_mesh import volume_to_mesh
        return volume_to_mesh
    raise AttributeError(name)
