"""Particle transfers, pressure pieces, CG and the CUDA kernel wrappers."""
