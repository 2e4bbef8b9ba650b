"""PyTorch/CUDA port of the E4T diffusion system, for NVIDIA Hopper.

Mirrors the module layout of ``e4t_diffusion_tpu`` (the JAX reference it is
held against) and imports nothing of it.
"""
