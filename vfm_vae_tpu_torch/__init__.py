"""PyTorch/CUDA port of vfm_vae_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (ops/, models/; ops/kernels/ in place of
ops/pallas/, CUDA sources in csrc/). Imports torch and numpy only.
"""
