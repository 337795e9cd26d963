"""PyTorch/CUDA port of ``nirgan_tpu`` for one NVIDIA H100.

The JAX package stays the reference; each module here mirrors its
counterpart's path and names.  Imports torch, never jax.
"""
