"""NHWC ops with JAX-package parity.  Three modules carry hand-written CUDA
kernels (``trunk_conv``, ``instance_norm`` behind ``norm``, ``head_conv``):
a CUDA tensor launches the kernel or the call raises, a CPU tensor takes the
plain PyTorch version beside it."""
