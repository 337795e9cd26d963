"""NHWC ops with JAX-package parity.  Four modules carry hand-written CUDA
kernels (``trunk_conv``; ``instance_norm``, forward and backward;
``head_conv``; ``convt_bwd``, the backward of ``conv``'s
transposed conv).  Each op is one autograd Function: a CUDA tensor launches
the kernel or the call raises, a CPU tensor takes the plain PyTorch version
beside it."""
