"""NHWC ops with JAX-package parity.  Six modules carry hand-written CUDA
kernels (``trunk_conv``; ``instance_norm``, forward and backward;
``head_conv``; ``convt_bwd``, the backward of ``conv``'s transposed conv;
``int8_trunk``, the int8 conv with moments and the norm from them;
``reflect_pad``, the trunk backward's pad and its adjoint).  Each
kernel is one operator in PyTorch's dispatcher, ``torch.ops.nirgan.*``
(``_registry``): a CUDA tensor launches the kernel or the call raises, a
CPU tensor takes the plain PyTorch version beside it.  Importing this
package registers every operator, and imports no model, task or config
module."""

from nirgan_tpu_torch.ops import (conv, head_conv, instance_norm, int8_trunk,  # noqa: F401
                                  reflect_pad, trunk_conv)
