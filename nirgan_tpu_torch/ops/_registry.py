"""The ``nirgan`` operator namespace: each of the port's hand-written kernels
as an operator in PyTorch's dispatcher (``torch.ops.nirgan.*``).

An operator has a schema, one implementation registered for the ``CPU``
and the ``CUDA`` dispatch keys, a fake (shape-only) implementation for
tracing (``torch.export``, ``torch.library.opcheck``) and, where the op has
a gradient, an autograd formula, registered at the ``Autograd`` key.  The
implementation is the routed call the op module always made:
``_lib.route`` sends a CUDA tensor to the kernel's wrapper (or the library
route that ``forward_route`` picks by shape) and a CPU tensor to the plain
version beside it.  A tensor on any
other device finds no implementation, or the fake implementation's
``_lib.route`` check, and raises: there is no fallback.

The low-level ``torch.library.Library`` API is used throughout, and the
gradient is registered as a lean ``Autograd`` kernel of its own (a
``torch.autograd.Function`` around the call below autograd, entered only
where a gradient is recorded) rather than through
``torch.library.register_autograd`` or ``torch.library.custom_op``: on the
card's host those added 1.5-1.8x the host time a call that this kernel
adds where autograd records, and the train step's 53 such calls are on its
critical path (``chip_smoke.py --phase export`` times all of them).

``nirgan_tpu_torch.ops`` imports every kernel module, so importing the
package registers every operator; a program exported with ``torch.export``
needs that import and nothing else of the port to load and run.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NAMESPACE = "nirgan"
LIBRARY = torch.library.Library(NAMESPACE, "DEF")
OPERATORS: list[str] = []  # every operator defined, in order


def define(schema: str, impl: Callable, fake: Callable,
           backward: Optional[Callable] = None,
           setup_context: Optional[Callable] = None):
    """Define ``nirgan::<schema>`` with ``impl`` for the CPU and CUDA keys,
    ``fake`` for tracing and, given ``backward``, its autograd formula:
    ``setup_context(ctx, inputs, output)`` and ``backward(ctx, *grads)``,
    the contract of ``torch.library.register_autograd``.  Returns the
    operator."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    OPERATORS.append(name)
    for key in ("CPU", "CUDA"):
        LIBRARY.impl(name, impl, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIBRARY)
    op = getattr(torch.ops.nirgan, name)
    if backward is not None:
        LIBRARY.impl(name, _autograd_kernel(op.default, impl, backward, setup_context),
                     "Autograd", with_keyset=True)
    return op


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _eager(args) -> bool:
    """Nothing stands between the ``Autograd`` key and the CPU or CUDA
    implementation: no dispatch mode is active (fake tensors, a tracer) and
    every tensor argument is a plain tensor."""
    return torch._C._len_torch_dispatch_stack() == 0 and all(
        type(a) in _PLAIN for a in args if isinstance(a, torch.Tensor))


def _autograd_kernel(op, impl: Callable, backward: Callable,
                     setup_context: Callable) -> Callable:
    """The ``Autograd`` kernel of ``op``: where a gradient is recorded, a
    ``torch.autograd.Function`` whose forward calls ``op`` below autograd
    and whose backward is ``backward``; elsewhere the call below autograd
    alone.  In eager mode (``_eager``) the call below autograd is ``impl``
    itself, the CPU and CUDA keys' implementation, which saves a second
    pass through the dispatcher on the host; under a trace it is
    ``op.redispatch``.  The dispatch key set rides last, so
    ``ctx.needs_input_grad`` lines up with the operator's inputs."""

    def below(keyset, args):
        if _eager(args):
            return impl(*args)
        with torch._C._AutoDispatchBelowAutograd():
            return op.redispatch(keyset & torch._C._after_autograd_keyset, *args)

    class Node(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args_keyset):
            args = args_keyset[:-1]
            out = below(args_keyset[-1], args)
            setup_context(ctx, args, out)
            return out

        @staticmethod
        def backward(ctx, *grads):
            return (*backward(ctx, *grads), None)

    def kernel(keyset, *args):
        if torch._C.is_grad_enabled() and torch._C._any_requires_grad(*args):
            return Node.apply(*args, keyset)
        return below(keyset, args)

    return kernel

