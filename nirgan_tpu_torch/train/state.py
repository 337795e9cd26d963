"""The train state, counterpart of ``nirgan_tpu/train/state.py``: the step
counter, the two optimizers over the task's networks (reference
``model/pix2pix.py:485-492``) and the dropout's random stream.

Adam(lr, betas=(beta1, 0.999), eps=1e-8) is the math of the JAX package's
``optax.scale_by_adam`` scaled by the live LR.  On f32 parameters (the
shipped configs' ``tpu.param_dtype``) it is ``torch.optim.Adam``; on bf16 or
f16 parameters ``OptaxAdam``, which rounds as the JAX step does, where
``torch.optim.Adam`` would round otherwise, and keeps the same state names.
The learning rates live in the optimizers' param groups, where the
host-side plateau schedulers rewrite them between steps.  The batch norms'
running statistics, which the JAX state carries as
``stats_g`` / ``stats_d``, live in the networks' buffers (f32 whatever the
parameters' dtype, as flax keeps them); the JAX state's ``rng``, split each
step for the dropout, is a ``torch.Generator`` on the task's device whose
state moves on with each draw.  A task without a discriminator (the
baselines) has no ``opt_d``: its ``lr_d`` is ``lr_g``, as the JAX baseline
state keeps one to give the trainer the same surface.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["TrainState", "OptaxAdam", "adam_for", "cast_params", "check_finite",
           "param_dtype_of"]

PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def param_dtype_of(tpu) -> torch.dtype:
    """``tpu.param_dtype`` as a torch dtype: what the JAX package's
    ``dtype_of`` takes (float32, bfloat16, float16); any other name
    raises."""
    name = str(tpu.get("param_dtype", "float32"))
    if name not in PARAM_DTYPES:
        raise ValueError(f"tpu.param_dtype: {name!r} is none of "
                         f"{sorted(PARAM_DTYPES)}")
    return PARAM_DTYPES[name]


def cast_params(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Every parameter of ``module`` in ``dtype``, its buffers (the batch
    norms' running statistics) as they are: each flax layer makes its
    parameters in ``param_dtype`` and its statistics in f32."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dtype != dtype:
                p.data = p.data.to(dtype)
    return module


class OptaxAdam(torch.optim.Optimizer):
    """``optax.chain(scale_by_adam(b1, b2, eps), scale(-1))`` followed by the
    JAX step's ``p + lr * u`` (``nirgan_tpu/train/state.py:34-38``,
    ``tasks/px2px.py:302-305,341-344``), dtype for dtype, for parameters
    made in bf16 or f16:

        mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu
        u  = -(mu / bc1) / (sqrt(nu / bc2) + eps),  bc = 1 - b^count (f32)
        p  = p + lr u

    Each product of a constant rounds in its operand's dtype (JAX's weakly
    typed Python scalars take the array's dtype: 0.999 is 1.0 in bf16), a
    sum of two dtypes in the wider, and the learning rate is an f32 array in
    the JAX state, so ``lr u`` and the new parameter are f32: the first
    update turns a bf16 parameter into an f32 one, and the moments follow at
    the second, as in the JAX step.  A parameter whose dtype changes keeps
    its object and has its version counter raised, so the kept layouts and
    int8 packs see the write.  The state of a parameter is
    ``torch.optim.Adam``'s: ``step`` (the count, a 0-d f32 tensor on the
    host), ``exp_avg`` (mu) and ``exp_avg_sq`` (nu)."""

    def __init__(self, params, lr: float, betas=(0.5, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr = _f32(group["lr"])
            # one set of multi-tensor ops for each run of parameters that
            # share their dtypes and update count (a network's parameters
            # are one run, apart from a dtype it was given by hand)
            runs: dict = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                st["step"] = st["step"] + 1  # a new tensor: a loaded state may share it
                key = (p.dtype, p.grad.dtype, st["exp_avg"].dtype, st["exp_avg_sq"].dtype,
                       int(st["step"]))
                runs.setdefault(key, []).append(p)
            for (_, g_dtype, mu_dtype, nu_dtype, count), ps in runs.items():
                sts = [self.state[p] for p in ps]
                gs = [p.grad for p in ps]
                mu = _sum(torch._foreach_mul(gs, _in(1.0 - b1, g_dtype)),
                          torch._foreach_mul([st["exp_avg"] for st in sts],
                                             _in(b1, mu_dtype)))
                nu = _sum(torch._foreach_mul(torch._foreach_mul(gs, gs), _in(1.0 - b2, g_dtype)),
                          torch._foreach_mul([st["exp_avg_sq"] for st in sts],
                                             _in(b2, nu_dtype)))
                bc1 = _in(_f32(1.0 - _f32(b1) ** count), mu[0].dtype)
                bc2 = _in(_f32(1.0 - _f32(b2) ** count), nu[0].dtype)
                den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
                torch._foreach_add_(den, _in(group["eps"], nu[0].dtype))
                u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
                step = torch._foreach_mul([t.float() for t in u], -lr)
                if ps[0].dtype == torch.float32:
                    torch._foreach_add_(ps, step)
                else:
                    for p, new in zip(ps, torch._foreach_add([p.float() for p in ps], step)):
                        p.data = torch.empty_like(new)
                        p.copy_(new)
                for st, m, n in zip(sts, mu, nu):
                    st["exp_avg"], st["exp_avg_sq"] = m, n
        return None

    def load_state_dict(self, state_dict: dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, which casts each
        moment to its parameter's dtype, then the moments given back their
        saved dtype: after the first update of a bf16 parameter the
        parameter is f32 and its moments still bf16, as in the JAX step."""
        super().load_state_dict(state_dict)
        ids = [i for group in state_dict["param_groups"] for i in group["params"]]
        params = [p for group in self.param_groups for p in group["params"]]
        for i, p in zip(ids, params):
            saved = state_dict["state"].get(i)
            for key in ("exp_avg", "exp_avg_sq") if saved else ():
                self.state[p][key] = saved[key].to(p.device, copy=True)


def _f32(x: float) -> float:
    """x rounded to f32."""
    return float(torch.tensor(x, dtype=torch.float32))


def _in(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype`` (a Python scalar that JAX casts to an array's
    dtype)."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def _sum(a: list, b: list) -> list:
    """a + b elementwise, each pair in the wider of its two dtypes (both
    widened first, which is exact), as JAX adds a bf16 and an f32 array."""
    dtype = torch.promote_types(a[0].dtype, b[0].dtype)
    return torch._foreach_add([t.to(dtype) for t in a], [t.to(dtype) for t in b])


def check_finite(tag: str, loss: torch.Tensor, module: torch.nn.Module) -> None:
    """``tpu.debug_nans``: raise ``FloatingPointError`` on a non-finite loss
    or parameter gradient of ``module`` (the JAX trainer turns on
    ``jax_debug_nans``, which raises on the first NaN an op makes).  Waits
    for the card, so only the debugging key turns it on."""
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"debug_nans: {tag} loss is {float(loss)}")
    for name, p in module.named_parameters():
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(f"debug_nans: {tag} gradient of {name} is "
                                     "not finite")


def adam_for(module: torch.nn.Module, lr: float,
             beta1: float = 0.5) -> torch.optim.Optimizer:
    """Adam over ``module``'s parameters: ``torch.optim.Adam`` where they
    are all f32 (its update of the full-width G and D takes 0.80 ms on an
    H100 against ``OptaxAdam``'s 2.58, ``chip_smoke.py``), else
    ``OptaxAdam``."""
    params = list(module.parameters())
    if all(p.dtype == torch.float32 for p in params):
        return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8)
    return OptaxAdam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8)


@dataclass
class TrainState:
    """Completed train steps, the G and D optimizers and the dropout's
    generator; the parameters themselves are the task's ``netG`` and
    ``netD``."""

    step: int
    opt_g: torch.optim.Optimizer
    opt_d: Optional[torch.optim.Optimizer] = None
    rng: Optional[torch.Generator] = None

    @property
    def lr_g(self) -> float:
        return float(self.opt_g.param_groups[0]["lr"])

    @property
    def lr_d(self) -> float:
        opt = self.opt_d if self.opt_d is not None else self.opt_g
        return float(opt.param_groups[0]["lr"])

    def set_lr(self, lr_g: float, lr_d: float) -> None:
        for opt, lr in ((self.opt_g, lr_g), (self.opt_d, lr_d)):
            for group in (opt.param_groups if opt is not None else ()):
                group["lr"] = float(lr)

