"""Data parallelism over ``torch.distributed``, counterpart of
``nirgan_tpu/parallel/mesh.py``.

The JAX package shards the global batch over a 1-D ``data`` mesh and lets
the compiler insert the gradient all-reduce.  The torch idiom is one
process per card: each process holds the parameters, runs its local slice
of the global batch on its own device, and the collectives are written
out where the JAX program has them implicitly:

  * ``all_reduce_grads``: the mean of a module's gradients over the
    processes, in one flat bucket per dtype, before each optimizer update;
  * ``all_reduce_sum`` (no autograd) for loss terms and masked metric sums,
    ``sum_across`` (autograd sees it: its gradient is summed in turn) for
    the batch norm's statistics, ``all_gather`` (autograd sees it) for
    SatCLIP's global contrastive batch;
  * ``replicate``: the parameters, buffers and optimizer state broadcast
    from process 0, so every process starts equal (the JAX version asks
    the caller for equal values; this one makes them so).

A ``Mesh`` is this process's rank, the world size, its device and the
backend.  A world of one needs no process group: every collective is then
skipped, and the numbers are the single-process ones.  Under a process
group the collectives run even at a world size of one.  The backend comes
from the device (NCCL for ``cuda``, gloo for ``cpu``); ``backend=`` exists
so that two processes can share one card over gloo.  A failed
initialisation raises: there is no fallback to another backend.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, replace
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "all_gather", "all_gather_rows", "all_reduce_grads", "all_reduce_sum", "barrier",
           "broadcast_object", "cli_mesh", "create_mesh", "initialize_multihost",
           "launched_by_torchrun", "pad_batch", "release", "replicate",
           "shard_batch", "sum_across"]

_LAUNCH_HINT = ("run it under torchrun (torchrun --nproc-per-node N -m "
                "nirgan_tpu_torch.<cli> ...), or set NIRGAN_COORDINATOR=host:port, "
                "NIRGAN_NUM_PROCESSES and NIRGAN_PROCESS_ID")


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None
    # whether the CLI that made this mesh joined the process group, and so
    # leaves it at its end (``release``)
    owns_group: bool = False

    @property
    def distributed(self) -> bool:
        """Whether collectives run: a process group exists."""
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def launched_by_torchrun() -> bool:
    """Whether torchrun (or another ``env://`` launcher) started this
    process."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def _device_of(device, local_rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None, device="cuda",
                         backend: Optional[str] = None,
                         local_rank: Optional[int] = None,
                         timeout_s: float = 1800.0) -> None:
    """Join the process group (``jax.distributed.initialize`` for the
    port).  Without arguments the launcher's environment decides: torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (``env://``), or the JAX
    package's ``NIRGAN_COORDINATOR`` / ``NIRGAN_NUM_PROCESSES`` /
    ``NIRGAN_PROCESS_ID``.  The backend is NCCL for a ``cuda`` device and
    gloo for the CPU unless ``backend`` says otherwise; a card process first
    makes ``cuda:LOCAL_RANK`` its current device.  Does nothing if the
    process group exists already."""
    if dist.is_initialized():
        return
    env = os.environ
    if init_method is None:
        coordinator = env.get("NIRGAN_COORDINATOR")
        if coordinator:
            init_method = f"tcp://{coordinator}"
            world_size = int(env["NIRGAN_NUM_PROCESSES"]) if world_size is None else world_size
            rank = int(env["NIRGAN_PROCESS_ID"]) if rank is None else rank
        else:
            init_method = "env://"
            if not launched_by_torchrun():
                raise RuntimeError("a process group needs its launcher's environment "
                                   f"(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): "
                                   + _LAUNCH_HINT)
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(env["RANK"]) if rank is None else int(rank)
    local_rank = int(env.get("LOCAL_RANK", 0)) if local_rank is None else int(local_rank)
    dev = _device_of(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def create_mesh(device="cuda") -> Mesh:
    """This process's mesh: under a process group its rank, the world size
    and the group's backend, on ``cuda:LOCAL_RANK`` where ``device`` names
    no card (or on the CPU when asked); without one, rank 0 of a world of
    one."""
    if not dist.is_initialized():
        return Mesh(0, 1, _device_of(device, 0))
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return Mesh(dist.get_rank(), dist.get_world_size(), _device_of(device, local_rank),
                str(dist.get_backend()))


def cli_mesh(device, mesh_flag: Optional[bool] = None, module: str = "") -> Mesh:
    """The mesh of a CLI.  ``NIRGAN_MULTIHOST=1`` (the JAX package's switch)
    joins the process group from the environment.  A training CLI
    (``mesh_flag`` None) joins it under torchrun too; a serving CLI does
    with ``--mesh`` (``mesh_flag``) under torchrun, and raises with the
    command to use for ``--mesh`` outside torchrun on a machine with more
    than one card (``module``: the CLI's module): one process serves one
    card."""
    device = torch.device(device)
    joins = mesh_flag is None or mesh_flag
    existed = dist.is_initialized()
    if os.environ.get("NIRGAN_MULTIHOST") or (joins and launched_by_torchrun()):
        initialize_multihost(device=device)
    elif mesh_flag and device.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise RuntimeError(f"--mesh serves one card per process: run torchrun "
                           f"--nproc-per-node {n} -m {module} ... --mesh")
    mesh = create_mesh(device)
    return replace(mesh, owns_group=mesh.distributed and not existed)


def release(mesh: Mesh) -> None:
    """Leave the process group if ``cli_mesh`` joined it for this CLI."""
    if mesh.owns_group and dist.is_initialized():
        dist.destroy_process_group()


def pad_batch(batch: dict, quota: int) -> dict:
    """Pad a dict batch's leading dim up to a multiple of ``quota`` by
    repeating the last row, and record the real rows in a ``_valid`` f32
    mask (the JAX package's numpy, ``nirgan_tpu/parallel/mesh.py:57-83``).
    Metric code masks the padded rows out (``calculate_metrics``)."""
    b = next(np.shape(v)[0] for v in batch.values()
             if not isinstance(v, (list, str)))
    target = -(-b // quota) * quota
    if target == b and "_valid" in batch:
        return batch
    mask = np.zeros(target, np.float32)
    mask[:b] = 1.0

    def pad1(x):
        if isinstance(x, (list, str)):
            return x
        x = np.asarray(x)
        if x.shape[0] == target:
            return x
        reps = np.repeat(x[-1:], target - x.shape[0], axis=0)
        return np.concatenate([x, reps], axis=0)

    out = {k: pad1(v) for k, v in batch.items()}
    out["_valid"] = mask
    return out


def shard_batch(mesh: Mesh, batch: dict, pad_uneven: bool = False) -> dict:
    """This process's local batch on its device.  Host arrays become
    tensors on ``mesh.device``; tensors already there pass.  With
    ``pad_uneven`` the rows are padded to a multiple of the local device
    count, which is one here (one process drives one card), so no row is
    added, and the ``_valid`` row mask is attached: the metrics then take
    the masked path, row-weighted sums over the global batch, as the JAX
    trainer's validation does."""
    if pad_uneven:
        rows = next(v.shape[0] for v in batch.values()
                    if isinstance(v, (np.ndarray, torch.Tensor)))
        if "_valid" not in batch:
            batch = {**batch, "_valid": np.ones(rows, np.float32)}

    def put(x):
        if isinstance(x, torch.Tensor):
            return x if x.device == mesh.device else x.to(mesh.device)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)
        return x

    return {k: put(v) for k, v in batch.items()}


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    """Broadcast ``t`` from process 0 in place; a tensor the backend cannot
    move (a CPU tensor under NCCL) goes through a copy on the device."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        tmp = t.to(mesh.device)
        dist.broadcast(tmp, src=0)
        t.copy_(tmp.to(t.device))
    else:
        dist.broadcast(t, src=0)


@torch.no_grad()
def replicate(mesh: Mesh, modules: Iterable[torch.nn.Module] = (),
              optimizers: Iterable[torch.optim.Optimizer] = ()) -> None:
    """Make every process hold process 0's parameters, buffers and
    optimizer state (tensors in place; a process whose optimizer holds no
    state yet takes none)."""
    if not mesh.distributed:
        return
    for module in modules:
        for t in module.state_dict(keep_vars=True).values():
            _broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, mesh)
    for opt in optimizers:
        for state in opt.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    _broadcast_(v, mesh)


@torch.no_grad()
def all_reduce_grads(module: torch.nn.Module, mesh: Mesh) -> None:
    """Replace each parameter's gradient with its mean over the processes:
    one flat bucket per gradient dtype, one all-reduce each."""
    if not mesh.distributed:
        return
    by_dtype: dict = {}
    for p in module.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(mesh.world_size)
        parts = flat.split([g.numel() for g in grads])
        # multi-tensor copies: a few launches, not one a parameter
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])


def all_reduce_sum(values: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The sums over the processes of 0-d or 1-d tensors of one dtype, in
    one collective; outside autograd.  A world without a process group
    returns them as they are."""
    if not mesh.distributed:
        return list(values)
    shapes = [v.shape for v in values]
    flat = torch.cat([v.detach().reshape(-1) for v in values])
    dist.all_reduce(flat)
    out, offset = [], 0
    for shape in shapes:
        n = int(np.prod(shape)) if len(shape) else 1
        out.append(flat[offset:offset + n].reshape(shape))
        offset += n
    return out


class _SumAcross(torch.autograd.Function):
    """All-reduce (sum) whose gradient is the all-reduce (sum) of the
    incoming gradients: each process's loss depends on every process's
    input through the sum."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def sum_across(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the processes, with a gradient that autograd sees;
    ``x`` itself without a process group."""
    if mesh is None or not mesh.distributed:
        return x
    return _SumAcross.apply(x)


class _AllGather(torch.autograd.Function):
    """Concatenation of every process's rows (in rank order); the gradient
    of this process's rows is the sum over the processes of the gradient
    of the gathered rows (an all-reduce, then this process's slice: gloo
    takes that on a card, where it has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, rank, world_size):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world_size)]
        dist.all_gather(parts, x)
        ctx.rank, ctx.rows = rank, x.shape[0]
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def all_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch of ``x`` (B_local, ...) -> (B_local * world, ...),
    in rank order, differentiable; ``x`` itself without a process group.
    Every process must pass the same shape."""
    if mesh is None or not mesh.distributed:
        return x
    return _AllGather.apply(x, mesh.rank, mesh.world_size)


def all_gather_rows(x: torch.Tensor, mesh: Mesh, group=None) -> list:
    """Every process's ``x`` (rows, ...), whose row counts may differ, on
    every process: [x of rank 0, x of rank 1, ...], each padded to the
    longest for the collective and cut back.  NCCL moves them on the card,
    gloo on the host.  ``group``: a process group of ``mesh``'s world (its
    ranks in order), the whole world by default."""
    if not mesh.distributed:
        return [x]
    n = dist.get_world_size(group)
    on = x.device if mesh.backend == "nccl" else torch.device("cpu")
    rows = torch.tensor([x.shape[0]], dtype=torch.int64, device=on)
    counts = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(counts, rows, group=group)
    counts = [int(c.item()) for c in counts]
    buf = torch.zeros((max(max(counts), 1),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=on)
    buf[:x.shape[0]] = x.to(on)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return [p[:k] for p, k in zip(parts, counts)]


def broadcast_object(obj, mesh: Mesh):
    """Process 0's ``obj`` on every process."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier()
