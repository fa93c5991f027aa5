"""The process group, and rows moved between the ranks of a mesh axis.

Port of ``iisan_tpu/parallel/distributed.py``.  ``initialize_runtime``
starts ``torch.distributed`` from explicit settings (``cfg.dist_*``) or
from the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``): NCCL when the run's
device is a CUDA card, each rank on the card of its ``LOCAL_RANK``; gloo
only when the caller asks for the CPU.  There is no fallback from one to
the other.  One process that no launcher started stays without a group.

The rest is what the JAX package's global arrays did implicitly:
``owned_rows`` / ``host_shard`` say which rows a rank holds,
``all_gather_rows`` is a differentiable gather (its backward the
reduce-scatter, a sum, of the incoming gradient), ``all_gather_columns``
rebuilds a feature-sharded row, ``all_reduce_grads`` sums gradients as the
JAX package's psum over the batch axis does, and ``broadcast_`` replicates.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Axis, world_rank

log = logging.getLogger("iisan_tpu_torch")

# the single-tensor collectives' newer names, where this torch has them
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process: its rank
    and world size are in the environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, device=None,
                       timeout: Optional[timedelta] = None) -> bool:
    """Start the process group; returns whether one is running.

    ``num_processes`` > 1 with ``coordinator_address`` ("host:port") and
    ``process_id`` starts it from those; otherwise a ``torchrun`` launch
    (even of one process) starts it from the environment; otherwise this
    is a no-op.  ``device`` is the run's device (``resolve_device``: None
    is the card of ``LOCAL_RANK``): a CUDA device takes NCCL, bound to
    that card, and ``"cpu"`` takes gloo.
    """
    if dist.is_initialized():
        return True
    if num_processes is not None and num_processes > 1:
        if not coordinator_address or process_id is None:
            raise ValueError(
                f"dist_num_processes={num_processes} needs dist_coordinator "
                "(host:port) and dist_process_id")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
    elif launched():
        init = dict(init_method="env://")
    else:
        log.info("one process, no process group")
        return False
    device = resolve_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device, **init, **kw)
    elif device.type == "cpu":
        dist.init_process_group("gloo", **init, **kw)
    else:
        raise ValueError(f"no process-group backend for device {device}")
    log.info("process %d/%d on %s (%s)", dist.get_rank(),
             dist.get_world_size(), device, dist.get_backend())
    return True


def shutdown_runtime() -> None:
    """Destroy the process group, where one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main() -> bool:
    """Whether this is the process that writes files (rank 0)."""
    return world_rank()[1] == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def owned_rows(n: int, axis: Axis) -> np.ndarray:
    """Global indices of the rows of an n-row batch that this rank holds on
    ``axis`` (all n where the batch is replicated)."""
    return np.arange(n)[axis.rows(n)]


def host_shard(n: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> np.ndarray:
    """A contiguous shard of n indices per process, padded to equal size by
    repeating the last index; callers crop the repeats before reducing
    (the JAX package's ``host_shard``)."""
    world, rank = world_rank()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    per = -(-n // pc)
    idx = np.arange(pi * per, (pi + 1) * per)
    return np.where(idx < n, idx, n - 1)


def _gather0(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(size * rows, ...): every rank's x stacked in axis order."""
    x = x.contiguous()
    out = x.new_empty((axis.size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x, group=axis.group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather0(x, axis)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // axis.size,) + tuple(grad.shape[1:]))
        _reduce_scatter(out, grad, op=dist.ReduceOp.SUM, group=axis.group)
        return out, None


def all_gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's rows of x along ``axis``, concatenated in axis order.
    Differentiable: the gradient of a rank's rows is the sum over the
    axis of the gradients flowing into them (a reduce-scatter).  Without a
    group, x itself."""
    if axis.group is None:
        return x
    return _AllGatherRows.apply(x, axis)


def all_gather_columns(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A feature-sharded x (..., d / size) -> (..., d), the ranks' columns
    in axis order (not differentiable: the tap tables are constants)."""
    if axis.group is None:
        return x
    parts = _gather0(x.unsqueeze(0), axis)      # (size, ...)
    return torch.cat(parts.unbind(0), dim=-1)


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x summed over ``axis``, in place (x itself without a group)."""
    if axis.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


def all_reduce_grads(params: Iterable[torch.nn.Parameter], axis: Axis) -> None:
    """Sum each parameter's gradient over ``axis`` (one flat buffer per
    dtype and device, then copied back)."""
    if axis.group is None:
        return
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=axis.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with global rank ``src``'s, in place (nothing
    without a process group)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src)


def rank_seed(seed: int, index: int) -> int:
    """The dropout seed of the ``index``-th rank of the data axis: ``seed``
    itself at 0 (a one-rank run draws what an unsharded one does), other
    seeds elsewhere, so no two ranks draw the same masks."""
    return seed if index == 0 else (seed * 1_000_003 + index) % (2 ** 63)
