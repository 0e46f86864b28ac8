"""Data-parallel runtime on ``torch.distributed`` (port of the JAX
package's ``parallel/mesh.py``).

The JAX package jits one step over a global batch sharded on a 1-D data
mesh: BatchNorm statistics, triplet mining and the loss-side banks see the
whole global batch, and one optimizer step follows the gradient of one
global loss. The port runs one process per GPU (NCCL on the card, gloo on
the CPU) and keeps those semantics: each rank encodes its own rows, the
embeddings are gathered into the global batch in global order, every rank
computes the same global loss, and the parameter gradients are summed
across ranks (each rank holds only its own rows' share of the gradient of
that one loss, so a mean would be a factor W off). BatchNorm's train-mode
statistics are all-reduced in ``models/layers.py``.

Every collective here is built on ``all_reduce`` and ``broadcast`` only:
torch.distributed's gloo backend offers just those two on CUDA tensors,
and NCCL refuses two ranks on one GPU, so these are what let two gloo
ranks share one card. With no process group up every helper is the
identity and ``get_world_size()`` is 1.
"""

from __future__ import annotations

import math
import os
import socket
from datetime import timedelta
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.profiling import span

# rendezvous and collective timeout: a rank that dies must not leave the
# others blocked forever
DEFAULT_TIMEOUT = timedelta(seconds=1800)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def is_active() -> bool:
    """True when a process group is up (at any world size, 1 included)."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_active() else 0


def get_world_size() -> int:
    """The number of ranks, one per GPU (the JAX ``get_world_size`` counts
    devices; here each process drives one); 1 with no group up."""
    return dist.get_world_size() if is_active() else 1


def is_master_proc() -> bool:
    """Rank 0, or no group up (reference misc/distributed_helper.py:68-73)."""
    return get_rank() == 0


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: Optional[str] = None,
                           timeout: Optional[timedelta] = None) -> None:
    """Join the process group (reference run_process,
    misc/distributed_helper.py:8-26). ``backend``: ``nccl`` when CUDA is
    available, else ``gloo``; an NCCL caller selects its card first
    (``torch.cuda.set_device``). ``init_method``: ``tcp://host:port`` or
    ``env://``. A rendezvous that fails or does not complete within
    ``timeout`` (default ``DEFAULT_TIMEOUT``) raises ``RuntimeError``:
    nothing falls back to training alone."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = timeout or DEFAULT_TIMEOUT
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside world size {world_size}")
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    except (RuntimeError, ValueError) as e:  # DistError is a RuntimeError
        raise RuntimeError(
            f"torch.distributed rendezvous at {init_method} failed for rank "
            f"{rank} of {world_size} ({backend}, timeout "
            f"{timeout.total_seconds():.0f} s): {e}") from e


def maybe_auto_initialize(backend: Optional[str] = None,
                          timeout: Optional[timedelta] = None) -> bool:
    """Join the group that torchrun describes in the environment (the
    counterpart of reading a TPU slice's topology, the JAX
    ``maybe_auto_initialize``) -> whether a group is up. No-op without
    torchrun's variables or at ``WORLD_SIZE`` 1. A partial environment
    raises: it would otherwise run one isolated copy of the job per
    process."""
    env = os.environ
    if not any(k in env for k in ("RANK", "WORLD_SIZE")):
        return is_active()
    missing = [k for k in TORCHRUN_ENV if not env.get(k)]
    if missing:
        raise RuntimeError(f"torchrun environment incomplete: {missing} "
                           "unset; launch with torchrun or pass "
                           "--num_shards/--shard_id/--ip_address_port")
    if is_active():
        return True
    world = int(env["WORLD_SIZE"])
    if world <= 1:
        return False
    initialize_distributed("env://", world, int(env["RANK"]), backend,
                           timeout)
    return True


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK`` (0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def check_mesh_shape(mesh_shape: Sequence[int], world: int) -> None:
    """``TPU.MESH_SHAPE`` lays devices out on a TPU and has no GPU
    counterpart: the port runs a 1-D data-parallel group. A shape is
    accepted only as the 1-D mesh it describes, whose size must be the
    world size."""
    dims = [int(d) for d in (mesh_shape or [])]
    n = math.prod(dims)
    if dims and n != world:
        raise ValueError(
            f"TPU.MESH_SHAPE {dims} has {n} devices but the world size is "
            f"{world}: the mesh shape is a TPU layout with no GPU "
            "counterpart; the port runs one data-parallel rank per GPU, so "
            "leave it empty or give a shape whose product is the world size")


def _all_reduce_(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor."""
    dist.all_reduce(x, op=op)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; backward sums the ranks' gradients of the sum, each
    of which must be that rank's share of the global loss's gradient."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over ranks (``x`` itself with no
    group up).

    The gradient contract is the opposite of ``gather_rows``'s: the
    gradient reaching the sum on each rank must be that rank's own share
    of the gradient of the global loss, which is the sum of the ranks'
    shares. So it serves statistics that each rank's rows go on to use,
    as in ``SubBatchNorm``: downstream of ``gather_rows`` each rank's rows
    receive only their share. A loss that every rank computes alike from
    the sum would come out W times too large after ``sum_gradients``."""
    if not is_active():
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x)
    return _all_reduce_(x.contiguous().clone())


class _GatherRows(torch.autograd.Function):
    """All-gather of rows on ``all_reduce``: each rank writes its rows into
    its own slot of a zero-filled (W n, ...) buffer and the buffers are
    summed, which is exact (x + 0 = x). Every rank then computes the same
    global loss from the gathered rows, so the gradient reaching the
    buffer is already the global one on every rank: backward keeps this
    rank's slice of it, and the parameter gradients are summed across
    ranks (``sum_gradients``)."""

    @staticmethod
    def forward(ctx, x):
        rank, world = get_rank(), get_world_size()
        n = x.shape[0]
        buf = x.new_zeros((world * n,) + tuple(x.shape[1:]))
        buf[rank * n:(rank + 1) * n] = x
        ctx.rows = (rank * n, (rank + 1) * n)
        return _all_reduce_(buf)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) on every rank -> (W n, ...) in rank order, with the
    gradient flowing back to this rank's rows (``x`` itself with no group
    up). Every rank must pass the same n."""
    if not is_active():
        return x
    return _GatherRows.apply(x)


def gather_parts(x: torch.Tensor, parts: int = 1) -> torch.Tensor:
    """Gather rows laid out in ``parts`` equal consecutive parts on each
    rank ([a_r; p_r; e_r] for the triplet views, [anchor targets;
    positive targets] for the targets) into the global layout
    [a_0 .. a_{W-1}; p_0 .. p_{W-1}; e_0 ..], the batch that the JAX
    package's single-process step sees."""
    if not is_active():
        return x
    g = gather_rows(x)
    world = get_world_size()
    rest = tuple(g.shape[1:])
    return (g.reshape((world, parts, -1) + rest).transpose(0, 1)
            .reshape((-1,) + rest))


def sum_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """All-reduce (sum) the parameters' gradients in place, one flat
    buffer per dtype (span ``dist.sum_gradients``). A no-op with no group
    up."""
    if not is_active():
        return
    with span("dist.sum_gradients"):
        by_dtype = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault((p.grad.dtype, p.grad.device),
                                    []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            _all_reduce_(flat)
            offset = 0
            for g in grads:
                n = g.numel()
                g.copy_(flat[offset:offset + n].view(g.shape))
                offset += n


def agree(value: float) -> bool:
    """True when every rank passes the same number (an all-reduce of
    [v, -v] with MAX); True with no group up."""
    if not is_active():
        return True
    t = torch.tensor([value, -value], dtype=torch.float64,
                     device=collective_device())
    _all_reduce_(t, op=dist.ReduceOp.MAX)
    return float(t[0]) == -float(t[1])


def collective_device() -> torch.device:
    """Where small bookkeeping tensors go for a collective: the current
    CUDA device under NCCL (which takes CUDA tensors only), else the CPU."""
    if is_active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank, in place."""
    if not is_active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_contiguous():
                dist.broadcast(t, src)
            else:
                c = t.contiguous()
                dist.broadcast(c, src)
                t.copy_(c)


def free_port() -> int:
    """A TCP port on localhost that is free now, for a ``tcp://``
    rendezvous of ranks on one host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def destroy() -> None:
    """Leave the process group, if one is up."""
    if is_active():
        dist.destroy_process_group()
