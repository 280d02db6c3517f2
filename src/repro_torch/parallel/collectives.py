"""Collectives over a mesh group that autograd differentiates (port-only: in
the reference GSPMD inserts them).

One convention holds everywhere, so no call site chooses a backward: the
true gradient of a value is the SUM of the local gradients of all its
copies. Under it each collective's backward is its exact adjoint:

=================  ===========================  ==========================
collective         forward                      backward (its adjoint)
=================  ===========================  ==========================
``all_gather``     blocks → the whole, on all   reduce-scatter (sum)
``split``          the whole → this rank's      zero-pad into the whole
                   block (no communication)
``all_reduce``     partial sums → their sum     all-reduce (sum)
=================  ===========================  ==========================

and the halo exchange's backward sends the received rows' gradients back to
their owners (``parallel/halo.py``). ``ring_shift`` (one hop around a
group's ring, no autograd) is the SUMMA matmul's panel broadcast; its
autograd function (``parallel/summa.py``) runs the reversed ring, the
adjoint, in its backward. A scalar loss that all p ranks hold
seeds its backward with 1/p on each (``training.steps``), and a parameter
replicated over a group has its gradient summed over that group after the
backward. By the chain rule on the ranks' stacked computation, every rank
then holds the true gradient of its own block, whatever is computed
redundantly or in parts in between (``tests/test_torch_parallel_*.py`` hold
the gradients against the unsharded step's). The Megatron pair (identity
backward for an all-reduce followed by redundant compute, a slice for an
all-gather so followed) moves fewer bytes but needs that choice at every
site; a wrong one scales gradients by p.

Transport: under gloo, CUDA tensors pass ``all_reduce`` as they are (gloo
takes them there) and cross every other collective through host buffers
(``Group.stage``). On the ``meta`` device a collective only gives its
result's shape (``scripts/lm_train_memory.py`` reckons a sharded step's
memory that way, with no ranks). The groups come from ``launch.mesh.Mesh.group``. Each
transfer is a ``record_function`` span named ``comm.<collective>``, which
``launch.profile_train --strategies`` sums, and adds one to ``STATS["calls"]``
and its host seconds to ``STATS["seconds"]`` (the serving phase of
``chip_smoke.py`` reads both per engine cell).
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.profiler import record_function

# every collective this process ran: how many, and the host seconds inside
STATS = {"calls": 0, "seconds": 0.0}


@contextmanager
def _span(name: str):
    t0 = time.perf_counter()
    with record_function(name):
        yield
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0


def _host(x: torch.Tensor, stage: bool) -> torch.Tensor:
    return x.cpu().contiguous() if stage else x.contiguous()


def gather_blocks(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of all ranks of ``group`` along ``dim``, in group order
    (no autograd)."""
    if x.is_meta:
        return torch.cat([x] * group.size, dim)
    with _span("comm.all_gather"):
        src = _host(x, group.stage)
        parts = [torch.empty_like(src) for _ in range(group.size)]
        dist.all_gather(parts, src, group=group.pg)
        return torch.cat(parts, dim).to(x.device)


def reduce_scatter_blocks(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` (no
    autograd)."""
    if x.is_meta:
        return x.chunk(group.size, dim)[0].contiguous()
    with _span("comm.reduce_scatter"):
        src = _host(x, group.stage)
        parts = [c.contiguous() for c in src.chunk(group.size, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group.pg)
        return out.to(x.device)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` in a new tensor (no autograd)."""
    y = x.clone(memory_format=torch.contiguous_format)
    if not y.is_meta:
        with _span("comm.all_reduce"):
            dist.all_reduce(y, group=group.pg)
    return y


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place (no autograd); ``x`` must be
    contiguous."""
    if not x.is_meta:
        with _span("comm.all_reduce"):
            dist.all_reduce(x, group=group.pg)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` in a new tensor (no autograd)."""
    y = x.clone(memory_format=torch.contiguous_format)
    if not y.is_meta:
        with _span("comm.all_reduce_max"):
            dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group.pg)
    return y


def broadcast_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` overwritten, in place, by the first rank of ``group``'s (no
    autograd); ``x`` must be contiguous."""
    with _span("comm.broadcast"):
        dist.broadcast(x, group.ranks[0], group=group.pg)
    return x


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` sent ``shift`` places on around ``group``'s ring (to the rank
    of index + shift), and the tensor of the rank ``shift`` places back
    received in exchange (no autograd)."""
    n = group.size
    if x.is_meta or n == 1 or shift % n == 0:
        return x
    with _span("comm.ring_shift"):
        send = _host(x, group.stage)
        recv = torch.empty_like(send)
        i = group.index
        # one batch: NCCL would hold plain sends each waiting for the next
        # rank's receive
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, group.ranks[(i + shift) % n],
                           group.pg),
                dist.P2POp(dist.irecv, recv, group.ranks[(i - shift) % n],
                           group.pg)]):
            w.wait()
        return recv.to(x.device)


def block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (no autograd)."""
    if x.shape[dim] % group.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {group.size} blocks")
    return x.chunk(group.size, dim)[group.index].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_blocks(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.shape = dim, group, x.shape
        return block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.chunk(ctx.group.size, ctx.dim)[ctx.group.index].copy_(g)
        return out, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group.size == 1 else _AllGather.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group.size == 1 else _Split.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group.size == 1 else _AllReduce.apply(x, group)
