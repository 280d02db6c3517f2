"""Pipeline schedule executors on ``torch.distributed`` point-to-point —
paper §3.4 "Layer" parallelism, three ways (counterpart of
``repro.parallel.schedules.runtime``).

The model is cut into contiguous chunks (``train_step.py``); chunk j runs
on rank j mod p of the stage group. Each rank runs only its own chunks. In
the forward it receives a microbatch's input activation from the rank
before it, runs its chunk and sends the output on; the last chunk turns
its output into that microbatch's share of the loss. In the backward a rank
receives the gradient of its chunk's output, calls
``torch.autograd.backward`` and sends the gradient of the chunk's input
back. The parameters' gradients accumulate over the microbatches.

The reference's executors are forward clockings over ``shard_map``, and
JAX's autodiff runs their backward as the reverse of the forward ticks. In
eager torch the executor runs the backward itself. Each schedule is an
ordered list of actions per rank, ("F" or "B", chunk, microbatch), built by
a pure function of (rank, p, S[, v]):

``gpipe``
    The forward fill/drain of T = S + p − 1 ticks (rank r starts
    microbatch m at tick m + r), then the backwards in reverse. All S
    microbatches' activations are live between the two.

``one_f_one_b``
    The same forward clock, but each microbatch's backward runs as soon as
    the pipe allows: rank r runs p − r − 1 warm-up forwards, then one
    forward and one backward in turn, then the remaining backwards. At most
    p − r microbatches of activations are live on rank r. The reference
    gets that bound by windowed rematerialization and says a real cluster
    schedules the backwards eagerly instead; the port does the latter.

``interleaved``
    Megatron-style virtual stages: v·p chunks, chunk j on rank j mod p,
    microbatches in groups of p. Rank r runs schedule position u (tick
    u + r) as microbatch g·p + i at virtual stage q, with u = i + p·(q + v·g);
    activations go around the ring (rank p − 1 hands chunk q·p + p − 1's
    output to rank 0 for chunk (q + 1)·p). S % p == 0 or it raises. The
    backwards run in the reverse of the forward order, as the reference's
    autodiff runs them: all v·S chunk activations are live in between (the
    oracle prices the p + v − 1 of Megatron's interleaved 1F1B instead).

Transport. Every send is non-blocking (``isend``) and waited at the end of
the step; a rank blocks only on a receive, and each receive is posted one
action ahead (``irecv``), so the transfer overlaps the action before it.
Tags are unique per (microbatch, chunk, direction) within a step, and the
sends between two ranks run in the order the receiver posts them (NCCL
ignores tags and matches by order). Under gloo, CUDA tensors cross through
host buffers, as ``parallel/halo.py``'s ``_Transfer`` does; under nccl they
go device to device. A chunk whose neighbour lives on the same rank
(p = 1, or interleaved's ring on one rank) hands its tensor over directly.
Every transfer is a ``record_function`` span, ``comm.p2p_send`` or
``comm.p2p_recv`` (``launch.profile_train --strategies`` sums them). A
peer that never answers blocks the wait until the process group's timeout,
which raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch.profiler import record_function

SCHEDULE_NAMES = ("gpipe", "one_f_one_b", "interleaved")


@dataclass(frozen=True)
class StageProgram:
    """What the executors run on one rank of the stage group.

    ``run(j, x) -> y``: chunk j on the activation entering it;
    ``first(m)``: microbatch m's input to chunk 0; ``loss(m, y)``: the last
    chunk's output of microbatch m → its scalar share of the batch's loss;
    ``boundary(j)``: (shape, dtype) of a microbatch's activation entering
    chunk j (1 ≤ j < n_chunks), and of its gradient."""
    group: object          # launch.mesh.Group over the stage axis
    n_chunks: int
    run: Callable
    first: Callable
    loss: Callable
    boundary: Callable
    device: torch.device


def gpipe_actions(rank: int, p: int, S: int) -> list[tuple]:
    """Rank ``rank``'s actions under GPipe: every forward, then every
    backward in reverse."""
    fw = [("F", rank, m) for m in range(S)]
    return fw + [("B", rank, m) for _, _, m in reversed(fw)]


def one_f_one_b_actions(rank: int, p: int, S: int) -> list[tuple]:
    """Warm-up forwards, steady one-forward-one-backward, cool-down
    backwards (PipeDream-flush)."""
    warm = min(p - rank - 1, S)
    acts = [("F", rank, m) for m in range(warm)]
    for i in range(S - warm):
        acts += [("F", rank, warm + i), ("B", rank, i)]
    return acts + [("B", rank, m) for m in range(S - warm, S)]


def interleaved_actions(rank: int, p: int, S: int, v: int) -> list[tuple]:
    """The reference's interleaved forward clock on rank ``rank`` (chunks
    q·p + rank), then its backwards in reverse order."""
    fw = []
    for u in range(v * S):
        i, qg = u % p, u // p
        q, g = qg % v, qg // v
        fw.append(("F", q * p + rank, g * p + i))
    return fw + [("B", j, m) for _, j, m in reversed(fw)]


def gpipe(program: StageProgram, n_micro: int) -> list[torch.Tensor]:
    """Runs a GPipe step of ``n_micro`` microbatches over p = the stage
    group's size chunks; returns the loss shares of the microbatches (on
    the rank of the last chunk; empty elsewhere). Gradients accumulate into
    the parameters' ``.grad``."""
    p = program.group.size
    _check_chunks(program, p)
    return _execute(program, gpipe_actions(program.group.index, p, n_micro))


def one_f_one_b(program: StageProgram, n_micro: int) -> list[torch.Tensor]:
    """Runs a 1F1B step (same contract as ``gpipe``)."""
    p = program.group.size
    _check_chunks(program, p)
    return _execute(program, one_f_one_b_actions(program.group.index, p,
                                                 n_micro))


def interleaved(program: StageProgram, n_micro: int,
                virtual_stages: int = 2) -> list[torch.Tensor]:
    """Runs an interleaved step over v·p chunks (same contract as
    ``gpipe``)."""
    p, v = program.group.size, int(virtual_stages)
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    if n_micro % p:
        raise ValueError(
            f"interleaved schedule needs S % p == 0 (microbatch groups of "
            f"p, as in Megatron); got S={n_micro}, p={p}")
    _check_chunks(program, v * p)
    return _execute(program, interleaved_actions(program.group.index, p,
                                                 n_micro, v))


SCHEDULES = {"gpipe": gpipe, "one_f_one_b": one_f_one_b,
             "interleaved": interleaved}


def _check_chunks(program: StageProgram, want: int) -> None:
    if program.n_chunks != want:
        raise ValueError(f"the schedule runs {want} chunks on "
                         f"{program.group.size} ranks; the program has "
                         f"{program.n_chunks}")


def _needs(action, last: int):
    """The transfer an action waits for: ("act", j, m), the activation
    entering chunk j, or ("grad", j, m), its gradient; None for none."""
    kind, j, m = action
    if kind == "F":
        return ("act", j, m) if j > 0 else None
    return ("grad", j + 1, m) if j < last else None


class _Link:
    """The step's point-to-point transfers on one rank."""

    def __init__(self, program: StageProgram):
        g = program.group
        self.program, self.group = program, g
        self.stage = g.stage
        self.sends, self.posted, self.local = [], {}, {}

    def owner(self, j: int) -> int:
        return j % self.group.size

    def tag(self, key) -> int:
        kind, j, m = key
        return 2 * (m * self.program.n_chunks + j) + (kind == "grad")

    def peer(self, key) -> int:
        """The group index of the rank that sends ``key``."""
        kind, j, _ = key
        return self.owner(j - 1) if kind == "act" else self.owner(j)

    def post(self, key) -> None:
        """Posts the receive of ``key`` (a no-op for a local hand-over or
        one already posted)."""
        src = self.peer(key)
        if key in self.posted or src == self.group.index:
            return
        with record_function("comm.p2p_recv"):
            shape, dtype = self.program.boundary(key[1])
            buf = torch.empty(shape, dtype=dtype, device="cpu" if self.stage
                              else self.program.device)
            work = dist.irecv(buf, self.group.ranks[src], group=self.group.pg,
                              tag=self.tag(key))
            self.posted[key] = (work, buf)

    def take(self, key) -> torch.Tensor:
        if self.peer(key) == self.group.index:
            return self.local.pop(key)
        self.post(key)
        with record_function("comm.p2p_recv"):
            work, buf = self.posted.pop(key)
            work.wait()
            return buf.to(self.program.device)

    def send(self, t: torch.Tensor, dst_chunk: int, key) -> None:
        dst = self.owner(dst_chunk)
        if dst == self.group.index:
            self.local[key] = t.detach()
            return
        with record_function("comm.p2p_send"):
            buf = t.detach().cpu() if self.stage else t.detach().contiguous()
            work = dist.isend(buf, self.group.ranks[dst], group=self.group.pg,
                              tag=self.tag(key))
            self.sends.append((work, buf))

    def finish(self) -> None:
        with record_function("comm.p2p_send"):
            for work, _ in self.sends:
                work.wait()
        self.sends = []


def _execute(program: StageProgram, actions: list[tuple]) -> list:
    last = program.n_chunks - 1
    link = _Link(program)
    saved, shares = {}, []
    for k, action in enumerate(actions):
        for a in actions[k:k + 2]:          # this action's and the next's
            key = _needs(a, last)
            if key is not None:
                link.post(key)
        kind, j, m = action
        if kind == "F":
            x = program.first(m) if j == 0 else \
                link.take(("act", j, m)).requires_grad_()
            y = program.run(j, x)
            if j == last:
                y = program.loss(m, y)
                shares.append(y.detach())
            else:
                link.send(y, j + 1, ("act", j + 1, m))
            saved[j, m] = (x, y)
        else:
            x, y = saved.pop((j, m))
            if j == last:
                torch.autograd.backward(y)
            else:
                torch.autograd.backward(y, link.take(("grad", j + 1, m)))
            if j > 0:
                link.send(x.grad, j - 1, ("grad", j, m))
    link.finish()
    return shares
