"""Optimizers: SGD(+momentum) and AdamW (counterpart of
``repro.optim.optimizers``), for the CNNs and the LMs, on one device and
across ranks, with ZeRO-1's sharded state.

State is a dict of fp32 tensors keyed by parameter name (``m``/``v`` for
AdamW, ``mom`` for SGD). Unlike the JAX package's pure update, ``apply_update``
writes the new parameters and state in place: that keeps one copy of each
instead of two. The arithmetic is the reference's: clip to a global norm of
``grad_clip`` first, bias correction with ``count = step + 1``. Each
gradient is scaled to fp32 inside the update loop, one tensor at a time:
the same numbers as the reference's ``clip_by_global_norm``, without an
fp32 copy of every gradient at once (15.8 GB for Qwen1.5-4B's bf16
gradients). Across ranks the norm is over the whole model (``sharded_global_norm``): each parameter's
squares summed over its blocks, and a replicated parameter counted once.

ZeRO-1 (``zero1``, on a mesh; the reference's ``zero1_rules``): the state
of each parameter is placed by the strategy's rules with the logical axes
they leave free mapped onto "data", so it holds a block of the
parameter's block wherever the parameter is replicated over "data". Each
rank updates its block of the state and of the parameter
(``apply_update``, from the whole summed gradient), then the parameter is
all-gathered over "data" (``gather_zero1``): the numbers of the step
without ZeRO-1. The state tensors carry their placement as parameters do
(``place``, ``global_shape``, ``shard_index``), without ZeRO-1 their
parameter's. On one device ``zero1``
changes nothing; unlike the reference's, it is off unless asked for (the
trainer sets it for the ``*_zero1`` tables, as the reference's
``build_cell`` does).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..nn.module import Rules, spec_to_pspec
from ..parallel import collectives as C
from ..parallel.sharded import (Sharded, block_index, local_shape, placement,
                                replicas)


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # "adamw" | "sgd"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9          # sgd
    grad_clip: float = 1.0
    zero1: bool = False


def zero1_rules(rules: Rules) -> Rules:
    """The strategy's rules with the axes it leaves free mapped onto
    "data": the placement of ZeRO-1's optimizer state (the reference's)."""
    extra = {}
    for ax in ("embed", "vocab", "mlp", "heads", "conv_in", "conv_k",
               "layers"):
        if rules.get(ax) is None:
            extra[ax] = "data"
    return rules.merged(extra)


def _zero1_zeros(p: torch.Tensor, ctx) -> torch.Tensor:
    """fp32 zeros: this rank's block of ``p``'s ZeRO-1 state."""
    mesh, shape = ctx.mesh, tuple(getattr(p, "global_shape", p.shape))
    place = placement(mesh, spec_to_pspec(p.axes, zero1_rules(ctx.rules),
                                          mesh, shape))
    own = getattr(p, "place", ((),) * p.dim())
    for dim, (st, pa) in enumerate(zip(place, own)):
        if st != pa and pa:
            raise ValueError(f"the ZeRO-1 state of a parameter placed {own} "
                             f"would be placed {place}: dim {dim} is not a "
                             f"block of the parameter's block")
    t = torch.zeros(local_shape(mesh, shape, place), dtype=torch.float32,
                    device=p.device)
    t.place, t.global_shape, t.shard_index = \
        place, shape, block_index(mesh, shape, place)
    return t


def _zeros_like_block(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros shaped like ``p``'s block, placed as ``p`` is (so a
    checkpoint gathers the whole moment, not this rank's block alone)."""
    t = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if hasattr(p, "place"):
        t.place, t.global_shape, t.shard_index = \
            p.place, p.global_shape, p.shard_index
    return t


def init_state(opt: OptimizerConfig, params: dict[str, torch.Tensor],
               ctx=None) -> dict:
    """fp32 zeros shaped like each parameter (counterpart of
    ``state_spec``); with ``opt.zero1`` on ``ctx``'s mesh, this rank's
    ZeRO-1 blocks of them."""

    def zeros():
        if opt.zero1 and ctx is not None and ctx.sharded:
            return {k: _zero1_zeros(p, ctx) for k, p in params.items()}
        return {k: _zeros_like_block(p) for k, p in params.items()}

    if opt.name == "adamw":
        return {"m": zeros(), "v": zeros()}
    if opt.name == "sgd":
        return {"mom": zeros()}
    raise ValueError(opt.name)


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([g.float().square().sum()
                        for g in grads.values()]).sum().sqrt()


def sharded_global_norm(grads: dict[str, torch.Tensor],
                        params: dict[str, torch.Tensor], mesh) -> torch.Tensor:
    """The whole model's gradient norm from this rank's blocks: each block's
    squares divided by the number of ranks that hold a copy of it, summed
    over the world (every rank gets the same value)."""
    sq = torch.stack([g.float().square().sum()
                      / _copies(params[k], mesh) for k, g in grads.items()])
    return C.all_reduce_sum(sq.sum(), mesh.group(tuple(mesh.shape))).sqrt()


def _copies(p: torch.Tensor, mesh) -> int:
    n = 1
    for a in replicas(p, mesh):
        n *= mesh.shape[a]
    return n


def clip_scale(grads: dict[str, torch.Tensor], max_norm: float,
               norm: torch.Tensor | None = None):
    """(scale, norm): the factor that brings the gradients to a global norm
    of at most ``max_norm`` (``norm``: the global norm where the caller
    computed it across ranks)."""
    norm = global_norm(grads) if norm is None else norm
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm



def _owned(t: torch.Tensor, p: torch.Tensor) -> tuple[slice, ...]:
    """The part of ``p``'s local block whose state block ``t`` is: all of
    it, or under ZeRO-1 the slices of the parameter's block that the
    state's ``shard_index`` covers."""
    idx = getattr(t, "shard_index", None)
    if idx is None:
        return (slice(None),) * p.dim()
    base = getattr(p, "shard_index", (slice(0, None),) * p.dim())
    return tuple(slice(i.start - b.start, i.stop - b.start)
                 for i, b in zip(idx, base))


@torch.no_grad()
def apply_update(opt: OptimizerConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict, step: int,
                 norm: torch.Tensor | None = None) -> dict:
    """Update ``params`` and ``state`` in place; returns the metrics.
    ``norm``: the global gradient norm, where the caller computed it across
    ranks (``sharded_global_norm``). Under ZeRO-1 only the part of each
    parameter whose state this rank holds is updated (``gather_zero1``
    brings the rest)."""
    scale, gnorm = clip_scale(grads, opt.grad_clip, norm)
    count = float(step) + 1.0

    if opt.name == "adamw":
        b1, b2 = opt.b1, opt.b2
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        for k, p in params.items():
            m, v = state["m"][k], state["v"][k]
            own = _owned(m, p)
            g, p = grads[k][own].float() * scale, p[own]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            pf = p.float()
            upd = opt.lr * ((m / c1) / (torch.sqrt(v / c2) + opt.eps)
                            + opt.weight_decay * pf)
            p.copy_(pf - upd)
        return {"grad_norm": gnorm}

    if opt.name == "sgd":
        # in place, one temporary the size of a parameter at a time (the
        # same roundings as mom·β + g·scale and p − lr·mom)
        for k, p in params.items():
            mom = state["mom"][k]
            own = _owned(mom, p)
            mom.mul_(opt.momentum).add_(grads[k][own].float() * scale)
            p = p[own]
            if p.dtype == torch.float32:
                p.sub_(opt.lr * mom)
            else:
                p.copy_(p.float() - opt.lr * mom)
        return {"grad_norm": gnorm}

    raise ValueError(opt.name)


@torch.no_grad()
def gather_zero1(params: dict[str, torch.Tensor], state: dict,
                 mesh) -> None:
    """After a ZeRO-1 update: each parameter all-gathered, in place, from
    the parts of it that the ranks of its state's placement updated."""
    first = next(iter(state.values()))
    for k, p in params.items():
        t = first[k]
        place = getattr(t, "place", None)
        own = getattr(p, "place", ((),) * p.dim())
        if place is None or place == own:
            continue
        part = Sharded(p[_owned(t, p)].contiguous(), t.global_shape, place,
                       mesh)
        p.copy_(part.relayout(own).local)
