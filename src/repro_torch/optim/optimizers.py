"""Optimizers: SGD(+momentum) and AdamW (counterpart of
``repro.optim.optimizers``), for the CNNs and the LMs, on one device and
across ranks; ZeRO-1 state sharding is not ported yet (ROADMAP queue 1
item 6).

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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..parallel import collectives as C
from ..parallel.sharded import replicas


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


def init_state(opt: OptimizerConfig, params: dict[str, torch.Tensor]) -> dict:
    """fp32 zeros shaped like each parameter (counterpart of ``state_spec``)."""

    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

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



@torch.no_grad()
def apply_update(opt: OptimizerConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict, step: int,
                 norm: torch.Tensor | None = None) -> dict:
    """Update ``params`` and ``state`` in place; returns the metrics.
    ``norm``: the global gradient norm, where the caller computed it across
    ranks (``sharded_global_norm``)."""
    scale, gnorm = clip_scale(grads, opt.grad_clip, norm)
    count = float(step) + 1.0

    if opt.name == "adamw":
        b1, b2 = opt.b1, opt.b2
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        for k, p in params.items():
            g, m, v = grads[k].float() * scale, state["m"][k], state["v"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            pf = p.float()
            upd = opt.lr * ((m / c1) / (torch.sqrt(v / c2) + opt.eps)
                            + opt.weight_decay * pf)
            p.copy_(pf - upd)
        return {"grad_norm": gnorm}

    if opt.name == "sgd":
        for k, p in params.items():
            mom = state["mom"][k]
            mom.copy_(opt.momentum * mom + grads[k].float() * scale)
            p.copy_(p.float() - opt.lr * mom)
        return {"grad_norm": gnorm}

    raise ValueError(opt.name)
