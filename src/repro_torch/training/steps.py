"""Step functions: ``make_train_step``, ``make_eval_step``,
``make_prefill_step`` and ``make_decode_step`` (counterparts of
``repro.training.steps``).

The train state is ``{"params": {name: Parameter}, "opt": {...}, "step": int}``
(``train_state``, the counterpart of ``train_state_spec``); its parameters are
the model's own, so a step updates the model in place. Gradient accumulation
splits the batch into ``accum`` microbatches, sums their fp32 gradients and
divides by ``accum``, as the reference's ``lax.scan`` does.

Across ranks (``ctx.sharded``) the batch holds ``Sharded`` blocks
(``launch.build.shard_batch``) and the parameters this rank's blocks
(``parallel.sharded.shard_params``). The loss, which all p ranks hold,
seeds its backward with 1/p on each; a parameter replicated over some mesh
axes then has its gradient summed over them (one flat all-reduce per set of
axes), and the clipping norm is the whole model's (see
``parallel/collectives.py`` for why that gives every rank the true
gradient of its blocks). Microbatch i is rows [i·B/accum, (i+1)·B/accum) of
the whole batch, as in the reference, gathered and split anew. Under
ZeRO-1 (``opt.zero1``; ``train_state`` given the ctx places the state)
each rank updates its block and the parameters are all-gathered after the
update (``optim.optimizers.gather_zero1``). On the 2-D grid of the "summa"
table (``parallel/summa.py``) only an LM of attention blocks trains; a CNN
or an SSM model raises.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..nn.module import ShardingCtx
from ..optim.optimizers import (OptimizerConfig, apply_update,
                                gather_zero1, init_state,
                                sharded_global_norm)
from ..parallel import collectives as C
from ..parallel.sharded import Sharded, replicas
from ..parallel.summa import summa_axes, summa_supported


def train_state(model: torch.nn.Module, opt: OptimizerConfig,
                ctx: ShardingCtx | None = None) -> dict:
    """The model's parameters, the optimizer's zeros (ZeRO-1's blocks with
    ``opt.zero1`` on ``ctx``'s mesh) and step 0."""
    params = dict(model.named_parameters())
    return {"params": params, "opt": init_state(opt, params, ctx),
            "step": 0}


def make_train_step(model, opt: OptimizerConfig, ctx: ShardingCtx,
                    accum: int = 1, **fwd_kw) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""
    if summa_axes(ctx) is not None and summa_supported(model) is not None:
        raise NotImplementedError(summa_supported(model))

    seed = 1.0 / ctx.mesh.size if ctx.sharded else 1.0

    def grads_of(params, batch):
        loss, metrics = model.loss_fn(batch, ctx, **fwd_kw)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    torch.full_like(loss, seed))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum:
                raise ValueError(f"batch {n} does not split into {accum} "
                                 f"microbatches")
            mb = n // accum
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for k, p in params.items()}
            losses, ms = [], []
            for i in range(accum):
                l, m, g = grads_of(params, {k: _rows(v, i * mb, mb)
                                            for k, v in batch.items()})
                for k in grads:
                    grads[k] += g[k].float()
                losses.append(l)
                ms.append(m)
            grads = {k: g / accum for k, g in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        norm = None
        if ctx.sharded:
            grads = sum_replicas(grads, params, ctx.mesh)
            norm = sharded_global_norm(grads, params, ctx.mesh)
        om = apply_update(opt, params, grads, state["opt"], state["step"],
                          norm)
        if opt.zero1 and ctx.sharded:
            gather_zero1(params, state["opt"], ctx.mesh)
        state["step"] += 1
        return state, dict(metrics, loss=loss, **om)

    return train_step


def _rows(v, start: int, n: int):
    """Rows [start, start + n) of a batch leaf (a ``Sharded`` one gathered
    whole on its batch dim, cut, and split again as it was)."""
    if not isinstance(v, Sharded):
        return v[start:start + n]
    whole = v.relayout(((),) + v.place[1:])
    part = Sharded(whole.local[start:start + n], (n,) + v.shape[1:],
                   whole.place, v.mesh)
    return part.relayout(v.place)


# elements a bucket of small gradients holds (a larger gradient is
# all-reduced alone, in place)
BUCKET = 1 << 24


@torch.no_grad()
def sum_replicas(grads: dict, params: dict, mesh) -> dict:
    """Each gradient summed over the mesh axes its parameter is replicated
    on, in place: per set of axes (and dtype), the small gradients
    flattened into buckets of up to BUCKET elements, one all-reduce a
    bucket, and each larger one all-reduced alone (so the step holds one
    bucket more than its gradients, not a second copy of them)."""
    by_axes: dict[tuple, list[str]] = {}
    for k, p in params.items():
        by_axes.setdefault((replicas(p, mesh), grads[k].dtype), []).append(k)
    for (axes, _), keys in by_axes.items():
        if not axes:
            continue
        group = mesh.group(axes)
        bucket: list[str] = []
        for i, k in enumerate(keys):
            if grads[k].numel() >= BUCKET and grads[k].is_contiguous():
                C.all_reduce_(grads[k], group)
                continue
            bucket.append(k)
            n = sum(grads[b].numel() for b in bucket)
            if n >= BUCKET or i == len(keys) - 1:
                _reduce_bucket([grads[b] for b in bucket], group)
                bucket = []
        if bucket:
            _reduce_bucket([grads[b] for b in bucket], group)
    return grads


def _reduce_bucket(ts: list[torch.Tensor], group) -> None:
    flat = torch.cat([t.reshape(-1) for t in ts])
    C.all_reduce_(flat, group)
    for t, part in zip(ts, flat.split([t.numel() for t in ts])):
        t.copy_(part.view_as(t))


def make_eval_step(model, ctx: ShardingCtx, **fwd_kw) -> Callable:
    """Returns eval_step(batch) -> metrics, with the loss and the model's
    outputs (the logits). Runs without autograd, so ``use_pallas`` sites can
    use the forward-only kernel."""

    @torch.no_grad()
    def eval_step(batch):
        out = model(batch["images"], ctx, **fwd_kw)
        loss, metrics = model.loss(out, batch)
        return dict(metrics, loss=loss, outputs=out)

    return eval_step


def make_prefill_step(model, ctx: ShardingCtx, **kw) -> Callable:
    """Returns prefill_step(batch, cache) -> (last-position logits, cache);
    ``batch["tokens"]`` holds the prompts. The cache is filled in place (the
    reference asks its callers to donate it for the same reason). Runs
    without autograd, so ``use_pallas`` sites can use the forward-only
    kernels."""

    @torch.no_grad()
    def prefill_step(batch, cache):
        return model.prefill(batch["tokens"], cache, ctx, **kw)

    return prefill_step


def make_decode_step(model, ctx: ShardingCtx, **kw) -> Callable:
    """Returns decode_step(token, cache, pos) -> (logits, cache): one new
    token per sequence at position ``pos``, the cache updated in place."""

    @torch.no_grad()
    def decode_step(token, cache, pos):
        return model.decode_step(token, cache, pos, ctx, **kw)

    return decode_step
