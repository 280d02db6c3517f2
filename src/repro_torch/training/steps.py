"""Step functions: ``make_train_step``, ``make_eval_step``,
``make_prefill_step`` and ``make_decode_step`` (counterparts of
``repro.training.steps``).

The train state is ``{"params": {name: Parameter}, "opt": {...}, "step": int}``
(``train_state``, the counterpart of ``train_state_spec``); its parameters are
the model's own, so a step updates the model in place. Gradient accumulation
splits the batch into ``accum`` microbatches, sums their fp32 gradients and
divides by ``accum``, as the reference's ``lax.scan`` does.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig, apply_update, init_state


def train_state(model: torch.nn.Module, opt: OptimizerConfig) -> dict:
    params = dict(model.named_parameters())
    return {"params": params, "opt": init_state(opt, params), "step": 0}


def make_train_step(model, opt: OptimizerConfig, ctx: ShardingCtx,
                    accum: int = 1, **fwd_kw) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""

    def grads_of(params, batch):
        loss, metrics = model.loss_fn(batch, ctx, **fwd_kw)
        grads = torch.autograd.grad(loss, list(params.values()))
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
                l, m, g = grads_of(params, {k: v[i * mb:(i + 1) * mb]
                                            for k, v in batch.items()})
                for k in grads:
                    grads[k] += g[k].float()
                losses.append(l)
                ms.append(m)
            grads = {k: g / accum for k, g in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        om = apply_update(opt, params, grads, state["opt"], state["step"])
        state["step"] += 1
        return state, dict(metrics, loss=loss, **om)

    return train_step


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
