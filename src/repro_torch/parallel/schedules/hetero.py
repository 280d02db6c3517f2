"""The paper's CNNs and the LMs cut into pipeline blocks (counterpart of
``repro.parallel.schedules.hetero``).

A CNN trunk has no uniform stacked layout: its blocks differ in parameters
and in activation shape (spatial downsampling). So each model's pipeline
blocks are the blocks its forward is made of (``ordered_blocks()`` in
``models/cnn.py``), stem through head: ResNet's stem (conv, BatchNorm,
ReLU, max-pool), its bottlenecks and its head (global average pool,
dense); VGG16's 13 convs (each with its ReLU and the max-pool behind it)
and its three dense layers as one block; CosmoFlow's conv blocks (conv,
leaky ReLU, max-pool) and its three dense layers as one block. This module
adds the context they run under, their costs and their parameter names.

Each block runs under ``ShardingCtx(device)`` with no mesh, the counterpart
of the reference's ``NULL_CTX``: the layers take their single-device path
on the microbatch the stage holds. A stage run under the mesh's context
would all-reduce BatchNorm statistics over stage ranks that are not at that
layer. So BatchNorm takes per-microbatch statistics, as in the reference.

The reference ships activations between stages as one flat, zero-padded
buffer of the largest boundary width (``make_switch_stage_fns``,
``to_buffer``, ``from_buffer``), because ``lax.switch`` under ``shard_map``
needs one carrier shape for every rank. Eager torch has no such constraint:
each stage knows its boundary shape (``boundary_shapes``), so the executor
(``runtime.py``) sends tensors of the exact shape. The values are the same;
the padding is not sent.

An LM's blocks are its layers, one ``PipeBlock`` a layer named
``L{j}.{kind}`` (``_lm_layer_blocks``), each running ``Block.forward``
under the same mesh-free context, as the reference's run under
``NULL_CTX``; its costs come from the oracle's per-layer stats
(``stages.block_costs_from_stats``). A uniform pattern and a mixed one
(``("ssm", "attn")``, its remainder layers included) cut the same way:
eager torch needs neither the reference's stacked layouts for the one
nor its switch-specialised programs for the other. The embedding, the
final norm and the head are not blocks: the train step runs them on the
first and the last stage. Every boundary is a (microbatch, seq, d_model)
activation in the model's dtype.

A block also names the parameters it reads (``PipeBlock.params``), which
is how the train step knows the blocks each rank owns.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from ...models.cnn import CNN_MODELS
from ...models.transformer import LMConfig, TransformerLM
from ...nn.module import ShardingCtx
from .stages import block_costs_from_stats


@dataclass(frozen=True)
class PipeBlock:
    """One schedulable unit of a trunk.

    ``apply(x) -> y`` maps a batched activation through the block; ``cost``
    is the fw+bw FLOP weight the partitioner cuts on; ``params`` the names
    (in ``model.named_parameters()``) of the parameters it reads."""
    name: str
    apply: Callable
    cost: float = 1.0
    params: tuple[str, ...] = ()


def model_pipe_blocks(model, stats=None, **fwd_kw) -> list[PipeBlock]:
    """The model's pipeline blocks: a CNN's stem through head, an LM's
    layers (its embedding and head stay outside).

    ``stats`` (the oracle's per-layer table, ``core.layer_stats``) supplies
    per-block fw+bw costs: exact backward FLOPs where the extractor recorded
    them (``flops_bwd_exact``), else 2× the forward; uniform costs without
    stats. ``fwd_kw``: an LM layer's attention chunks (``q_chunk``,
    ``kv_chunk``)."""
    if type(model) in CNN_MODELS.values():
        return _cnn_blocks(model, stats)
    if isinstance(model, TransformerLM):
        return _lm_layer_blocks(model, stats, **fwd_kw)
    raise NotImplementedError(
        f"{type(model).__name__}: no pipeline block decomposition")


def pipeline_block_count(cfg) -> int | None:
    """Schedulable block count for a model config (the executor's stage
    ceiling, distinct from the oracle's stat-layer count G), or None when
    the model cannot pipeline."""
    if type(cfg) in CNN_MODELS:
        return len(meta_twin(cfg).ordered_blocks())
    if isinstance(cfg, LMConfig):
        return cfg.n_layers                  # embed and head stay outside
    return None


def pipeline_block_costs(model, stats=None) -> np.ndarray:
    """Per-block fw+bw cost vector for the stage partitioner: the model's
    pipeline decomposition weighted by the oracle's layer stats."""
    return np.asarray([b.cost for b in model_pipe_blocks(model, stats)])


def _stat_cost(st) -> float:
    return st.flops_fwd + (st.flops_bwd_exact or 2.0 * st.flops_fwd)


def _grouped_costs(names: list[str], stats) -> list[float]:
    """Sum stat costs onto blocks by longest-prefix name match ("s2b1" and
    "s2b10" both prefix "s2b10c1": the longer wins); blocks with no matching
    stats (or no stats at all) get uniform weight 1."""
    if stats is None:
        return [1.0] * len(names)
    costs = [0.0] * len(names)
    for st in stats:
        best = None
        for i, nm in enumerate(names):
            if st.name == nm or st.name.startswith(nm):
                if best is None or len(names[best]) < len(nm):
                    best = i
        if best is not None:
            costs[best] += _stat_cost(st)
    return costs if any(costs) else [1.0] * len(names)


def _plain_ctx(model) -> ShardingCtx:
    """The mesh-free context the blocks run under, on the model's device
    (a model on ``meta``, which only shapes run through, takes the CPU's:
    the plain layers read no device from it)."""
    dev = next(model.parameters()).device
    return ShardingCtx("cpu" if dev.type == "meta" else dev)


def _cnn_blocks(model, stats) -> list[PipeBlock]:
    ctx, spec = _plain_ctx(model), model.ordered_blocks()
    costs = _grouped_costs([b.name for b in spec], stats)
    names = [k for k, _ in model.named_parameters()]
    return [PipeBlock(b.name, partial(b.apply, ctx=ctx, train=True), cost,
                      tuple(k for k in names if k.startswith(b.params)))
            for b, cost in zip(spec, costs)]


def _lm_layer_blocks(model, stats, q_chunk: int = 1024,
                     kv_chunk: int = 1024) -> list[PipeBlock]:
    """One block a layer, ``L{j}.{kind}``, reading ``blocks.{j}.*``."""
    ctx, kinds = _plain_ctx(model), model.cfg.block_kinds()
    costs = (block_costs_from_stats(stats, len(kinds)) if stats is not None
             else np.ones(len(kinds)))
    names = [k for k, _ in model.named_parameters()]
    return [PipeBlock(f"L{j}.{kind}",
                      partial(blk, ctx=ctx, q_chunk=q_chunk,
                              kv_chunk=kv_chunk), float(cost),
                      tuple(k for k in names if k.startswith(f"blocks.{j}.")))
            for j, (kind, blk, cost) in enumerate(zip(kinds, model.blocks,
                                                      costs))]


@torch.no_grad()
def boundary_shapes(blocks: list[PipeBlock], x0: torch.Tensor) -> list[tuple]:
    """Per-sample activation shape entering each block, plus the final
    output shape (len(blocks)+1 entries). Runs the blocks on ``x0``: blocks
    of a model on ``meta`` and a ``meta`` input give the shapes without
    computing anything."""
    return [s for s, _ in boundaries(blocks, x0)]


@torch.no_grad()
def boundaries(blocks: list[PipeBlock], x0: torch.Tensor) -> list[tuple]:
    """(per-sample shape, dtype) entering each block, plus the output's."""
    x, out = x0, [(tuple(x0.shape[1:]), x0.dtype)]
    for blk in blocks:
        x = blk.apply(x)
        out.append((tuple(x.shape[1:]), x.dtype))
    return out


def meta_twin(model_or_cfg) -> torch.nn.Module:
    """The CNN (of a model or a config) on the ``meta`` device: shapes
    only, no memory, no weights drawn."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    return CNN_MODELS[type(cfg)](cfg, device=torch.device("meta"),
                                 generator=None)
