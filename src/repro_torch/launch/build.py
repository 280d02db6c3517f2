"""Cells: (arch × shape × mesh × strategy) → a step function and its
abstract inputs (counterpart of ``repro.launch.build``), with model
construction and the batch's placement.

``build_cell`` is the one place a cell is assembled: the trainer (under
every strategy, ``auto`` included) and the session's ``Oracle.build``
deploy through it.
Its ``args`` are ``meta`` tensors of the reference's shapes and dtypes (the
counterpart of ``ShapeDtypeStruct``: they allocate nothing), each
recording its placement on the mesh (``t.place``) where there is one. The
dry-run that lowers a cell, and its ``n_scan_groups``, are not ported
(ROADMAP queue 1 item 12); tuned kernel tiles neither (item 11).

CNN weights are drawn on the host and moved, so one seed gives the same
weights on every device. LM weights are drawn where they will live, in the
config's dtype, from a generator on that device: the full Qwen1.5-4B holds
3,950,369,280 parameters (7.9 GB in bf16), which a host draw in fp32 would
take tens of seconds and 16 GB to make.

Across ranks (``ctx.sharded``) every rank draws the whole model from the
same seed and keeps its blocks (``shard_params``): a CNN from a host
generator, an LM from a generator on its device (one seed gives the same
weights on every rank of a card, and on cards of one kind). Each parameter
is cut to its block as soon as it is drawn (``nn.module.placing``), so a
rank holds its blocks and one whole parameter at a time: the full fp32
Qwen1.5-4B is 15.8 GB, its block under the serving tables on 4 ranks
~4 GB. Every rank
draws the same whole batch from the seeded stream and keeps its block
(``shard_batch``): a CNN's images on ("batch", "spatial"), an LM's tokens
(and targets and mask) on ("batch", None), as ``batch_specs`` places them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import SHAPES, ArchConfig, ShapeSpec
from ..data.pipeline import Loader
from ..models.cnn import (CosmoFlow, CosmoFlowConfig, ResNet, ResNetConfig,
                          VGG, VGGConfig)
from ..models.transformer import LMConfig, TransformerLM
from ..nn.module import ShardingCtx, placing, spec_to_pspec
from ..optim.optimizers import OptimizerConfig, zero1_rules
from ..parallel.sharded import Sharded, placement, shard_param, shard_params
from ..parallel.strategies import make_rules
from ..training.steps import (make_decode_step, make_prefill_step,
                              make_train_step)


def build_model(cfg: ArchConfig, ctx: ShardingCtx, smoke: bool = False,
                seed: int = 0) -> torch.nn.Module:
    """The (smoke or full) model on ``ctx.device``, weights drawn from
    ``seed``."""
    mc = cfg.smoke_model if smoke else cfg.model
    if not ctx.sharded:
        return _build(mc, ctx, seed)
    with placing(lambda p: shard_param(p, ctx)):
        return shard_params(_build(mc, ctx, seed), ctx)


def _build(mc, ctx: ShardingCtx, seed: int) -> torch.nn.Module:
    cnns = {ResNetConfig: ResNet, VGGConfig: VGG, CosmoFlowConfig: CosmoFlow}
    if type(mc) in cnns:
        return cnns[type(mc)](mc, device=ctx.device,
                              generator=torch.Generator().manual_seed(seed))
    if isinstance(mc, LMConfig):
        gen = None if ctx.device.type == "meta" else torch.Generator(
            device=ctx.device).manual_seed(seed)
        return TransformerLM(mc, device=ctx.device, generator=gen)
    raise TypeError(f"{type(mc).__name__} is not ported yet")


def batch_axes(name: str, ndim: int) -> tuple:
    """The logical axes of a batch leaf: a CNN's images (batch, spatial,
    ...), labels (batch,) and targets (batch, None), as
    ``cnn_batch_specs``; an LM's tokens, targets and mask (batch, None), as
    ``batch_specs``."""
    if name == "images":
        return ("batch", "spatial") + (None,) * (ndim - 2)
    return ("batch",) + (None,) * (ndim - 1)


def shard_batch(batch: dict, ctx: ShardingCtx) -> dict:
    """This rank's blocks of a whole batch that every rank holds, placed by
    the rules (the batch as it is where nothing is sharded)."""
    if not ctx.sharded:
        return batch
    return {k: Sharded.of(v, placement(ctx.mesh, ctx.pspec(
        batch_axes(k, v.dim()), v.shape)), ctx.mesh)
        for k, v in batch.items()}


class CellLoader:
    """The (seed, step)-addressable batches of ``data_cfg`` as a built
    train cell's step takes them: drawn whole on the cell's device, then
    this rank's blocks (``shard_batch``), or whole for a pipeline (its
    first stage takes the microbatches)."""

    def __init__(self, cell: "BuiltCell", data_cfg):
        self.loader = Loader(data_cfg, cell.ctx.device)
        self.ctx = cell.ctx
        self.whole = "pipeline" in cell.meta

    def batch_at(self, step: int) -> dict:
        batch = self.loader.batch_at(step)
        return batch if self.whole else shard_batch(batch, self.ctx)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
@dataclass
class BuiltCell:
    arch: str
    shape: str
    strategy: str
    model: Any
    ctx: ShardingCtx
    step_fn: Any
    args: tuple           # meta stand-ins of step_fn's arguments
    kind: str             # train | prefill | decode
    meta: dict


def mesh_device_count(mesh) -> int:
    """Ranks a (possibly absent) mesh spans."""
    return 1 if mesh is None else int(mesh.size)


def _abstract(shape, dtype, axes, ctx: ShardingCtx, rules=None):
    """A meta tensor of the global ``shape`` and ``dtype``; on a mesh it
    records the placement ``rules`` (the ctx's by default) give ``axes``
    (``t.place``)."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    if ctx.sharded and axes is not None:
        t.place = placement(ctx.mesh, spec_to_pspec(
            tuple(axes), rules or ctx.rules, ctx.mesh, tuple(shape)))
    return t


def _state_specs(model, opt: OptimizerConfig, ctx: ShardingCtx) -> dict:
    """The train state's stand-ins (``train_state_spec``): parameters in
    their dtypes, the optimizer's fp32 slots (placed by ZeRO-1's rules
    with ``opt.zero1``), the int32 step."""
    params = {k: _abstract(getattr(p, "global_shape", p.shape), p.dtype,
                           getattr(p, "axes", None), ctx)
              for k, p in model.named_parameters()}
    state_rules = zero1_rules(ctx.rules) if opt.zero1 else ctx.rules
    slots = ("m", "v") if opt.name == "adamw" else ("mom",)
    return {"params": params,
            "opt": {s: {k: _abstract(getattr(p, "global_shape", p.shape),
                                     torch.float32,
                                     getattr(p, "axes", None), ctx,
                                     state_rules)
                        for k, p in model.named_parameters()}
                    for s in slots},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _batch_specs(cfg: ArchConfig, mc, shape: ShapeSpec,
                 ctx: ShardingCtx) -> dict:
    """The batch's stand-ins (``cnn_batch_specs``, ``batch_specs``' LM
    leaves)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "lm":
        return {"tokens": _abstract((B, S), torch.int32, ("batch", None),
                                    ctx)}
    if cfg.family != "cnn":
        raise ValueError(f"batch specs for family {cfg.family}")
    if isinstance(mc, CosmoFlowConfig):
        img = (B, mc.img, mc.img, mc.img, mc.in_ch)
        return {"images": _abstract(img, torch.float32,
                                    batch_axes("images", 5), ctx),
                "targets": _abstract((B, mc.n_targets), torch.float32,
                                     ("batch", None), ctx)}
    size = getattr(mc, "img", 224)
    return {"images": _abstract((B, size, size, 3), torch.float32,
                                batch_axes("images", 4), ctx),
            "labels": _abstract((B,), torch.int32, ("batch",), ctx)}


def build_cell(cfg: ArchConfig, shape, mesh, strategy: str | None = None,
               *, smoke: bool = False, kv_shards: int = 1,
               q_chunk: int = 1024, kv_chunk: int = 1024,
               opt: OptimizerConfig | None = None, accum: int = 1,
               override_layers: int | None = None, plan=None, system=None,
               segments: int | None = None, schedule: str | None = None,
               virtual_stages: int | None = None, use_pallas: bool = False,
               device: str | torch.device = "cuda",
               seed: int = 0) -> BuiltCell:
    """Assemble one (arch × shape) cell under a strategy on a mesh (the
    port's ``Mesh``, or None for one device), in the reference's order.

    ``shape``: a ``SHAPES`` name, or a ``ShapeSpec`` (the trainer's own
    batch and sequence length). ``strategy="auto"`` asks the oracle:
    ``plan_for_arch`` at the mesh's rank count on ``system`` (a
    SystemModel or ClusterSpec; the TPU target by default, as the
    reference's), constrained to the mesh's model width or grid; ``plan``
    reuses a plan already made. A plan gives the rules table
    (``exec_strategy(kind)``), ZeRO-1 (unless ``opt`` is given), and for an
    LM its remat switch, which serving cells strip. A pipeline trains under
    ``schedule``, ``segments`` and ``virtual_stages`` (each, where None, the
    plan's, else gpipe, 8 and 2), cut on the oracle's per-block costs at
    the shape's sequence length, on the mesh's "model" axis (without one
    it raises). A pipeline serving cell raises, as the reference's does. ``override_layers`` cuts an LM's depth.

    The model is built with weights from ``seed`` on ``device`` (the mesh's
    where there is one; ``meta`` builds it without weights), whole for a
    pipeline (each stage updates its blocks), else this rank's blocks. The
    cell's ``args`` are stand-ins: a train cell's (state, batch), a prefill
    cell's (params, batch, cache), a decode cell's (params, token, cache,
    pos); ``meta`` records the rules table, the family, the optimizer, the
    remat switch deployed, the plan, and a pipeline's schedule, segments
    and virtual stages ("pipeline")."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    strategy = strategy or cfg.strategy_for(shape.name)
    if strategy == "auto" and plan is None:
        # the mesh is already shaped: the plan is constrained to the model
        # width (or grid) it realises
        from ..core.autotune import plan_for_arch
        grid = (None if mesh is None or "model_r" not in mesh.shape
                else (mesh.shape["model_r"], mesh.shape["model_c"]))
        plan = plan_for_arch(
            cfg, shape.name, mesh_device_count(mesh), system=system,
            smoke=smoke,
            model_width=None if mesh is None else mesh.shape.get("model"),
            model_grid=grid)
    if plan is not None:
        strategy = plan.exec_strategy(shape.kind)
        if opt is None:
            opt = OptimizerConfig(zero1=plan.zero1)
    rules = make_rules(strategy)
    opt = opt or OptimizerConfig(zero1="zero1" in strategy)
    mc = cfg.smoke_model if smoke else cfg.model
    if override_layers is not None:
        if not isinstance(mc, LMConfig):
            raise TypeError(f"override_layers cuts an LM's depth, not a "
                            f"{type(mc).__name__}'s")
        mc = dataclasses.replace(mc, n_layers=override_layers, mtp_heads=0)
        cfg = dataclasses.replace(cfg, model=mc, smoke_model=mc)
    if shape.kind != "train" and strategy == "pipeline":
        raise NotImplementedError(
            "the pipeline schedules (gpipe / 1F1B / interleaved) are "
            "training schedules (fill/drain over microbatches); serve "
            "cells deploy serve_tp instead — TunedPlan.exec_strategy does "
            "this automatically")
    if mesh is None:
        ctx = ShardingCtx(device, use_pallas)
    else:
        ctx = ShardingCtx(mesh.device, use_pallas, mesh=mesh, rules=rules)
    pipe = shape.kind == "train" and strategy == "pipeline"
    model = build_model(cfg, ShardingCtx(ctx.device) if pipe else ctx,
                        smoke=smoke, seed=seed)
    kw = {}
    if cfg.family == "lm":
        kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk)
        if plan is not None and shape.kind == "train":
            kw["remat"] = plan.remat     # the plan's remat switch
    meta = {"strategy": strategy, "family": cfg.family, "opt": opt,
            "remat": bool(kw.get("remat", False))}
    if plan is not None:
        meta["plan"] = plan

    if shape.kind == "train":
        if pipe:
            from ..core.autotune import stats_for_model
            from ..parallel.schedules import (make_pipeline_train_step,
                                              pipeline_block_costs)
            if accum != 1:
                raise NotImplementedError(
                    "pipeline microbatches ARE the accumulation schedule; "
                    "sequential grad accumulation (accum > 1) is not wired "
                    "through the pipeline step")
            planned = (dict(schedule=plan.schedule, segments=plan.segments,
                            virtual_stages=plan.virtual_stages)
                       if plan is not None else
                       dict(schedule="gpipe", segments=8, virtual_stages=2))
            given = dict(schedule=schedule, segments=segments,
                         virtual_stages=virtual_stages)
            meta["pipeline"] = pick = {
                k: v if given[k] is None else given[k]
                for k, v in planned.items()}
            costs = pipeline_block_costs(
                model, stats_for_model(mc, shape.seq_len))
            step = make_pipeline_train_step(model, opt, ctx,
                                            block_costs=costs, **pick, **kw)
        else:
            step = make_train_step(model, opt, ctx, accum=accum, **kw)
        args = (_state_specs(model, opt, ctx),
                _batch_specs(cfg, mc, shape, ctx))
        return BuiltCell(cfg.name, shape.name, strategy, model, ctx, step,
                         args, "train", meta)

    # serving cells: no remat (no backward)
    if cfg.family != "lm":
        raise ValueError(f"{shape.kind} cells serve lm archs, not "
                         f"{cfg.family}")
    params = _state_specs(model, opt, ctx)["params"]
    B, S = shape.global_batch, shape.seq_len
    cache = model.cache_spec(B, S, shards=kv_shards)
    if ctx.sharded:
        for layer in cache["blocks"]:
            for name, t in layer.items():
                t.place = placement(ctx.mesh, ctx.pspec(t.axes, t.shape))
    if shape.kind == "prefill":
        step = make_prefill_step(model, ctx, **kw)
        return BuiltCell(cfg.name, shape.name, strategy, model, ctx, step,
                         (params, _batch_specs(cfg, mc, shape, ctx), cache),
                         "prefill", meta)
    if shape.kind == "decode":
        step = make_decode_step(model, ctx)
        token = _abstract((B, 1), torch.int32, ("batch", None), ctx)
        pos = torch.empty((), dtype=torch.int32, device="meta")
        return BuiltCell(cfg.name, shape.name, strategy, model, ctx, step,
                         (params, token, cache, pos), "decode", meta)
    raise ValueError(shape.kind)
