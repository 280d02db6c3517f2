"""The deployable pipeline train step for the paper's CNNs and the LMs
(counterpart of ``repro.parallel.schedules.train_step``).

``make_pipeline_train_step`` keeps the ``make_train_step`` contract,
(state, batch) → (state, metrics), with ``train_state(model, opt)`` and the
whole batch on every rank. The stages are the ranks of the mesh's
"model" axis; the cuts come from the min-max partition
(``core.partition.min_max_partition``) into p·v chunks of the per-block
costs; chunk j = q·p + r runs on rank r, slot q (``stages.py``), and any
of the three executors of ``runtime.py`` runs them. A CNN's blocks are its
stem through its head, cut on the oracle's layer table (``stats_for``);
an LM's are its layers (``hetero._lm_layer_blocks``), cut as the reference
cuts them: on ``block_costs`` where given (``launch.train`` and
``core.validation`` pass the oracle's per-layer costs at the batch's
sequence length), else on uniform costs, the reference's ``np.ones(L)``
for a uniform pattern and its blocks' own (uniform) costs for a mixed one.

The loss lives on the last stage. A CNN's is the mean cross-entropy
(CosmoFlow: the MSE) over all B rows, the mean of the S microbatches'
means, so microbatch m seeds its backward with its own mean ÷ S. An LM's
is the reference's ``sum(ce·mask) / max(sum(mask), 1)`` over the whole
batch (targets: the tokens shifted left, 0 at the end, unless the batch
gives ``targets``): with a mask the microbatches' means are not equally
weighted, so microbatch m seeds its backward with its masked sum ÷ the
whole batch's mask count. (The 1/p seed ``make_train_step`` gives a loss
that all p ranks hold does not apply: one rank holds each microbatch's
loss.) BatchNorm takes per-microbatch statistics (each chunk runs on a
microbatch, mesh-free), as in the reference, so ResNet and VGG match the
serial step at the microbatch size (``make_train_step(accum=S)``, whose
microbatch m is rows [m·B/S, (m+1)·B/S), as here); CosmoFlow, which has
no BatchNorm, and the LMs match the plain step.

An LM's embedding runs on the first stage, inside chunk 0, and its final
norm, head and loss on the last stage, after the last chunk (chunk 0 is
rank 0's slot 0 and the last chunk rank p−1's slot v−1 under every
schedule). The reference runs the embedding and the head replicated,
outside the pipe: the updated parameters are the same, only where that
work runs differs. A tied table (Mamba-2 780m) is read by both ends: its
gradient is the first stage's lookup part plus the last stage's head
part, so the two ranks swap their parts (one send and one receive each)
and both apply the same update to the same sum; the clipping norm counts
the table once.

Parameter layout. Every rank holds the whole model (built from the same
seed) but updates only the blocks it owns, with ``optim.apply_update``;
the clipping norm is the whole model's, √ of the sum of the stages' squared
norms: one all-reduce of two scalars over the stage group, which also
hands the loss from the last stage to every rank. A non-owner's copy of a
block is left as it was; ``gather_pipeline_state`` broadcasts each block
(and its optimizer slots) from its owner where the whole state is needed.
The reference instead keeps the parameters replicated and psums the whole
gradient tree; on one card shared by 4 gloo ranks that would put ResNet-50's
102 MB host-staged all-reduce into every step (about 0.75 s, going by the
data-parallel profile), which the paper's layer strategy does not have and
the oracle does not price. The updated parameters are the same either way.
"""
from __future__ import annotations

import warnings
from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.layer_stats import stats_for
from ...core.partition import min_max_partition
from ...models.cnn import CosmoFlowConfig, ResNetConfig, VGGConfig
from ...models.transformer import LMConfig, TransformerLM, _xent
from ...optim.optimizers import OptimizerConfig, apply_update
from .. import collectives as C
from .hetero import _plain_ctx, boundaries, meta_twin, model_pipe_blocks
from .runtime import SCHEDULE_NAMES, SCHEDULES, StageProgram
from .stages import stack_virtual_stage_bounds

# the tag of the tied table's gradient swap (the schedule's own tags are
# 2·(m·n_chunks + j) + direction, far below it)
_TIED_TAG = 1 << 30


def pipeline_supported(model_or_cfg) -> str | None:
    """None when a pipeline schedule can deploy this model, else the
    reason."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if isinstance(cfg, (ResNetConfig, VGGConfig, CosmoFlowConfig, LMConfig)):
        return None
    return (f"{type(cfg).__name__}: no pipeline block decomposition (the "
            f"paper's CNNs and the LMs pipeline)")


def clip_segments(batch: int, segments: int) -> int:
    """Largest microbatch-segment count ≤ ``segments`` dividing ``batch``."""
    s = max(min(int(segments), int(batch)), 1)
    while batch % s:
        s -= 1
    return s


def resolve_segments(batch: int, segments: int,
                     multiple_of: int = 1) -> int:
    """``clip_segments`` that surfaces silent degradation.

    Returns the largest S ≤ ``segments`` that divides ``batch`` (and is a
    multiple of ``multiple_of``: the interleaved schedule's S % p == 0),
    warning when the pipe runs with fewer microbatches than requested: a
    prime batch clips all the way to S = 1, which serializes the pipeline
    (bubble (p−1)/S)."""
    batch, m = int(batch), max(int(multiple_of), 1)
    s = max(min(int(segments), batch), 1)
    while s > 0 and (batch % s or s % m):
        s -= 1
    if s < 1:
        raise ValueError(
            f"no segment count ≤ {segments} divides batch {batch} and is a "
            f"multiple of {m} (the interleaved schedule needs S % p == 0)")
    if s < int(segments):
        warnings.warn(
            f"pipeline segments clipped: requested {segments}, running "
            f"S={s} (batch {batch}"
            + (f", S must be a multiple of p={m}" if m > 1 else "")
            + (") — the pipe is fully serialized" if s == 1 else ")"),
            stacklevel=2)
    return s


def make_pipeline_train_step(model, opt: OptimizerConfig, ctx,
                             segments: int = 8, schedule: str = "gpipe",
                             virtual_stages: int = 2, block_costs=None,
                             **fwd_kw) -> Callable:
    """Pipeline train step: (state, batch) → (state, metrics).

    Stages = the ranks of ``ctx.mesh``'s "model" axis (ranks on its other
    axes run the same pipe on the same batch, as the reference's
    replicated microbatches). ``segments`` is the requested microbatch
    count; the step resolves the largest deployable S ≤ it
    (``resolve_segments``) and reports it as ``metrics["pipeline_segments"]``.
    ``schedule``: one of ``SCHEDULE_NAMES``; ``virtual_stages``: the
    interleaved v; ``block_costs``: the per-block fw+bw costs to cut on
    (default: see the module docstring); ``fwd_kw``: an LM layer's
    attention chunks (``q_chunk``, ``kv_chunk``).

    The returned step carries ``bounds`` (the chunk cuts over the blocks),
    ``group`` (the stage group), ``owner`` (parameter name → the stage
    index that updates it and counts it in the clipping norm), which
    ``gather_pipeline_state`` reads, and ``shared`` (name → the other
    stage that applies the same update: a tied table's last stage)."""
    if schedule not in SCHEDULE_NAMES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"pick one of {SCHEDULE_NAMES}")
    reason = pipeline_supported(model)
    if reason is not None:
        raise NotImplementedError(f"pipeline cannot deploy: {reason}")
    mesh = ctx.mesh
    if mesh is None or "model" not in mesh.shape:
        raise ValueError("pipeline needs a mesh with a 'model' axis")
    group = mesh.group("model")
    p = group.size
    v = int(virtual_stages) if schedule == "interleaved" else 1
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    n_chunks = p * v
    lm = isinstance(model, TransformerLM)
    blocks = model_pipe_blocks(model, None if lm else stats_for(model.cfg),
                               **fwd_kw)
    L = len(blocks)
    if n_chunks > L:
        raise ValueError(f"{p} stages × {v} virtual exceed {L} blocks")
    costs = np.asarray([b.cost for b in blocks] if block_costs is None
                       else block_costs, dtype=float)
    if len(costs) != L:
        raise ValueError(f"{len(costs)} block costs for {L} blocks")
    bounds = min_max_partition(costs, n_chunks).bounds
    owner = {k: r for r, slots in enumerate(
        stack_virtual_stage_bounds(bounds, p, v))
        for layers in slots for j in layers for k in blocks[j].params}
    shared = {}
    if lm:
        last = (n_chunks - 1) % p
        for k, _ in model.named_parameters():
            if k.startswith("embed."):
                owner[k] = 0
            elif k.startswith(("final_norm.", "head")):
                owner[k] = last
        if model.cfg.tie_embeddings and last != 0:
            shared["embed.table"] = last
    me = group.index
    # the clipping norm counts each parameter on its owner only
    counted = [k for k, r in owner.items() if r == me]
    owned = counted + [k for k, r in shared.items() if r == me]
    seg_multiple = p if schedule == "interleaved" else 1
    kw = {"virtual_stages": v} if schedule == "interleaved" else {}
    plain = _plain_ctx(model)
    ends = _lm_ends if lm else partial(_cnn_ends, model_pipe_blocks(
        meta_twin(model)))

    def run(j, x):
        if lm and j == 0:
            x = model._embed(x, plain)
        for blk in blocks[bounds[j]:bounds[j + 1]]:
            x = blk.apply(x)
        return x

    def train_step(state, batch):
        key = "tokens" if lm else "images"
        B = batch[key].shape[0]
        S = resolve_segments(B, segments, seg_multiple)
        mb = B // S
        boundary, loss_share, metric = ends(model, batch, mb, S, plain)
        params = state["params"]
        for k in owned:
            params[k].grad = None
        program = StageProgram(
            group, n_chunks, run, lambda m: batch[key][m * mb:(m + 1) * mb],
            loss_share, lambda j: boundary(bounds[j]), ctx.device)
        shares = SCHEDULES[schedule](program, S, **kw)
        grads = {k: params[k].grad if params[k].grad is not None
                 else torch.zeros_like(params[k]) for k in owned}
        for k, last in shared.items():
            if me in (0, last):
                grads[k] = grads[k] + _swap(grads[k], last if me == 0 else 0,
                                            group)
        sq = sum((grads[k].float().square().sum() for k in counted),
                 torch.zeros((), device=ctx.device))
        loss = sum(shares, torch.zeros((), device=ctx.device))
        total = C.all_reduce_sum(torch.stack([sq, loss.float()]), group)
        om = apply_update(opt, {k: params[k] for k in owned}, grads,
                          state["opt"], state["step"], total[0].sqrt())
        for k in owned:
            params[k].grad = None
        state["step"] += 1
        return state, dict({metric: total[1]}, loss=total[1],
                           pipeline_segments=S, **om)

    train_step.bounds, train_step.group = bounds, group
    train_step.owner, train_step.shared = owner, shared
    return train_step


def _cnn_ends(shape_blocks, model, batch, mb: int, S: int, ctx):
    """A CNN's (boundary(i): (shape, dtype) entering block i; loss share
    of microbatch m; the loss's metric name): the mean loss of the
    microbatch ÷ S."""
    images = batch["images"]
    bnd = boundaries(shape_blocks, torch.empty(
        (mb,) + tuple(images.shape[1:]), dtype=images.dtype, device="meta"))
    # the loss's own metric name ("ce", "mse"), from a shapes-only call
    metric, = model.loss(
        torch.empty((mb,) + bnd[-1][0], dtype=bnd[-1][1], device="meta"),
        {k: t[:mb].to("meta") for k, t in batch.items()})[1]

    def loss_share(m, out):
        rows = {k: t[m * mb:(m + 1) * mb] for k, t in batch.items()}
        return model.loss(out, rows)[0] / S

    return (lambda i: ((mb,) + bnd[i][0], bnd[i][1])), loss_share, metric


def _lm_ends(model, batch, mb: int, S: int, ctx):
    """An LM's (boundary, loss share, "ce"): every boundary a (mb, seq,
    d_model) activation in the model's dtype; microbatch m's share its
    masked cross-entropy sum ÷ the whole batch's mask count, the final
    norm and the head run on it first (``TransformerLM.loss_fn``'s
    arithmetic)."""
    tokens = batch["tokens"]
    targets = batch.get("targets")
    if targets is None:
        targets = F.pad(tokens[:, 1:], (0, 1))
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    count = torch.clamp(mask.sum(), min=1.0)
    shape = ((mb, tokens.shape[1], model.cfg.d_model), model.cfg.dtype)

    def loss_share(m, h):
        rows = slice(m * mb, (m + 1) * mb)
        ce = _xent(model._logits(h, ctx), targets[rows])
        return (ce * mask[rows]).sum() / count

    return (lambda i: shape), loss_share, "ce"


def _swap(t: torch.Tensor, peer: int, group) -> torch.Tensor:
    """``t`` sent to the stage ``peer`` and the peer's tensor of the same
    shape received in exchange (through host buffers under gloo)."""
    with record_function("comm.p2p_send"):
        send = t.detach().cpu() if group.stage else t.detach().contiguous()
        recv = torch.empty_like(send)
        # one batch: NCCL would hold two plain sends each waiting for the
        # other's receive
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, group.ranks[peer], group.pg,
                           _TIED_TAG),
                dist.P2POp(dist.irecv, recv, group.ranks[peer], group.pg,
                           _TIED_TAG)]):
            w.wait()
        return recv.to(t.device)


@torch.no_grad()
def gather_pipeline_state(state: dict, step) -> dict:
    """The whole train state on every stage rank: each stage broadcasts
    the parameters it owns and their optimizer slots (one flat buffer per
    dtype) over the stage group. Updates ``state`` in place."""
    group = step.group
    for r in range(group.size):
        keys = [k for k, o in step.owner.items() if o == r]
        ts = [state["params"][k] for k in keys]
        ts += [slot[k] for slot in state["opt"].values() for k in keys]
        for dtype in sorted({t.dtype for t in ts}, key=str):
            part = [t for t in ts if t.dtype == dtype]
            flat = torch.cat([t.detach().reshape(-1) for t in part])
            dist.broadcast(flat, group.ranks[r], group=group.pg)
            for t, piece in zip(part, flat.split([t.numel() for t in part])):
                t.copy_(piece.view_as(t))
    return state
