"""Oracle-guided elastic training: failure is a planning event
(counterpart of ``repro.runtime.elastic``; DESIGN.md §12).

The paper's oracle targets runs of up to 1024 GPUs — a scale where slice
loss and stragglers are routine, and where the interesting part of recovery
is not the restart but the *re-plan*: the surviving machine is a different
``ClusterSpec`` (a torus with one dimension shrunk, the model-axis ring
constraint re-indexed), so the plan that was cheapest on the full machine
may be infeasible — or merely slow — on what is left. This module closes
that loop:

    failure / repeated stragglers  →  SliceLost
      → derive the surviving ClusterSpec       (ClusterSpec.degraded)
      → re-run the tuner on the degraded spec  (Oracle session .tune)
      → lay the survivors out as the plan's mesh (Mesh.shrink: the first
        p' ranks, new process groups)
      → build the plan's cell there            (launch.build.build_cell)
      → restore the latest complete checkpoint into the new cell's state
        (Checkpointer.restore cuts each survivor's blocks from the whole
        leaves: restore IS the remesh) and resume.

The inner loop is ``run_with_recovery``: transient faults restore and
replay on the same mesh; only ``SliceLost`` — abrupt slice death, or the
patience-exceeded straggler escalation (which checkpoints first) —
surfaces here and triggers a rebind.

Across ranks every rank of the current mesh runs this loop and sees the
same ``SliceLost`` at the same step (an injected fault; the straggler
decision is all-reduced). All of them make the survivors' process groups;
a rank left out returns ``(None, step, events)`` with its state released
(and, on a card, its cached memory freed) and joins no collective after
that (``launch.train --elastic`` then exits; under ``launch.spawn`` it
waits at the spawner's closing barrier, whose timeout must outlast the
survivors' remaining steps). A pipeline plan raises here, as in the
reference: the rebind builds a plain SPMD step, not a stage schedule.
``planned_continuation`` is the planned reshape a recovery is held
against.

Recovery contract (what tests/test_torch_chaos.py pins, bit for bit):
resuming on the degraded machine is indistinguishable from having
*planned* the degraded run from that checkpoint — same loader stream (the
data pipeline is (seed, step)-addressable), same state bits (restore is
pure data movement), same step math under the new plan.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, replace
from typing import Any

import torch

from ..checkpoint.checkpointing import Checkpointer, whole_leaf
from ..configs.base import ShapeSpec
from ..launch.build import CellLoader, build_cell
from ..optim.optimizers import OptimizerConfig
from ..training.steps import train_state
from .fault_tolerance import (SliceLost, StepTimer, _sync, remesh_state,
                              run_with_recovery)


@dataclass(frozen=True)
class ElasticEvent:
    """One recovery: what died, what the tuner chose, where we resumed."""

    step: int            # step at which the loss surfaced
    cause: str           # "failure" | "straggler"
    p_before: int
    p_after: int
    strategy: str        # re-tuned plan's oracle strategy
    mesh_shape: tuple    # (p1, p2) deployed on the survivors
    resumed_from: int    # checkpoint step the run resumed at
    cluster: str         # surviving ClusterSpec name


@dataclass
class Binding:
    """One deployed plan: everything the loop needs on the current mesh.
    ``state`` is the cell's fresh train state (weights from the seed), the
    skeleton a restore fills."""

    ses: Any             # Oracle session bound to the current ClusterSpec
    plan: Any            # TunedPlan
    mesh: Any            # the port's Mesh (None: one device)
    cell: Any            # launch.build.BuiltCell
    step_fn: Any
    loader: CellLoader
    state: dict


def bind_plan(ses, mesh, p: int, data_cfg, opt: OptimizerConfig, *,
              plan=None, device="cuda", allow_pipeline: bool = False,
              seed: int = 0, cell_kw: dict | None = None) -> Binding | None:
    """Deploy ``plan`` (default: the session's ``tune(p)``) on the first
    ``p`` ranks of ``mesh`` (``Mesh.shrink`` to the plan's grid; None: one
    process on ``device``): the cell (``build_cell`` with the plan, at the
    session's batch and sequence length; ``cell_kw`` to it, a pipeline's
    schedule and segments), its train state, the loader. The one place a
    plan becomes a mesh and a cell: the trainer's ``--strategy auto`` and
    every rebind of ``run_elastic`` go through it. Collective over
    ``mesh``: a rank outside the first ``p`` gets None.

    The plan's ZeRO-1 switch goes into the optimizer config — safe across
    rebinds because ZeRO-1 changes only placements, never the state's
    structure, so a checkpoint written under one plan restores under any
    other."""
    if plan is None:
        plan = ses.tune(p, allow_pipeline=allow_pipeline)
    if plan.p != p:
        raise ValueError(f"the plan is for p={plan.p}, not {p}")
    shape, axes = plan.mesh_spec()
    if mesh is not None:
        mesh = mesh.shrink(*shape, axes=axes)
        if mesh is None:
            return None
    elif p != 1:
        raise ValueError(f"one process holds 1 PE, not {p}")
    cell = build_cell(
        ses.arch_cfg, ShapeSpec(ses.shape.name, ses.seq, ses.B, "train"),
        mesh, "auto", smoke=ses.smoke, plan=plan,
        opt=replace(opt, zero1=plan.zero1), device=device, seed=seed,
        **(cell_kw or {}))
    return Binding(ses, plan, mesh, cell, cell.step_fn,
                   CellLoader(cell, data_cfg),
                   train_state(cell.model, cell.meta["opt"], cell.ctx))


def whole_params(state, mesh) -> dict:
    """A train state's parameters, each gathered whole over ``mesh`` (every
    rank of it calls this) and copied."""
    return {k: whole_leaf(v, mesh).clone()
            for k, v in state["params"].items()}


def planned_continuation(ses, mesh, p: int, data_cfg, opt: OptimizerConfig,
                         n_steps: int, *, ckpt: Checkpointer | None = None,
                         step: int | None = None, state=None, src_mesh=None,
                         device="cuda", seed: int = 0,
                         cell_kw: dict | None = None) -> dict | None:
    """A *planned* reshape, what an elastic recovery must equal bit for
    bit: the plan ``bind_plan`` tunes for ``p`` on the session's cluster
    (the degraded one), on the first ``p`` ranks of ``mesh``; its state
    ``ckpt``'s checkpoint at ``step`` restored, or ``state`` (a train state
    on ``src_mesh`` at ``step``) moved there by ``remesh_state``; then
    plain steps up to ``n_steps``, no fault machinery. Collective over
    ``mesh``. On the ``p`` ranks: the plan, the losses and seconds by step
    (each step timed until the device has finished it), the restore's
    seconds and the final parameters whole; None on the others."""
    b = bind_plan(ses, mesh, p, data_cfg, opt, device=device, seed=seed,
                  cell_kw=cell_kw)
    t0 = time.perf_counter()
    if state is not None:
        st = remesh_state(state, src_mesh, None if b is None else b.state)
    elif b is not None:
        st, step = ckpt.restore(b.state, step=step)
    if b is None:
        return None
    out = {"plan": b.plan, "restore_s": time.perf_counter() - t0,
           "losses": {}, "step_s": {}}
    for s in range(step, n_steps):
        t0 = time.perf_counter()
        st, m = b.step_fn(st, b.loader.batch_at(s))
        out["losses"][s] = float(m["loss"])
        _sync(m)
        out["step_s"][s] = time.perf_counter() - t0
    out["params"] = whole_params(st, b.mesh)
    return out


def _survivors(ses, p: int, e: SliceLost):
    """The (session, PE count) that outlive ``e``: degrade the cluster's
    torus along the lost dimension, or halve p when no topology is
    described (no slice structure to consult)."""
    if ses.cluster.topology is not None:
        degraded = ses.cluster.degraded(dim=e.dim, count=e.count)
        return ses.with_cluster(degraded), min(degraded.topology.size, p)
    return ses, max(p // 2, 1)


def _release(device) -> None:
    """A dropped rank's memory back to its device before it waits."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_elastic(ses, data_cfg, ckpt: Checkpointer, *, n_steps: int,
                mesh=None, device="cuda", opt: OptimizerConfig | None = None,
                start_step: int = 0, ckpt_every: int = 10,
                async_ckpt: bool = False, max_restarts: int = 3,
                straggler_patience: int | None = 2, max_reshapes: int = 8,
                timer: StepTimer | None = None, inject=None,
                on_metrics=None, on_event=None, on_bind=None,
                allow_pipeline: bool = False, seed: int = 0,
                cell_kw: dict | None = None):
    """Elastic train loop: tune → run → on SliceLost shrink, re-tune,
    restore, resume. Returns ``(state, step, events)``; on a rank left out
    of a shrink, ``(None, step, events)`` (the step the loss surfaced at).

    ``ses`` is an ``Oracle`` session (``repro_torch.api``): its
    ClusterSpec is the machine being degraded, its batch and sequence
    length the cell's. ``mesh``: the ranks to start on (every rank of it
    calls this; None: one process on ``device``). ``ckpt``: the store
    (rebound to each plan's mesh, ``Checkpointer.on``); a run resumes from
    its latest complete step. ``inject`` is the fault hook forwarded to
    ``run_with_recovery``; ``on_bind`` is called with each ``Binding``
    this rank deploys (the first, then one a rebind), ``on_event`` with
    each ``ElasticEvent`` on the survivors; ``cell_kw`` goes to
    ``build_cell`` (an LM's ``q_chunk``). Transient faults never surface
    here: the inner loop's restart budget (which resets on forward
    progress) absorbs them on the same mesh.
    """
    opt = opt if opt is not None else OptimizerConfig()
    timer = timer if timer is not None else StepTimer()
    device = mesh.device if mesh is not None else device
    events: list[ElasticEvent] = []
    kw = dict(device=device, seed=seed, cell_kw=cell_kw)

    def tuned(s, p):
        plan = s.tune(p, allow_pipeline=allow_pipeline)
        if plan.exec_strategy("train") == "pipeline":
            raise NotImplementedError(
                "elastic rebinding of the pipeline stage schedule is not "
                "wired; keep allow_pipeline=False or deploy via build_cell")
        return plan

    p = 1 if mesh is None else mesh.size
    b = bind_plan(ses, mesh, p, data_cfg, opt, plan=tuned(ses, p), **kw)
    if on_bind:
        on_bind(b)
    ckpt = ckpt.on(b.mesh)
    if ckpt.latest_step() is not None:
        state, step = ckpt.restore(b.state)
    else:
        state, step = b.state, start_step
    reshapes = 0
    while step < n_steps:
        try:
            state, step = run_with_recovery(
                b.step_fn, state, b.loader, ckpt, n_steps=n_steps,
                start_step=step, ckpt_every=ckpt_every,
                async_ckpt=async_ckpt, max_restarts=max_restarts,
                timer=timer, inject=inject, on_metrics=on_metrics,
                straggler_patience=straggler_patience, skeleton=b.state,
                mesh=b.mesh)
            continue
        except SliceLost as e:
            reshapes += 1
            if reshapes > max_reshapes:
                raise
            # a copy without the traceback, which holds the old state
            lost = SliceLost(e.step, dim=e.dim, count=e.count,
                             cause=e.cause, reason=e.reason)
        # the old plan's state and cell go before the new one is built:
        # the survivors restore from the checkpoint
        ckpt.wait()
        ses_old, mesh_old = b.ses, b.mesh
        p_before = 1 if mesh_old is None else mesh_old.size
        state = b = None
        ses2, p_new = _survivors(ses_old, p_before, lost)
        timer.reset()   # new plan, new step-time baseline
        plan = tuned(ses2, p_new)
        b = bind_plan(ses2, mesh_old, p_new, data_cfg, opt, plan=plan, **kw)
        resumed = ckpt.latest_step()
        resumed = start_step if resumed is None else resumed
        ev = ElasticEvent(
            step=lost.step, cause=lost.cause, p_before=p_before,
            p_after=p_new, strategy=plan.strategy,
            mesh_shape=(plan.p1, plan.p2), resumed_from=resumed,
            cluster=ses2.cluster.name)
        events.append(ev)
        if b is None:                  # left out of the survivors' mesh
            _release(device)
            return None, lost.step, events
        if on_bind:
            on_bind(b)
        ckpt = ckpt.on(b.mesh)
        if ckpt.latest_step() is not None:
            # the old plan's layout is in the checkpoint as whole leaves;
            # the new cell's state takes its blocks: restore IS the remesh
            state, step = ckpt.restore(b.state)
        else:
            state, step = b.state, start_step
        if b.mesh is None or b.mesh.rank == 0:
            print(f"[elastic] {lost} → p {p_before}→{p_new}, re-tuned "
                  f"{plan.strategy} (mesh {plan.p1}x{plan.p2}), resumed "
                  f"from step {step}", flush=True)
        if on_event:
            on_event(ev)
    return state, step, events
