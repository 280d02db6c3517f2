"""Fault tolerance for the training runtime (counterpart of
``repro.runtime.fault_tolerance``).

Three mechanisms, the reference's:

* **checkpoint/restart** — ``run_with_recovery`` drives the train loop with
  periodic (optionally async) checkpoints; a step-time exception triggers
  restore-from-latest and replay. The data pipeline is (seed, step)-
  addressable, so the resumed stream is identical. The restart budget
  counts *consecutive* failures: forward progress (a checkpoint newer than
  the one seen at the previous failure) resets it, so spaced transient
  faults over a long run never exhaust it while a crash loop still aborts.
  Before the first checkpoint a failure replays from ``start_step`` on the
  live state, as the reference does (ROADMAP caveat o).
* **straggler mitigation** — ``StepTimer`` keeps a ring buffer of step
  times; a step slower than ``threshold × median`` raises a
  ``StragglerAlert`` (the outlier stays out of the window, so one slow step
  cannot inflate the median and mask the next). After
  ``straggler_patience`` consecutive alerts the loop checkpoints and raises
  ``SliceLost(cause="straggler")`` for ``runtime/elastic.py``.
* **elastic re-mesh** — ``remesh_state`` moves a train state from one mesh
  to another: each leaf gathered whole over the old mesh, each rank of the
  new one cutting its block. Pure data movement, bit for bit.

Across ranks every rank runs the loop. Two things keep them in step:

* The straggler decision is the same on every rank: with
  ``straggler_patience`` set, each step's time is the max over the mesh
  (one all-reduce on ``mesh.host_device``) before the timer sees it, so
  every rank escalates at the same step or none does. Without patience the
  alert only prints, as in the reference, and no collective is run.
* The restart path is sound for a failure every rank sees at the same step
  (an injected one, ``inject``). A failure raised on one rank alone leaves
  the others waiting in the step's next collective until the world's
  timeout: there is no cross-rank failure protocol, in the reference
  either.

Without a ``Checkpointer`` (``ckpt=None``) nothing is saved and a failure
raises instead of replaying.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..checkpoint.checkpointing import (Checkpointer, _flatten,
                                        _unflatten_into, fill_leaf,
                                        whole_leaf)
from ..parallel import collectives as C


class StragglerAlert(RuntimeError):
    def __init__(self, step: int, step_s: float, median_s: float):
        self.step, self.step_s, self.median_s = step, step_s, median_s
        super().__init__(
            f"step {step} took {step_s:.3f}s vs median {median_s:.3f}s")


class SliceLost(RuntimeError):
    """A device slice is gone — the surviving machine is a *different*
    ClusterSpec, so recovery is a planning problem, not just a restart.

    Raised by fault injection (standing in for the device watchdog) on
    slice death, and by ``run_with_recovery`` itself when stragglers exceed
    the patience budget (``cause="straggler"`` — graceful: the state was
    checkpointed first). ``dim``/``count`` name the torus dimension that
    lost ``count`` hyperplanes, feeding ``ClusterSpec.degraded``.
    """

    def __init__(self, step: int, *, dim: int = 0, count: int = 1,
                 cause: str = "failure", reason: str | None = None):
        self.step, self.dim, self.count, self.cause = step, dim, count, cause
        self.reason = reason or f"slice lost (torus dim {dim})"
        super().__init__(f"step {step}: {self.reason}")


@dataclass
class StepTimer:
    window: int = 32
    threshold: float = 3.0
    _times: deque = None

    def __post_init__(self):
        self._times = deque(maxlen=self.window)

    def observe(self, step: int, step_s: float):
        if len(self._times) >= 8:
            med = float(np.median(self._times))
            if step_s > self.threshold * med:
                # the straggler sample must NOT enter the window: appended,
                # a run of slow steps would drag the median up until the
                # detector stops firing on the very condition it watches
                raise StragglerAlert(step, step_s, med)
        self._times.append(step_s)

    def reset(self):
        """Drop the baseline — after an elastic re-mesh the plan (and its
        step time) has nothing in common with the old window."""
        self._times.clear()

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


@torch.no_grad()
def remesh_state(state, src_mesh, dst):
    """``state``, a train state placed on ``src_mesh`` (None: one process),
    copied into ``dst``, a train state of the same structure on another
    mesh or strategy (a built cell's ``train_state``), in place; returns
    ``dst``. Collective over ``src_mesh``: each leaf that is one rank's
    block is gathered whole there (every rank of ``src_mesh`` calls this,
    a rank outside the new mesh with ``dst=None``, and gets None), and
    each rank of the new mesh cuts its block (``shard_index``). Pure data
    movement: bit for bit per leaf (the counterpart of the reference's
    ``device_get`` then ``device_put``)."""
    targets = {} if dst is None else dict(_flatten(dst))
    out = {}
    for path, v in _flatten(state):       # one whole leaf at a time
        whole = whole_leaf(v, src_mesh) if isinstance(v, torch.Tensor) \
            else v
        if dst is None:
            continue
        if path not in targets:
            raise KeyError(f"the target state has no leaf {path}")
        target = targets[path]
        out[path] = fill_leaf(target, whole.to(target.device)) \
            if isinstance(target, torch.Tensor) else whole
    if dst is None:
        return None
    if out.keys() != targets.keys():
        raise KeyError(f"the source state has no leaves "
                       f"{sorted(set(targets) - set(out))}")
    return _unflatten_into(dst, out)


def _max_over(mesh, seconds: float) -> float:
    """The largest of every rank's ``seconds`` (one all-reduce over the
    mesh; the value itself on one process)."""
    if mesh is None or mesh.size == 1:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64,
                     device=mesh.host_device)
    return float(C.all_reduce_max(t, mesh.group(tuple(mesh.shape)))[0])


def _sync(metrics) -> None:
    loss = metrics["loss"]
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def run_with_recovery(step_fn, state, loader, ckpt: Checkpointer | None, *,
                      n_steps: int, start_step: int = 0,
                      ckpt_every: int = 50, async_ckpt: bool = True,
                      max_restarts: int = 3, timer: StepTimer | None = None,
                      inject_failure_at=None, inject=None,
                      straggler_patience: int | None = None,
                      skeleton=None, mesh=None, on_metrics=None):
    """Fault-tolerant train loop: checkpoint, detect, restore, replay.
    Returns ``(state, step)``.

    ``loader.batch_at(step)`` gives the batch of step ``step`` as
    ``step_fn(state, batch) -> (state, metrics)`` takes it.
    ``inject_failure_at`` simulates node failures (an int or an iterable of
    steps; each fires once) — the restart path end to end. ``inject``, when
    given, is called with the step index before it executes and may raise
    (``SliceLost`` propagates to the elastic controller, anything else
    takes the restart path) or return a simulated step duration in seconds
    for the straggler timer.

    ``straggler_patience``: after that many consecutive StragglerAlerts the
    loop checkpoints the (healthy, just slow) state and raises
    ``SliceLost(cause="straggler")``; across ranks (``mesh``) each step's
    time is first the max over the mesh. None: log and continue.

    A step is timed from its batch's arrival until the device has finished
    it; ``on_metrics(step, metrics)`` gets that time as
    ``metrics["step_s"]`` (the wall clock's, whatever ``inject`` returns).
    ``skeleton``: the state a restore fills (default: the live state).
    Every ``ckpt_every`` steps the state is saved (async unless
    ``async_ckpt`` is false), and once more, blocking, at the end unless the
    last save holds that step.
    """
    timer = timer or StepTimer()
    step = start_step
    restarts = 0
    seen_failure = False
    budget_anchor = None     # ckpt.latest_step() at the previous failure
    fail_steps = ({int(inject_failure_at)}
                  if isinstance(inject_failure_at, int)
                  else set(int(s) for s in inject_failure_at or ()))
    fired: set[int] = set()
    strikes = 0
    while step < n_steps:
        try:
            fake_dt = inject(step) if inject is not None else None
            batch = loader.batch_at(step)
            if step in fail_steps and step not in fired:
                fired.add(step)
                raise RuntimeError(f"injected node failure at step {step}")
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _sync(metrics)
            step_s = time.perf_counter() - t0
            dt = fake_dt if fake_dt is not None else step_s
            escalate = None
            if straggler_patience is not None:
                dt = _max_over(mesh, dt)      # one decision on every rank
            try:
                timer.observe(step, dt)
                strikes = 0
            except StragglerAlert as e:
                # synchronous SPMD: log-and-continue; repeated alerts
                # escalate to checkpoint-and-remesh around the slow host
                print(f"[straggler] {e}", flush=True)
                strikes += 1
                if straggler_patience is not None \
                        and strikes >= straggler_patience:
                    escalate = e
            if on_metrics:
                on_metrics(step, dict(metrics, step_s=step_s))
            step += 1
            if escalate is not None:
                # graceful: the state is intact, persist it before leaving
                if ckpt is not None:
                    ckpt.wait()
                    ckpt.save(state, step)
                raise SliceLost(
                    step, cause="straggler",
                    reason=f"{strikes} consecutive stragglers "
                           f"(last: {escalate})")
            if ckpt is not None and step % ckpt_every == 0:
                ckpt.save(state, step, blocking=not async_ckpt)
        except (StragglerAlert, SliceLost):
            raise
        except Exception as e:  # noqa: BLE001 — restart path
            if ckpt is None:
                raise
            ckpt.wait()          # an in-flight async save may still commit
            latest = ckpt.latest_step()
            key = -1 if latest is None else latest
            if seen_failure and key > (budget_anchor
                                       if budget_anchor is not None else -1):
                restarts = 0     # forward progress since the last failure
            seen_failure, budget_anchor = True, latest
            restarts += 1
            if restarts > max_restarts:
                raise
            print(f"[recovery] {e!r} → restoring from "
                  f"{'step ' + str(latest) if latest is not None else 'init'}",
                  flush=True)
            if latest is not None:
                state, step = ckpt.restore(
                    skeleton if skeleton is not None else state)
            else:
                step = start_step
    if ckpt is not None:
        ckpt.wait()
        if ckpt.latest_step() != step:
            ckpt.save(state, step)
    return state, step
