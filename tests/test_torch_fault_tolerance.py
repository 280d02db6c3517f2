"""The port's fault-tolerance pieces against the reference's, in one process
(no ranks).

``Torus.without_slice`` and ``ClusterSpec.degraded`` give the reference's
surviving machine over a table of tori, lost dims, counts and model dims (a
model dim that vanishes included), and leave a cluster without a topology
as it is; both refuse a dim or a count the torus does not have.
``StepTimer`` gives the reference's alerts and medians on the same
step-time sequences (the outlier kept out of the window; ``reset`` drops
the baseline). The same toy step (a float64 vector and a counter) under the
same fault schedule goes through both packages' ``run_with_recovery``
with their own ``Checkpointer``: the steps attempted and completed with
their losses, the restores and their steps, the final step and state, and
the exception raised all agree — spaced failures that do not exhaust the
restart budget, a crash loop that does, a straggler escalation that saves
first, a failure before the first checkpoint (both replay from
``start_step`` on the live state: ROADMAP caveat o) and a lost slice.
``Oracle.with_cluster(cluster.degraded(0)).tune(2)`` is the reference's
plan for the chaos smoke's LM and for ResNet-50. ``run_elastic`` in one
process rides out a transient failure and a lost slice (p 1 → 1) with the
uninterrupted run's losses bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.cluster import ClusterSpec, Torus
from repro_torch.runtime.elastic import run_elastic
from repro_torch.runtime.fault_tolerance import (SliceLost, StepTimer,
                                                 run_with_recovery)

torch.set_num_threads(1)

# (dims, model_dims, lost dim, count)
TORI = (((2, 4), (1,), 0, 1), ((2, 4), (1,), 1, 2), ((2, 4), (1,), 1, 3),
        ((4, 4), None, 0, 3), ((2, 2), (0,), 0, 1), ((2, 2), (1,), 0, 1),
        ((8,), None, 0, 4), ((2, 2, 2), (0, 2), 1, 1),
        ((2, 2, 2), (0, 2), 0, 1), ((3, 2), (), 1, 1))
BAD = (((2, 4), None, 2, 1), ((2, 4), None, 0, 2), ((2, 4), None, -1, 1))


def test_degraded_machines_are_the_references():
    from repro.core.cluster import ClusterSpec as JClusterSpec
    from repro.core.cluster import Torus as JTorus
    for dims, md, dim, count in TORI:
        got = Torus(dims, md).without_slice(dim, count)
        want = JTorus(dims, md).without_slice(dim, count)
        assert (got.dims, got.model_dims) == (want.dims, want.model_dims), \
            (dims, md, dim, count, got, want)
        for name in ("host", "paper"):
            cs = dataclasses.replace(ClusterSpec.of(name),
                                     topology=Torus(dims, md))
            js = dataclasses.replace(JClusterSpec.of(name),
                                     topology=JTorus(dims, md))
            a, b = cs.degraded(dim, count), js.degraded(dim, count)
            assert a.to_json() == b.to_json()
            assert a.degraded(0, 0).name == b.degraded(0, 0).name \
                == f"{cs.name}-degraded"
    for dims, md, dim, count in BAD:
        for torus in (Torus(dims, md), JTorus(dims, md)):
            with pytest.raises(ValueError):
                torus.without_slice(dim, count)
    bare = ClusterSpec.of("host")
    assert bare.topology is None and bare.degraded(0) is bare


SEQUENCES = (
    [0.01] * 10 + [0.05] + [0.011] * 3 + [0.1, 0.1, 0.1, 0.01],
    [0.02, 0.01] * 6 + [0.07, 0.01, 0.2, 0.03, 0.019],
    [0.01] * 9 + [1.0] * 4 + ["reset"] + [0.5] * 9 + [2.0, 0.4],
)


@pytest.mark.parametrize("window", (32, 10))
def test_step_timer_is_the_references(window):
    from repro.runtime.fault_tolerance import StepTimer as JStepTimer

    def trace(timer):
        out = []
        for seq in SEQUENCES:
            timer.reset()
            for i, dt in enumerate(seq):
                if dt == "reset":
                    timer.reset()
                    out.append("reset")
                    continue
                try:
                    timer.observe(i, dt)
                    out.append((i, None, timer.median))
                except Exception as e:  # noqa: BLE001 — the alert itself
                    out.append((i, (type(e).__name__, str(e), e.step_s,
                                    e.median_s), timer.median))
        return out

    got = trace(StepTimer(window=window))
    want = trace(JStepTimer(window=window))
    assert got == want
    assert any(a is not None for _, a, _ in
               (x for x in got if x != "reset"))


class _Loader:
    def __init__(self, log):
        self.log = log

    def batch_at(self, step):
        self.log.append(("batch", step))
        return np.full(3, float(step))


def _recording(base):
    class Rec(base):
        def restore(self, skeleton, step=None, **kw):
            out = super().restore(skeleton, step, **kw)
            self.log.append(("restore", int(out[1])))
            return out
    return Rec


def _inject(case, log):
    fired = set()
    kill_at, fail_at, straggle, loop_at = case["faults"]

    def inject(step):
        log.append(("inject", step))
        if step == loop_at:
            raise RuntimeError(f"crash loop at step {step}")
        if step == kill_at and ("kill", step) not in fired:
            fired.add(("kill", step))
            raise case["SliceLost"](step, dim=0, reason="injected")
        if step in fail_at and ("fail", step) not in fired:
            fired.add(("fail", step))
            raise RuntimeError(f"injected node failure at step {step}")
        return straggle.get(step, 0.01)
    return inject


# (name, n_steps, (kill_at, fail_at, straggle, crash-loop step), kwargs)
CASES = (
    ("spaced", 20, (None, (5, 9, 13, 17), {}, None), {}),
    ("crash_loop", 20, (None, (), {}, 6), {}),
    ("straggler", 16, (None, (), {9: 9.9, 10: 9.9}, None),
     dict(straggler_patience=2)),
    ("before_first_checkpoint", 8, (None, (), {}, None),
     dict(inject_failure_at=2)),
    ("slice_lost", 12, (6, (), {}, None), {}),
)


def _drive(pkg, case, tmp):
    """One package's ``run_with_recovery`` on the toy step: the log of
    injections, batches, completed steps (with their losses) and restores,
    and the outcome (final step and state, or the exception)."""
    log = []
    if pkg == "torch":
        from repro_torch.checkpoint.checkpointing import Checkpointer as C
        lost = SliceLost
        run = run_with_recovery
        state = {"x": torch.zeros(3, dtype=torch.float64), "n": 0}

        def step_fn(st, batch):
            x = st["x"] * 0.5 + torch.from_numpy(batch)
            return {"x": x, "n": st["n"] + 1}, {"loss": x.sum()}
    else:
        from repro.checkpoint.checkpointing import Checkpointer as C
        from repro.runtime.fault_tolerance import SliceLost as lost
        from repro.runtime.fault_tolerance import run_with_recovery as run
        state = {"x": np.zeros(3), "n": 0}

        def step_fn(st, batch):
            x = np.asarray(st["x"]) * 0.5 + batch
            return {"x": x, "n": int(st["n"]) + 1}, {"loss": float(x.sum())}
    ckpt = _recording(C)(tmp / pkg, keep=10)
    ckpt.log = log
    name, n, faults, kw = case
    inject = _inject({"faults": faults, "SliceLost": lost}, log)
    try:
        state, step = run(
            step_fn, state, _Loader(log), ckpt, n_steps=n, ckpt_every=4,
            max_restarts=3, inject=inject,
            on_metrics=lambda s, m: log.append(("done", s,
                                                float(m["loss"]))), **kw)
        outcome = ("ok", step, [float(v) for v in np.asarray(state["x"])],
                   int(state["n"]))
    except Exception as e:  # noqa: BLE001 — the outcome compared
        outcome = ("raised", type(e).__name__, str(e))
        ckpt.wait()
    return log, outcome, ckpt.completed_steps()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_run_with_recovery_is_the_references(case, tmp_path):
    got = _drive("torch", case, tmp_path)
    want = _drive("jax", case, tmp_path)
    assert got[0] == want[0]
    assert got[1] == want[1]
    name = case[0]
    restores = [e for e in got[0] if e[0] == "restore"]
    if name == "spaced":
        assert got[1][0] == "ok" and len(restores) == 4
    elif name == "crash_loop":
        assert got[1][:2] == ("raised", "RuntimeError") and \
            len(restores) == 3
    elif name == "straggler":     # saved at 11 before it escalated
        assert got[1][:2] == ("raised", "SliceLost") and \
            11 in got[2] and 11 in want[2]
    elif name == "before_first_checkpoint":
        # replayed from start_step on the live state (caveat o)
        assert not restores and [e[1] for e in got[0] if e[0] == "done"] \
            == [0, 1, 0, 1, 2, 3, 4, 5, 6, 7]
    else:
        assert got[1][:2] == ("raised", "SliceLost")


def _same_plan(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k, v in w.items():
        if isinstance(v, float):
            np.testing.assert_allclose(g[k], v, rtol=1e-12, err_msg=k)
        else:
            assert g[k] == v, (k, g[k], v)
    assert got.describe() == want.describe()
    assert got.mesh_spec() == want.mesh_spec()


def _reference_chaos_session(monkeypatch):
    """The reference session of ``api.chaos_setup``'s LM and cluster."""
    import jax.numpy as jnp

    from repro import api as japi
    from repro.configs.base import SHAPES, ArchConfig, ShapeSpec
    from repro.core.cluster import ClusterSpec as JClusterSpec
    from repro.core.cluster import Torus as JTorus
    from repro.models import LMConfig
    from repro.nn import AttentionConfig, FFNConfig
    c = api.CHAOS
    V, D, L, B, S = (c[k] for k in "VDLBS")
    mc = LMConfig(name="t", vocab=V, d_model=D, n_layers=L,
                  attn=AttentionConfig(D, 4, 4, 8, dtype=jnp.float32),
                  ffn=FFNConfig(D, 2 * D, dtype=jnp.float32),
                  dtype=jnp.float32)
    monkeypatch.setitem(SHAPES, "train_tiny", ShapeSpec("train_tiny", S, B,
                                                        "train"))
    acfg = ArchConfig(name="chaos-smoke", family="lm", model=mc,
                      smoke_model=mc, source="chaos", strategy="df")
    cluster = dataclasses.replace(JClusterSpec.of("host"),
                                  topology=JTorus((2, 2), model_dims=(1,)))
    return japi.Oracle(acfg, "train_tiny", cluster, batch=B, seq=S)


@pytest.mark.parametrize("model", ("chaos-lm", "resnet50"))
def test_retuned_plans_are_the_references(model, monkeypatch):
    from repro import api as japi
    from repro.core.cluster import ClusterSpec as JClusterSpec
    from repro.core.cluster import Torus as JTorus
    if model == "chaos-lm":
        ses = api.chaos_setup()[0]
        jses = _reference_chaos_session(monkeypatch)
    else:
        torus = dict(model_dims=(1,))
        ses = api.Oracle("resnet50", "train_4k", dataclasses.replace(
            ClusterSpec.of("host"), topology=Torus((2, 2), **torus)),
            batch=32)
        jses = japi.Oracle("resnet50", "train_4k", dataclasses.replace(
            JClusterSpec.of("host"), topology=JTorus((2, 2), **torus)),
            batch=32)
    for p, s, j in ((4, ses, jses),
                    (2, ses.with_cluster(ses.cluster.degraded(0)),
                     jses.with_cluster(jses.cluster.degraded(0)))):
        got = s.tune(p, allow_pipeline=False)
        _same_plan(got, j.tune(p, allow_pipeline=False))
        assert bool(s.cluster.topology.split_mask(p, got.p1, got.p2,
                                                  got.strategy))


def test_run_elastic_in_one_process(tmp_path):
    """A transient failure at 3 and a lost slice at 6 (p 1 → 1: the
    degraded (1, 2) torus, re-tuned on the same device): the losses are
    the uninterrupted run's, bit for bit."""
    ses, data_cfg, opt = api.chaos_setup()

    def run(where, inject=None):
        losses, events = {}, []
        state, step, evs = run_elastic(
            ses, data_cfg, Checkpointer(tmp_path / where, keep=10),
            n_steps=9, device="cpu", opt=opt, ckpt_every=2, inject=inject,
            straggler_patience=None,
            on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
        return losses, evs, step, state

    fired = set()

    def faults(step):
        if step in (3, 6) and step not in fired:
            fired.add(step)
            if step == 6:
                raise SliceLost(step, dim=0)
            raise RuntimeError(f"injected node failure at step {step}")

    base, ev0, n0, _ = run("a")
    got, evs, n1, state = run("b", faults)
    assert ev0 == [] and n0 == n1 == 9 and got == base
    (ev,) = evs
    assert (ev.step, ev.cause, ev.p_before, ev.p_after, ev.resumed_from,
            ev.mesh_shape) == (6, "failure", 1, 1, 6, (1, 1))
    assert ev.cluster == f"{ses.cluster.name}-degraded" and \
        state["step"] == 9
