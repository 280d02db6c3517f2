"""The elastic runtime on 4 gloo ranks: the reference's chaos scenarios
(``tests/helpers/chaos_checks.py``) on the port, bit for bit.

One spawn of 4 ranks for the file (``launch.spawn.run_ranks``, one CPU
thread a rank). Every scenario drives ``runtime.elastic.run_elastic`` on
the chaos smoke's tiny fp32 LM (``api.chaos_setup``: a (2, 2) torus whose
model axis may ring only in dim 1) with a ``FaultPlan`` injector, and
holds the recovery contract bit for bit: the losses of the steps before
the fault equal an uninterrupted baseline's; the steps after it equal a
*planned* continuation on the degraded machine (the re-tuned plan bound on
the first 2 ranks, the baseline's own checkpoint restored, plain steps);
the final parameters, gathered whole, equal that continuation's; the
re-tuned plan is valid on the shrunken torus (``split_mask``).

* ``kill_midrun``: torus dim 0 dies before step 10 of 16 (checkpoints
  every 4): p 4 → 2, resumed from 8.
* ``straggler_burst``: simulated 9.9 s steps at 9 and 10 against a 10 ms
  pace exhaust patience 2: the state is saved at 11 and the run re-meshes
  from there, nothing replayed; the continuation is the baseline's state
  at 11 (its checkpoint at 8 and three plain steps) moved onto the
  survivors by ``remesh_state``.
* ``torn_checkpoint``: the kill also tears the newest checkpoint (8): the
  run falls back to 4.
* ``transient_spaced``: four transient failures over 20 steps with
  ``max_restarts=3``: no elastic event, every loss and the final
  parameters the baseline's.

Every undeclared step reports the FaultPlan's pace (10 ms) to the
straggler watch, so a loaded host's real step times cannot reshape a run.
The same scenarios go through the reference's ``run_elastic`` on 4
virtual CPU devices in a subprocess (``python <this file> <out>``), with
the same FaultPlans and the same LM: every scenario's elastic events
(step, cause, p before and after, the re-tuned strategy and mesh, the
step resumed from, the surviving cluster's name), the steps attempted,
the steps completed and the steps restored are the reference's.
Then ``remesh_state`` round trips a train state between the (2, 2) mesh
under df, the (4, 1) mesh under data with ZeRO-1 (the AdamW moments split
over "data") and back, and onto the survivors' (2, 1) mesh under data with
ZeRO-1, every leaf bit for bit; ``launch.train.main(["--elastic", ...])``
on the spawn's ranks gives ``run_elastic``'s losses; ``python -m
repro_torch.api --chaos --device cpu`` runs on the spawn's world and
exits 0. Not marked ``chaos``: these count in tier-1.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

import pytest
import torch

from repro_torch import api
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointing import _flatten, whole_leaf
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.cluster import ClusterSpec
from repro_torch.launch import train
from repro_torch.launch.build import build_cell
from repro_torch.launch.spawn import run_ranks
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.runtime.elastic import (bind_plan, planned_continuation,
                                         run_elastic, whole_params)
from repro_torch.runtime.fault_tolerance import SliceLost, remesh_state
from repro_torch.training.steps import train_state

torch.set_num_threads(1)

PACE = 0.01          # the simulated seconds of every undeclared step
N, N_LONG, EVERY = 16, 20, 4


def tear_latest(ckpt) -> int:
    """Simulate a torn write: the newest checkpoint loses its commit
    marker (arrays and manifest still present, ``.complete`` gone), as if
    the failure landed mid-save. Returns the torn step."""
    steps = ckpt.completed_steps()
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint in {ckpt.dir}")
    (ckpt.dir / f"step_{steps[-1]:08d}" / ".complete").unlink()
    return steps[-1]


@dataclass
class FaultPlan:
    """The reference's fault plan (``tests/helpers/fault_plan.py``) for
    the port: what breaks and when, compiled by ``injector`` into
    ``run_elastic``'s ``inject`` hook. Each fault fires once per declared
    step. ``kill_at``: step → torus dim (``SliceLost``); ``fail_at``:
    transient ``RuntimeError``s; ``straggle``: step → simulated seconds;
    ``tear_on_kill``: a kill first tears the newest checkpoint (on the
    writer, between two barriers, so every rank then sees it torn);
    ``pace``: the simulated seconds of every other step. ``lost``: the
    package's ``SliceLost`` (the reference's in its witness)."""

    kill_at: dict = field(default_factory=dict)
    fail_at: tuple = ()
    straggle: dict = field(default_factory=dict)
    tear_on_kill: bool = False
    pace: float = PACE

    def injector(self, ckpt=None, lost=SliceLost):
        if self.tear_on_kill and ckpt is None:
            raise ValueError("tear_on_kill needs the Checkpointer")
        fired: set = set()

        def inject(step: int):
            if step in self.kill_at and ("kill", step) not in fired:
                fired.add(("kill", step))
                if self.tear_on_kill:
                    ckpt.wait()
                    mesh = getattr(ckpt, "mesh", None)
                    if mesh is None or mesh.rank == 0:
                        tear_latest(ckpt)
                    ckpt.wait()
                raise lost(step, dim=self.kill_at[step],
                           reason=f"injected slice death at step {step}")
            if step in self.fail_at and ("fail", step) not in fired:
                fired.add(("fail", step))
                raise RuntimeError(f"injected node failure at step {step}")
            return self.straggle.get(step, self.pace)

        return inject


# (name, steps, fault plan, run_elastic's keywords): the reference's
# four scenarios and the uninterrupted baseline they are held against
SCENARIOS = (
    ("base", N_LONG, FaultPlan(), {}),
    ("kill_midrun", N, FaultPlan(kill_at={10: 0}), {}),
    ("torn_checkpoint", N, FaultPlan(kill_at={10: 0}, tear_on_kill=True),
     {}),
    ("straggler_burst", N, FaultPlan(straggle={9: 9.9, 10: 9.9}),
     dict(straggler_patience=2)),
    ("transient_spaced", N_LONG, FaultPlan(fail_at=(5, 9, 13, 17)),
     dict(max_restarts=3)),
)


class _Record:
    """What a package's elastic run did: the steps attempted (each call of
    the fault hook), completed (in order, replays included) and restored,
    the final step and the events."""

    def __init__(self):
        self.attempted, self.done, self.restores = [], [], []

    def inject(self, hook):
        def inject(step):
            self.attempted.append(int(step))
            return hook(step)
        return inject

    @contextlib.contextmanager
    def restoring(self, checkpointer):
        """``checkpointer.restore`` logging the step each call restores."""
        plain = checkpointer.restore

        def restore(ck, skeleton, step=None, **kw):
            out = plain(ck, skeleton, step, **kw)
            self.restores.append(int(out[1]))
            return out
        checkpointer.restore = restore
        try:
            yield
        finally:
            checkpointer.restore = plain

    def summary(self, step, events) -> dict:
        return {"attempted": self.attempted, "done": self.done,
                "restores": self.restores, "step": int(step),
                "events": [{k: [int(x) for x in v] if k == "mesh_shape"
                            else v if isinstance(v, str) else int(v)
                            for k, v in dataclasses.asdict(e).items()}
                           for e in events]}


def _run(mesh, setup, where, n, fault, **kw):
    """One elastic run: the losses by step, the record and, on a survivor,
    the final parameters whole."""
    ses, data_cfg, opt = setup
    ckpt = Checkpointer(where, keep=10, mesh=mesh)
    traj, meshes, rec = {}, [], _Record()

    def on_metrics(s, m):
        traj[s] = float(m["loss"])
        rec.done.append(s)
    with rec.restoring(Checkpointer):
        state, step, events = run_elastic(
            ses, data_cfg, ckpt, n_steps=n, mesh=mesh, device="cpu",
            opt=opt, ckpt_every=EVERY, inject=rec.inject(fault.injector(
                ckpt)), seed=0, on_bind=lambda b: meshes.append(b.mesh),
            on_metrics=on_metrics, **kw)
    out = {"traj": traj, "events": events, "step": step,
           "record": rec.summary(step, events)}
    if state is not None:
        out["params"] = whole_params(state, meshes[-1])
    return out


def _degraded_run(mesh, setup, lo, n, **source):
    """Plain steps lo..n-1 of the plan re-tuned on the degraded cluster on
    the first 2 ranks (``planned_continuation``), from a checkpoint or a
    train state moved there."""
    ses, data_cfg, opt = setup
    return planned_continuation(
        ses.with_cluster(ses.cluster.degraded(dim=0)), mesh, 2, data_cfg,
        opt, n, step=lo, device="cpu", seed=0, **source)


def _scenarios(mesh, root, setup) -> dict:
    out = {name: _run(mesh, setup, f"{root}/{name}", n, fault, **kw)
           for name, n, fault, kw in SCENARIOS}
    base = Checkpointer(f"{root}/base")
    out["kill_midrun_ref"] = _degraded_run(mesh, setup, 8, N, ckpt=base)
    out["torn_checkpoint_ref"] = _degraded_run(mesh, setup, 4, N, ckpt=base)
    # the baseline's state at 11: its checkpoint at 8 and 3 plain steps on
    # the full plan, then moved onto the survivors
    ses, data_cfg, opt = setup
    b1 = bind_plan(ses, mesh, mesh.size, data_cfg, opt, device="cpu", seed=0)
    st = base.restore(b1.state, step=8)[0]
    for s in range(8, 11):
        st, _ = b1.step_fn(st, b1.loader.batch_at(s))
    out["straggler_burst_ref"] = _degraded_run(mesh, setup, 11, N, state=st,
                                               src_mesh=b1.mesh)
    return out


def _whole_state(state, mesh) -> dict:
    return {p: whole_leaf(v, mesh).clone() if isinstance(v, torch.Tensor)
            else v for p, v in _flatten(state)}


def _remesh(mesh) -> dict:
    """(2, 2) df → (4, 1) data with ZeRO-1 → back to (2, 2) df, and
    (4, 1) → the survivors' (2, 1) under data with ZeRO-1: every leaf of
    each destination, gathered whole, against its source's."""
    ses, _, _ = api.chaos_setup()
    shape = ShapeSpec("train_tiny", ses.seq, ses.B, "train")

    def state_on(m, strategy, zero1, seed):
        if m is None:
            return None, None
        opt = OptimizerConfig(name="adamw", zero1=zero1)
        cell = build_cell(ses.arch_cfg, shape, m, strategy, opt=opt,
                          device="cpu", seed=seed)
        return train_state(cell.model, opt, cell.ctx), cell.ctx.mesh

    a, mesh22 = state_on(mesh, "df", False, 0)
    with torch.no_grad():                # distinct values in every slot
        for i, slot in enumerate(a["opt"].values()):
            for t in slot.values():
                t.normal_(generator=torch.Generator().manual_seed(i))
    a["step"] = 5
    want = _whole_state(a, mesh22)
    b, mesh41 = state_on(mesh.regrid(4, 1), "data", True, 1)
    split = any("data" in axes for t in b["opt"]["m"].values()
                for axes in getattr(t, "place", ()))
    b = remesh_state(a, mesh22, b)
    back, _ = state_on(mesh, "df", False, 2)
    back = remesh_state(b, mesh41, back)
    c, mesh21 = state_on(mesh41.shrink(2, 1), "data", True, 3)
    got_b = _whole_state(b, mesh41)
    c = remesh_state(b, mesh41, c)
    out = {"split": split,
           "to_41": _equal(got_b, want),
           "back_to_22": _equal(_whole_state(back, mesh22), want)}
    if c is not None:
        out["to_21"] = _equal(_whole_state(c, mesh21), want)
    return out


def _equal(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        torch.equal(got[k], v) if isinstance(v, torch.Tensor)
        else got[k] == v for k, v in want.items())


TRAINER = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu", "--batch",
           "8", "--seq", "32", "--steps", "6"]


def _trainer(mesh, root) -> dict:
    """``launch.train --elastic`` and ``run_elastic`` with the trainer's
    arguments."""
    from repro_torch.api import Oracle
    got = train.main(TRAINER + ["--elastic", "--ckpt-dir",
                                f"{root}/trainer"])
    cfg = get_config("qwen1.5-4b")
    ses = Oracle(cfg, "train_4k", ClusterSpec.of("host"), smoke=True,
                 batch=8, seq=32)
    losses = []
    run_elastic(ses, train.data_config_for(cfg.smoke_model, 8, 32, 0),
                Checkpointer(f"{root}/direct", mesh=mesh), n_steps=6,
                mesh=mesh, device="cpu", opt=OptimizerConfig(lr=3e-3),
                ckpt_every=50, straggler_patience=3, cell_kw=dict(q_chunk=32),
                on_metrics=lambda s, m: losses.append(float(m["loss"])))
    return {"trainer": got["losses"], "direct": losses,
            "events": got["events"], "strategy": got["strategy"],
            "saves": [s["step"] for s in got["ckpt_saves"]]}


def _ranks(mesh, root):
    out = {"scenarios": _scenarios(mesh, root, api.chaos_setup()),
           "remesh": _remesh(mesh), "trainer": _trainer(mesh, root)}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = api.main(["--chaos", "--device", "cpu"])
    out["cli"] = (rc, text.getvalue())
    return out


# ---------------------------------------------------------------------------
# The witness: the reference's run_elastic on 4 virtual CPU devices
# ---------------------------------------------------------------------------

def _witness(out_path):
    """Every scenario of SCENARIOS through the reference's ``run_elastic``
    on the chaos smoke's LM and (2, 2) torus (``api.chaos_setup``'s, built
    in the reference), with the same FaultPlans; each run's record
    written as JSON."""
    import jax
    import jax.numpy as jnp

    from repro.api import Oracle as JOracle
    from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
    from repro.configs.base import SHAPES, ArchConfig
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.core.cluster import ClusterSpec as JClusterSpec
    from repro.core.cluster import Torus as JTorus
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.models import LMConfig, TransformerLM
    from repro.nn import AttentionConfig, FFNConfig
    from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
    from repro.runtime.elastic import run_elastic as j_run_elastic
    from repro.runtime.fault_tolerance import SliceLost as JSliceLost
    assert len(jax.devices()) == 4, jax.devices()
    c = api.CHAOS
    V, D, L, B, S = (c[k] for k in "VDLBS")
    f32 = jnp.float32
    mc = LMConfig(name="t", vocab=V, d_model=D, n_layers=L,
                  attn=AttentionConfig(D, 4, 4, 8, dtype=f32),
                  ffn=FFNConfig(D, 2 * D, dtype=f32), dtype=f32)
    SHAPES["train_tiny"] = JShapeSpec("train_tiny", S, B, "train")
    acfg = ArchConfig(name="chaos-smoke", family="lm", model=mc,
                      smoke_model=mc, source="chaos", strategy="df")
    cluster = dataclasses.replace(JClusterSpec.of("host"),
                                  topology=JTorus((2, 2), model_dims=(1,)))
    ses = JOracle(acfg, "train_tiny", cluster, batch=B, seq=S)
    data_cfg = JDataConfig("lm", batch=B, seq_len=S, vocab=V)
    opt = JOptimizerConfig(lr=1e-2, name="adamw", zero1=False)
    model = TransformerLM(mc)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        # each run binds its plans anew: the later runs' steps compile
        # from the first's cache
        jax.config.update("jax_compilation_cache_dir", f"{root}/xla")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        for name, n, fault, kw in SCENARIOS:
            rec = _Record()
            ckpt = JCheckpointer(f"{root}/{name}", keep=10)
            with rec.restoring(JCheckpointer):
                _, step, events = j_run_elastic(
                    ses, data_cfg, ckpt, n_steps=n, model=model, opt=opt,
                    ckpt_every=EVERY, seed=0,
                    inject=rec.inject(fault.injector(ckpt, JSliceLost)),
                    fwd_kw=dict(attn_impl="plain", scan_layers=False,
                                remat=False),
                    on_metrics=lambda s, m, rec=rec: rec.done.append(int(s)),
                    **kw)
            out[name] = rec.summary(step, events)
    Path(out_path).write_text(json.dumps(out))
    print("WITNESS-WRITTEN")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's 4 ranks, with the reference's witness running beside
    them in its subprocess."""
    root = tmp_path_factory.mktemp("chaos")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    with subprocess.Popen([sys.executable, __file__, str(root / "ref.json")],
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as witness:
        try:
            res = run_ranks(_ranks, 4, str(root), backend="gloo",
                            device="cpu", model=2, timeout_s=420)
            stdout, stderr = witness.communicate(timeout=300)
        finally:
            witness.kill()
    assert "WITNESS-WRITTEN" in stdout, stdout + stderr[-3000:]
    return res, json.loads((root / "ref.json").read_text())


def _same(traj, ref, lo, hi, what):
    for s in range(lo, hi):
        assert traj[s] == ref[s], f"{what}: step {s}: {traj[s]!r} " \
                                  f"!= {ref[s]!r}"


def _replan_valid(ev, setup):
    ses = setup[0]
    degraded = ses.cluster.degraded(dim=0)
    p1, p2 = ev.mesh_shape
    assert ev.p_before == 4 and ev.p_after == 2 == p1 * p2, ev
    assert bool(degraded.topology.split_mask(2, p1, p2, ev.strategy)), ev


def _survivor_checks(res, name, resumed):
    """Rank 0 and 1 (the survivors): one event, resumed from ``resumed``,
    prefix against the baseline, suffix and final parameters against the
    planned continuation, the plan the continuation's."""
    setup = api.chaos_setup()
    for r in res[:2]:
        sc = r["scenarios"]
        got, base, ref = sc[name], sc["base"], sc[name + "_ref"]
        (ev,) = got["events"]
        assert ev.resumed_from == resumed and got["step"] == N, ev
        _replan_valid(ev, setup)
        plan = ref["plan"]
        assert (ev.strategy, *ev.mesh_shape) == (plan.strategy, plan.p1,
                                                 plan.p2)
        _same(got["traj"], base["traj"], 0, resumed, "prefix vs baseline")
        _same(got["traj"], ref["losses"], resumed, N,
              "suffix vs planned reshape")
        for k, v in ref["params"].items():
            assert torch.equal(got["params"][k], v), k
    for r in res[2:]:               # left out: the event, no state
        got = r["scenarios"][name]
        assert "params" not in got and len(got["events"]) == 1
        assert r["scenarios"][name + "_ref"] is None


def test_kill_midrun(ranks):
    ranks, _ = ranks
    _survivor_checks(ranks, "kill_midrun", 8)
    assert ranks[0]["scenarios"]["kill_midrun"]["events"][0].cause \
        == "failure"


def test_straggler_burst(ranks):
    ranks, _ = ranks
    _survivor_checks(ranks, "straggler_burst", 11)
    ev = ranks[0]["scenarios"]["straggler_burst"]["events"][0]
    assert ev.cause == "straggler" and ev.step == 11


def test_torn_checkpoint(ranks):
    ranks, _ = ranks
    _survivor_checks(ranks, "torn_checkpoint", 4)


def test_transient_spaced(ranks):
    ranks, _ = ranks
    for r in ranks:
        sc = r["scenarios"]
        got, base = sc["transient_spaced"], sc["base"]
        assert got["events"] == [] and sc["base"]["events"] == []
        _same(got["traj"], base["traj"], 0, N_LONG, "trajectory vs baseline")
        for k, v in base["params"].items():
            assert torch.equal(got["params"][k], v), k


def test_remesh_state_round_trips_bit_for_bit(ranks):
    ranks, _ = ranks
    for r in ranks:
        assert r["remesh"]["split"]        # ZeRO-1's moments are blocks
        assert r["remesh"]["to_41"] and r["remesh"]["back_to_22"]
    assert all(r["remesh"]["to_21"] for r in ranks[:2])
    assert all("to_21" not in r["remesh"] for r in ranks[2:])


def test_the_elastic_trainer_is_run_elastic(ranks):
    ranks, _ = ranks
    for r in ranks:
        t = r["trainer"]
        assert len(t["trainer"]) == 6 and t["trainer"] == t["direct"]
        assert t["events"] == [] and t["saves"] == [6]
        assert t["strategy"] is not None


def test_the_elastic_trainer_needs_a_checkpoint_directory():
    with pytest.raises(SystemExit, match="--ckpt-dir"):
        train.main(TRAINER + ["--elastic"])


def test_the_chaos_cli_on_the_spawned_world(ranks):
    ranks, _ = ranks
    rc, text = ranks[0]["cli"]
    assert rc == 0 and "repro_torch.api --chaos OK" in text
    assert "p 4→2" in text and "resumed @ 8" in text
    assert all(r["cli"][0] == 0 for r in ranks)


@pytest.mark.parametrize("name", [sc[0] for sc in SCENARIOS])
def test_the_scenarios_are_the_references(ranks, name):
    """Rank 0's run (rank 0 always survives) against the reference's on 4
    virtual devices: the same events, steps attempted, completed and
    restored, and final step."""
    ranks, ref = ranks
    got = ranks[0]["scenarios"][name]["record"]
    want = ref[name]
    assert got["events"] == want["events"]
    assert got["restores"] == want["restores"]
    assert got["attempted"] == want["attempted"]
    assert got["done"] == want["done"]
    assert got["step"] == want["step"]


if __name__ == "__main__":
    _witness(sys.argv[1])
