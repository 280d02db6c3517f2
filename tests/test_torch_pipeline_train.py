"""One step of the port's pipeline (``parallel/schedules``) on 4 gloo ranks
on the CPU, all 4 the stages of a (1, 4) mesh, against the port's serial
step from the same weights (seed 0) and batch:

* the smoke CosmoFlow (3 convs, 16³, width 8; 4 blocks), batch 8, S = 4,
  under gpipe, one_f_one_b and interleaved (v = 1: 4 blocks hold no 8
  chunks), against the plain step (it has no BatchNorm);
* a smoke ResNet-50 with stage sizes (2, 2, 2, 2) (10 blocks, so
  interleaved's v = 2 cuts 8 chunks), 32 px, batch 16, S = 4, under all
  three, against ``make_train_step(accum=4)``: BatchNorm takes its
  statistics per microbatch under the pipe, as in the reference. One AdamW
  step (1F1B, clipping at 1.0) as well.

Bars: the loss within 1e-5 relative, the updated parameters within 1e-4 in
relative L2 over the whole model, and so the update itself (new − initial
parameters: lr times the clipped gradient for SGD) within 1e-4; the
gradient norm the optimizer clipped by (the whole model's, one all-reduce
over the stages) within 1e-5. The serial steps run on rank 0 with the
ranks' one torch thread: at four samples a microbatch the last stage's
BatchNorm sees 4 values a channel, and another thread count's rounding
moves the loss by ~1e-6. On the CPU they read: loss ≤ 1.3e-7, parameters
≤ 5e-9, update ≤ 1.7e-6 (CosmoFlow: the loss summed over microbatches),
norm 0. A planted serial step with full-batch BatchNorm (``accum=1``) must
miss them: its loss is 19 % off and its update 7.2 in relative L2.

Also on the same spawn: each rank updates only the blocks it owns (the
others' parameters stay as they were) until ``gather_pipeline_state``,
after which every rank holds the same whole state; ``pipeline_segments``
reports the S the step ran, and a request that does not divide the batch
warns; ``validate`` measures and projects the pipeline row on the (2, 2)
mesh (all 4 ranks as stages of a (1, 4) regrid) and skips it, printing the
reason, where 4 stages exceed the blocks; ``measure_schedule_bubble``
gives its fit; and a stage whose peer never sends raises at the group's
timeout instead of hanging.
"""
import contextlib
import datetime
import io
import math
import warnings

import pytest
import torch
import torch.distributed as dist

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.oracle import OracleConfig, TimeModel, project
from repro_torch.core.validation import measure_schedule_bubble, validate
from repro_torch.launch.mesh import Group
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.cnn import (CosmoFlow, CosmoFlowConfig, ResNet,
                                    ResNetConfig)
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.schedules import (gather_pipeline_state,
                                            make_pipeline_train_step)
from repro_torch.parallel.schedules.runtime import StageProgram, gpipe
from repro_torch.training.steps import make_train_step, train_state

S = 4
CPU = ShardingCtx("cpu")
ARCHS = {
    "cosmoflow": (CosmoFlow, CosmoFlowConfig(img=16, n_conv=3, width=8),
                  (8, 16, 16, 16, 4)),
    "resnet": (ResNet, ResNetConfig("resnet-2222", (2, 2, 2, 2),
                                    n_classes=10), (16, 32, 32, 3)),
}
# (arch, schedule, interleaved v, optimizer)
CASES = [("cosmoflow", s, 1, "sgd")
         for s in ("gpipe", "one_f_one_b", "interleaved")] + [
    ("resnet", s, v, "sgd") for s, v in (("gpipe", 1), ("one_f_one_b", 1),
                                         ("interleaved", 2))] + [
    ("resnet", "one_f_one_b", 1, "adamw")]
OPT = {"sgd": OptimizerConfig(name="sgd", lr=3e-3, grad_clip=1e9),
       "adamw": OptimizerConfig(name="adamw", lr=3e-3, grad_clip=1.0)}


def _model(arch, **cfg_kw):
    cls, cfg, _ = ARCHS[arch]
    if cfg_kw:
        cfg = CosmoFlowConfig(**cfg_kw)
    return cls(cfg, device=torch.device("cpu"),
               generator=torch.Generator().manual_seed(0))


def _batch(arch, n=None):
    shape = ARCHS[arch][2]
    shape = (n or shape[0],) + shape[1:]
    gen = torch.Generator().manual_seed(1)
    other = ({"targets": torch.randn(shape[0], 4, generator=gen)}
             if arch == "cosmoflow" else
             {"labels": torch.randint(0, 10, (shape[0],), generator=gen)})
    return {"images": torch.randn(shape, generator=gen), **other}


def _serial(arch, opt, accum):
    """The port's serial step from the same weights: (loss, grad norm,
    initial and updated parameters)."""
    model = _model(arch)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, m = make_train_step(model, OPT[opt], CPU, accum=accum)(
        train_state(model, OPT[opt]), _batch(arch))
    return float(m["loss"]), float(m["grad_norm"]), init, {
        k: p.detach().clone() for k, p in state["params"].items()}


def _rel_l2(got, want):
    num = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in want)
    return (num / sum(float(want[k].double().square().sum())
                      for k in want)) ** 0.5


def _fingerprint(state):
    """Per-tensor float64 sums of the parameters and optimizer slots."""
    ts = list(state["params"].values()) + [
        t for slot in state["opt"].values() for t in slot.values()]
    return [float(t.detach().double().sum()) for t in ts]


def _case(mesh, arch, schedule, v, opt):
    model = _model(arch)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_pipeline_train_step(
        model, OPT[opt], ShardingCtx("cpu", mesh=mesh), segments=S,
        schedule=schedule, virtual_stages=v)
    state, m = step(train_state(model, OPT[opt]), _batch(arch))
    me = mesh.group("model").index
    params = dict(model.named_parameters())
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "S": m["pipeline_segments"], "bounds": step.bounds,
           "others_kept": all(torch.equal(params[k], init[k])
                              for k, r in step.owner.items() if r != me),
           "owned_moved": all(not torch.equal(params[k], init[k])
                              for k, r in step.owner.items() if r == me)}
    gather_pipeline_state(state, step)
    out["fingerprint"] = _fingerprint(state)
    out["params"] = {k: p.detach().clone() for k, p in params.items()}
    return out


def _silent_peer(mesh):
    """Rank 0 as the last of two stages whose first (rank 1) never sends,
    on a group with a 3 s timeout: the wait raises (the text is returned)."""
    pg = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=3))
    if mesh.rank != 0:
        return None
    program = StageProgram(
        Group(pg, (1, 0), 1, False), 2, lambda j, x: x, None,
        lambda m, y: y.sum(), lambda j: ((2,), torch.float32),
        torch.device("cpu"))
    with pytest.raises(RuntimeError) as err:
        gpipe(program, 2)
    return str(err.value)


def _ranks(mesh22):
    mesh = mesh22.regrid(1, 4)
    rank0 = mesh.rank == 0
    out = {"cases": {}, "serial": {}}
    if rank0:
        for key in (("cosmoflow", "sgd", 1), ("resnet", "sgd", S),
                    ("resnet", "adamw", S), ("resnet", "sgd", 1)):
            out["serial"][key] = _serial(*key)
    for case in CASES:
        res = _case(mesh, *case)
        if rank0:
            arch, _, _, opt = case
            _, _, init, new = out["serial"][arch, opt, 1 if arch ==
                                            "cosmoflow" else S]
            res["rel_params"] = _rel_l2(res["params"], new)
            res["rel_update"] = _rel_l2(
                {k: res["params"][k] - init[k] for k in init},
                {k: new[k] - init[k] for k in init})
            if case == ("resnet", "gpipe", 1, "sgd"):
                _, _, _, full = out["serial"]["resnet", "sgd", 1]
                res["planted"] = (_rel_l2(res["params"], full), _rel_l2(
                    {k: res["params"][k] - init[k] for k in init},
                    {k: full[k] - init[k] for k in init}))
        del res["params"]
        out["cases"][case] = res
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        step = make_pipeline_train_step(_model("cosmoflow"), OPT["sgd"],
                                        ShardingCtx("cpu", mesh=mesh),
                                        segments=3)
        m = step(train_state(_model("cosmoflow"), OPT["sgd"]),
                 _batch("cosmoflow"))[1]
    out["clipped"] = (m["pipeline_segments"],
                      [str(w.message) for w in got])
    ctx22 = ShardingCtx("cpu", mesh=mesh22)
    cluster = ClusterSpec.of("host")
    for name, kw in (("measured", {}), ("skipped", {"img": 16, "n_conv": 2,
                                                    "width": 8})):
        model = _model("cosmoflow", **kw)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pts = validate(model, model.cfg, _batch("cosmoflow"), ctx22,
                           ["pipeline"], flops_per_sample=1e6, B=8,
                           cluster=cluster)
        out[name] = (pts, buf.getvalue())
    out["bubble"] = measure_schedule_bubble(
        _model("cosmoflow"), lambda n: _batch("cosmoflow", n), ctx22,
        schedule="one_f_one_b", S_small=4, S_large=8, microbatch=1)
    out["silent"] = _silent_peer(mesh)
    out["serial"] = {k: v[:2] for k, v in out["serial"].items()}
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_ranks, 4, backend="gloo", device="cpu", model=2,
                     timeout_s=300)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_pipeline_step_matches_the_serial_step(ranks, case):
    """Loss, clipping norm, updated parameters and update against the
    serial step (CosmoFlow: plain; ResNet: at the microbatch size)."""
    arch, _, _, opt = case
    loss, norm = ranks[0]["serial"][arch, opt, 1 if arch == "cosmoflow"
                                    else S]
    for r in ranks:
        got = r["cases"][case]
        assert got["S"] == S
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (case, got, loss)
        assert abs(got["grad_norm"] - norm) <= 1e-5 * norm, (case, got, norm)
    got = ranks[0]["cases"][case]
    assert got["rel_params"] <= 1e-4, (case, got["rel_params"])
    assert got["rel_update"] <= 1e-4, (case, got["rel_update"])


def test_full_batch_batchnorm_misses_the_bar(ranks):
    """The serial step with BatchNorm over the whole batch is not what the
    pipeline computes: its loss and update lie far outside the bars."""
    loss, _ = ranks[0]["serial"]["resnet", "sgd", 1]
    got = ranks[0]["cases"]["resnet", "gpipe", 1, "sgd"]
    _, rel_update = got["planted"]
    assert abs(got["loss"] - loss) > 1e-2 * abs(loss)
    assert rel_update > 1.0


def test_owners_update_their_blocks_and_gather_makes_the_state_whole(ranks):
    """Before gather_pipeline_state each rank moved exactly its own blocks;
    after it every rank holds the same parameters and optimizer slots. The
    cuts are the same on every rank, and interleaved cuts 8 chunks."""
    for case in CASES:
        for r in ranks:
            got = r["cases"][case]
            assert got["others_kept"] and got["owned_moved"], case
            assert got["fingerprint"] == ranks[0]["cases"][case][
                "fingerprint"], case
            assert got["bounds"] == ranks[0]["cases"][case]["bounds"]
    assert len(ranks[0]["cases"]["resnet", "interleaved", 2, "sgd"][
        "bounds"]) == 9


def test_segments_clipped_and_reported(ranks):
    """segments=3 at batch 8 runs S = 2, reported, with a warning."""
    S_run, messages = ranks[0]["clipped"]
    assert S_run == 2
    assert any("requested 3, running S=2" in m for m in messages)


def test_validate_measures_or_skips_the_pipeline_row(ranks):
    """On the (2, 2) mesh validate measures the pipeline with 4 stages and
    projects it as project() does at S = clip_segments(8, 8) = 8; the
    3-block CosmoFlow is skipped with the reason printed."""
    pts, _ = ranks[0]["measured"]
    (pt,) = pts
    assert pt.strategy == "pipeline" and pt.p == 4
    assert math.isfinite(pt.measured_s) and pt.measured_s > 0
    cfg = CosmoFlowConfig(img=16, n_conv=3, width=8)
    cluster = ClusterSpec.of("host")
    want = project("pipeline", stats_for(cfg), TimeModel(cluster.system),
                   OracleConfig(B=8, D=8, segments=8,
                                **cluster.oracle_kw()), 4).total_s
    assert pt.projected_s == want
    pts, printed = ranks[0]["skipped"]
    assert pts == []
    assert "skipping pipeline — p=4 stages exceed the model's 3 blocks" in \
        printed


def test_schedule_bubble_fit_and_a_silent_peer(ranks):
    """measure_schedule_bubble fits t(S) = a·S + b over S = 4 and 8 (the
    same on every rank: the slowest rank's times) and keeps b unclamped
    beside the bubble it reports; a wait for a peer that
    never sends raises at the group's timeout."""
    b = ranks[0]["bubble"]
    assert b["schedule"] == "one_f_one_b"
    assert (b["S_small"], b["S_large"]) == (4, 8)
    for k in ("t_small_s", "t_large_s", "bubble_s", "bubble_fraction"):
        assert math.isfinite(b[k]) and b[k] >= 0
    assert b["bubble_s"] == max(b["intercept_s"], 0.0)
    assert b["bubble_fraction"] == pytest.approx(
        b["bubble_s"] / b["t_large_s"])
    assert all(r["bubble"] == b for r in ranks)
    assert "Timed out" in ranks[0]["silent"]
