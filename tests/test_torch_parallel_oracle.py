"""The multi-rank calibration and the paper's Fig. 3 at p = 4 on 4 gloo
ranks on the CPU (one spawn; meshes (2, 2) and (1, 4)), on the smoke
CosmoFlow. Measured times are host timings here: only their structure is
pinned, never their values (ROADMAP caveat d). Projections are pinned
exactly: ``validate`` at p = 4 projects what ``project`` gives for the
same ClusterSpec, the hybrids with the mesh's (p1, p2), "spatial" as pure
spatial parallelism at p though it is measured under the ds rules (the
reference's quirk)."""
import math
from dataclasses import replace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.calibration import calibrate_cluster
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.oracle import OracleConfig, TimeModel, project
from repro_torch.core.validation import measure_step, validate
from repro_torch.data.pipeline import Loader
from repro_torch.launch import train
from repro_torch.launch.build import build_model
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.nn.module import ShardingCtx

STRATEGIES = ("data", "filter", "channel", "spatial", "df", "ds")
SIZES = (1 << 10, 1 << 14, 1 << 16)
BATCH = 4


def _ranks(mesh22):
    mesh14 = Mesh(1, 4, backend="gloo", device=torch.device("cpu"))
    cfg = get_config("cosmoflow")
    mc = cfg.smoke_model
    whole = ShardingCtx("cpu")
    model = build_model(cfg, whole, smoke=True)
    batch = Loader(train.data_config_for(mc, BATCH), whole.device).batch_at(0)
    flops = float(sum(s.flops_fwd for s in stats_for(mc)))
    out = {"flops": flops}
    for mesh in (mesh22, mesh14):
        spec, ms = calibrate_cluster(
            mesh, sizes=SIZES, loss_fn=lambda b: model.loss_fn(b, whole),
            params=model.parameters(), batch=batch,
            flops_per_step=flops * BATCH)
        ctx = ShardingCtx("cpu", mesh=mesh)
        pts = validate(model, mc, batch, ctx, STRATEGIES,
                       flops_per_sample=flops, B=BATCH, cluster=spec)
        out[mesh.shape["data"]] = (spec, [m.to_json() for m in ms], pts)
    raised = {}
    for s, exc in (("pipeline", ValueError), ("summa", NotImplementedError),
                   ("ep", NotImplementedError)):
        try:
            measure_step(model, batch, ShardingCtx("cpu", mesh=mesh22), s)
        except exc as e:
            raised[s] = str(e)
    out["raised"] = raised
    out["self"] = validate(model, mc, batch, ShardingCtx("cpu", mesh=mesh22),
                           ["data", "ds"], flops_per_sample=flops, B=BATCH)
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_ranks, 4, backend="gloo", device="cpu", model=2,
                     timeout_s=180)


@pytest.mark.parametrize("data", [2, 1])
def test_calibrate_cluster_measures_each_axis_of_extent_above_one(ranks,
                                                                 data):
    """Per mesh axis of extent > 1: an all-reduce and an all-gather series,
    a contention and an overlap measurement, fitted into that axis's level
    (α, β) and φ, σ; no axis of extent 1 is measured. Every rank fits the
    same ClusterSpec, its compute rate 1/4 of the one rank's measurement."""
    spec, ms, _ = ranks[0][data]
    axes = {"data": data, "model": 4 // data}
    wide = {a for a, n in axes.items() if n > 1}
    kinds = sorted((m["level"], m["kind"], m.get("pattern", "ar")
                    if m["kind"] == "collective" else "") for m in ms)
    assert kinds == sorted([(a, "collective", "ar") for a in wide]
                           + [(a, "collective", "ag") for a in wide]
                           + [(a, "contention", "") for a in wide]
                           + [(a, "overlap", "") for a in wide])
    for m in ms:
        if m["kind"] == "collective":
            assert m["p"] == axes[m["level"]]
            assert len(m["seconds"]) == len(SIZES)
            assert all(t > 0 and math.isfinite(t) for t in m["seconds"])
    for a in wide:
        lvl = spec.level(a)
        assert lvl.name == f"fit-{a}" and lvl.alpha >= 0 and lvl.beta >= 0
    assert {a for a, _ in spec.phi} == wide == {a for a, _ in spec.sigma}
    for r in ranks[1:]:
        assert r[data][0] == spec
    assert spec.peak_flops > 0 and spec.compute_efficiency == 1.0


@pytest.mark.parametrize("data", [2, 1])
def test_validate_at_p4_projects_as_project(ranks, data):
    """One point per strategy at p = 4 with a finite measured time (the
    same on every rank), projected exactly as ``project`` projects it under
    the cluster: df and ds at (p1, p2) = the mesh's (data, model), spatial
    as pure spatial parallelism at p."""
    r0 = ranks[0]
    spec, _, pts = r0[data]
    mc = get_config("cosmoflow").smoke_model
    stats = stats_for(mc)
    cfg = OracleConfig(B=BATCH, D=BATCH, **spec.oracle_kw())
    tm = TimeModel(spec.system)
    assert [pt.strategy for pt in pts] == list(STRATEGIES)
    for pt in pts:
        assert pt.p == 4
        assert math.isfinite(pt.measured_s) and pt.measured_s > 0
        kw = dict(p1=data, p2=4 // data) if pt.strategy in ("df", "ds") \
            else {}
        assert pt.projected_s == project(pt.strategy, stats, tm, cfg, 4,
                                         **kw).total_s
        assert pt.projected_serial_s == project(
            pt.strategy, stats, tm, replace(cfg, overlap=False), 4,
            **kw).total_s
    for r in ranks[1:]:
        assert [pt.measured_s for pt in r[data][2]] == \
            [pt.measured_s for pt in pts]


def test_unported_strategies_raise_and_self_calibration_runs(ranks):
    """summa and ep raise on a mesh, each naming its ROADMAP item; pipeline
    runs (tests/test_torch_pipeline_train.py), but not with the 4 ranks
    as stages of the smoke CosmoFlow's 3 blocks; ``validate`` without a
    cluster calibrates the ranks itself (compute on one rank, divided by p;
    α/β per axis) and gives finite points."""
    r0 = ranks[0]
    assert "4 stages × 1 virtual exceed 3 blocks" in r0["raised"]["pipeline"]
    assert "queue 1 item 8" in r0["raised"]["summa"]
    assert "queue 1 item 10" in r0["raised"]["ep"]
    for pt in r0["self"]:
        assert pt.p == 4
        for t in (pt.measured_s, pt.projected_s, pt.projected_serial_s):
            assert math.isfinite(t) and t > 0
