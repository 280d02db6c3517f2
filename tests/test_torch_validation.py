"""The port's calibration and validation (the paper's Fig. 3 at p = 1) on the
CPU, against the JAX package's oracle where they project: with a given
cluster, ``validate``'s projections equal the reference's ``project`` under
the same system model (1e-12 relative, 0 expected). Measured times are
host timings here: only their structure is pinned, never their values
(ROADMAP caveat d)."""
import math

import pytest
import torch

from repro.core.hardware import Level as JLevel
from repro.core.hardware import SystemModel as JSystemModel
from repro.core.layer_stats import stats_for as j_stats_for
from repro.core.oracle import OracleConfig as JOracleConfig
from repro.core.oracle import TimeModel as JTimeModel
from repro.core.oracle import project as j_project
from repro.core.validation import ValidationPoint as JValidationPoint
from repro.core.validation import accuracy_report as j_accuracy_report
from repro.models.cnn import CosmoFlowConfig as JCosmoFlowConfig
from repro.models.cnn import VGGConfig as JVGGConfig
from repro_torch.configs import get_config
from repro_torch.core import calibration
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.hardware import (Level, SystemModel, cpu_host_model,
                                       cuda_device_model)
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.oracle import STRATEGY_NAMES
from repro_torch.core.validation import (ValidationPoint, accuracy_report,
                                         measure_step, validate)
from repro_torch.data.pipeline import Loader
from repro_torch.launch import train
from repro_torch.launch.build import build_model
from repro_torch.nn.module import ShardingCtx

CPU = ShardingCtx("cpu")
# (port arch, the reference's smoke config of it)
SMOKES = [("vgg16", JVGGConfig(name="vgg16-smoke", n_classes=10, img=32)),
          ("cosmoflow", JCosmoFlowConfig(img=16, n_conv=2, width=8))]


def _smoke(arch, batch=2):
    cfg = get_config(arch)
    model = build_model(cfg, CPU, smoke=True)
    data = train.data_config_for(cfg.smoke_model, batch)
    return cfg.smoke_model, model, Loader(data, CPU.device).batch_at(0)


def _flops(mc) -> float:
    return float(sum(s.flops_fwd for s in stats_for(mc)))


@pytest.mark.parametrize("arch,jcfg", SMOKES)
def test_validate_with_a_cluster_projects_as_the_reference(arch, jcfg):
    """A cluster with its own φ and σ tables: the point's projections (with
    and without overlap) are the reference's ``project("data", ...)`` at
    p = 1 under the same system model and those tables."""
    mc, model, batch = _smoke(arch)
    lvl = ("shm", 2e-5, 1 / 9e9)
    sysm = SystemModel("probe", 3e11, 2e11, 4e9, 0.7, tuple(
        (ax, Level(*lvl)) for ax in ("model", "data", "pod")))
    jsysm = JSystemModel("probe", 3e11, 2e11, 4e9, 0.7, tuple(
        (ax, JLevel(*lvl)) for ax in ("model", "data", "pod")))
    cluster = ClusterSpec.from_system(sysm, phi=(("data", 1.5),),
                                      sigma=(("data", 0.5),))
    pts = validate(model, mc, batch, CPU, ["serial", "data"],
                   flops_per_sample=_flops(mc), B=2, cluster=cluster)
    assert [(pt.strategy, pt.p) for pt in pts] == [("data", 1)]
    kw = dict(B=2, D=2, phi_levels=(("data", 1.5),),
              sigma_levels=(("data", 0.5),))
    jstats, jtm = j_stats_for(jcfg), JTimeModel(jsysm)
    want = j_project("data", jstats, jtm, JOracleConfig(**kw), 1).total_s
    want_serial = j_project("data", jstats, jtm,
                            JOracleConfig(overlap=False, **kw), 1).total_s
    for got, ref in ((pts[0].projected_s, want),
                     (pts[0].projected_serial_s, want_serial)):
        assert abs(got - ref) <= 1e-12 * ref
    assert math.isfinite(pts[0].measured_s) and pts[0].measured_s > 0


def test_self_calibrated_validate_on_the_cpu():
    """Without a cluster the CPU is calibrated on the model itself (the
    reference's default): one "data" point at p = 1, where no term
    communicates, so the overlap and serial projections agree."""
    mc, model, batch = _smoke("cosmoflow")
    pts = validate(model, mc, batch, CPU, ["data"],
                   flops_per_sample=_flops(mc), B=2)
    assert len(pts) == 1
    pt = pts[0]
    assert (pt.strategy, pt.p) == ("data", 1)
    assert pt.projected_s > 0 and pt.measured_s > 0
    assert pt.projected_s == pt.projected_serial_s
    assert math.isfinite(pt.accuracy)


def test_accuracy_report_matches_the_reference():
    rows = [("data", 0.100, 0.080, 0.080), ("data", 0.250, 0.300, 0.310),
            ("data", 0.040, 0.039, 0.045)]
    pts = [ValidationPoint(s, 1, m, p, q) for s, m, p, q in rows]
    jpts = [JValidationPoint(s, 1, m, p, q) for s, m, p, q in rows]
    assert accuracy_report(pts) == j_accuracy_report(jpts)
    assert [pt.accuracy for pt in pts] == pytest.approx([0.8, 0.8, 0.975])
    assert pts[2].accuracy_serial == pytest.approx(1 - 0.005 / 0.04)
    assert ValidationPoint("data", 1, 0.0, 1.0).accuracy == 0.0
    assert accuracy_report(pts).splitlines()[-1].split()[-1] == "85.8%"


def test_calibrate_compute_backs_out_the_rate(monkeypatch):
    """rate = 3·flops_per_step / t (fwd + bwd ≈ 3× the forward) at
    efficiency 1 on the base model; the timed function is a forward and a
    backward (gradients of every parameter, no update)."""
    mc, model, batch = _smoke("vgg16")
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    seen = {}

    def fake_time_fn(fn, *args, device, iters=5, warmup=2):
        seen["grads"] = fn(*args)
        seen["device"] = device
        return 0.25

    monkeypatch.setattr(calibration, "time_fn", fake_time_fn)
    base = cpu_host_model(alpha=1e-5)
    sysm = calibration.calibrate_compute(
        lambda b: model.loss_fn(b, CPU), params, batch, 1e9, base=base)
    assert sysm.peak_flops == 1e9 * 3.0 / 0.25
    assert sysm.compute_efficiency == 1.0
    assert (sysm.name, sysm.hbm_bw, sysm.levels) == \
        (base.name, base.hbm_bw, base.levels)
    assert seen["device"] == torch.device("cpu")
    assert [g.shape for g in seen["grads"]] == [p.shape for p in params]
    assert all(torch.equal(a, p) for a, p in zip(before, params))
    host = calibration.calibrate_host_system(
        lambda b: model.loss_fn(b, CPU), params, batch, 2e9)
    assert host == cpu_host_model(flops=2e9 * 3.0 / 0.25)


def test_time_fn_on_the_cpu_takes_the_median():
    calls = []
    t = calibration.time_fn(lambda x: calls.append(x), 7, device="cpu",
                            iters=3, warmup=2)
    assert calls == [7] * 5
    assert 0 <= t < 1
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        calibration.time_fn(lambda: None, device="meta")


def test_measure_step_runs_data_only():
    """At p = 1 only "data" runs; "serial" is not executable (as in the
    reference), every other strategy needs the parallel slice, an unknown
    name is a KeyError."""
    _, model, batch = _smoke("cosmoflow")
    assert measure_step(model, batch, CPU, "data") > 0
    for s in STRATEGY_NAMES:
        if s == "data":
            continue
        with pytest.raises(NotImplementedError,
                           match="not executable" if s == "serial"
                           else "queue 1 item 6"):
            measure_step(model, batch, CPU, s)
    with pytest.raises(KeyError, match="bogus"):
        measure_step(model, batch, CPU, "bogus")
    mc, model, batch = _smoke("vgg16")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        validate(model, mc, batch, CPU, ["data", "filter"],
                 flops_per_sample=_flops(mc), B=2, cluster=ClusterSpec.of(
                     "host"))


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardingCtx("cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_device_model("cpu", hbm_bw=1e12, flops=1e12)
    with pytest.raises(ValueError, match="CUDA device's memory"):
        calibration.measure_hbm_bw("cpu")
