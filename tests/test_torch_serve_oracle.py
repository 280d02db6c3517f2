"""The port's serving oracle and traffic model (serve/oracle.py,
serve/traffic.py) against the JAX package's: the same traces bit for bit,
and every priced field within 1e-12 relative (the port's copy does the same
arithmetic, in another order only where its layer stats sum differently),
with every bail reason equal, on the CPU host model and on the paper's
cluster (a ClusterSpec); Qwen1.5-4B at its published widths and at smoke
width, whose KV bytes are what the engine pages."""
import dataclasses
import math

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core.cluster import ClusterSpec as JClusterSpec
from repro.core.hardware import cpu_host_model as j_cpu_host_model
from repro.serve import TrafficModel as JTrafficModel
from repro.serve import kv_bytes_per_token as j_kv_bytes_per_token
from repro.serve import price_serving as j_price_serving
from repro.serve import serve_sweep as j_serve_sweep
from repro.serve import serve_tune as j_serve_tune
from repro_torch.configs import get_config
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.hardware import cpu_host_model
from repro_torch.serve import (SERVE_STRATEGIES, TrafficModel,
                               kv_bytes_per_token, price_serving,
                               serve_sweep, serve_tune)

RTOL = 1e-12
SYSTEMS = {"cpu-host": (cpu_host_model, j_cpu_host_model),
           "paper-cluster": (lambda: ClusterSpec.of("paper"),
                             lambda: JClusterSpec.of("paper"))}


def _same(got, want, what=""):
    """Every field of two ServeProjections: numbers within RTOL, the rest
    equal."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float) and not isinstance(b, bool):
            assert (a == b) or math.isclose(a, b, rel_tol=RTOL), \
                (what, f.name, a, b)
        else:
            assert a == b, (what, f.name, a, b)


def _models(smoke: bool):
    pick = (lambda c: c.smoke_model) if smoke else (lambda c: c.model)
    return (pick(get_config("qwen1.5-4b")),
            pick(j_get_config("qwen1.5-4b")))


@pytest.mark.parametrize("seed", [0, 7])
def test_traffic_trace_bit_for_bit(seed):
    kw = dict(rate=3.5, prompt_len=40, gen_len=9, spread=0.4)
    got = TrafficModel(**kw).trace(12, 151936, seed=seed)
    want = JTrafficModel(**kw).trace(12, 151936, seed=seed)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert (a.rid, a.max_new, a.arrival) == (b.rid, b.max_new, b.arrival)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert TrafficModel(**kw).mean_context == JTrafficModel(**kw).mean_context


def test_kv_bytes_per_token_matches_jax():
    for smoke in (False, True):
        mc, jmc = _models(smoke)
        for dtype_bytes in (2, 4):
            assert kv_bytes_per_token(mc, dtype_bytes) == \
                j_kv_bytes_per_token(jmc, dtype_bytes)
    assert kv_bytes_per_token(_models(False)[0]) == 409_600   # 400 KiB
    with pytest.raises(ValueError, match="no pageable KV cache"):
        kv_bytes_per_token(get_config("mamba2-780m").model)
    with pytest.raises(ValueError, match="no pageable KV cache"):
        j_kv_bytes_per_token(j_get_config("mamba2-780m").model)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_price_serving_matches_jax(system, smoke):
    """Both strategies over a (p1, p2, kv_shards, max_batch) grid and rates
    from idle to overloaded: every field and bail reason equal."""
    mc, jmc = _models(smoke)
    make, j_make = SYSTEMS[system]
    sysm, j_sysm = make(), j_make()
    n_feasible = n_bail = 0
    for rate in (0.05, 2.0, 40.0, 1e6):
        traffic = TrafficModel(rate, 256, 32)
        j_traffic = JTrafficModel(rate, 256, 32)
        for strategy in SERVE_STRATEGIES:
            for p1, p2, kv, mb in ((1, 1, 1, 8), (2, 4, 1, 4), (1, 4, 4, 16),
                                   (1, 3, 3, 2), (4, 2, 2, 32), (1, 8, 1, 1)):
                kw = dict(max_len=512 if mb != 2 else None,
                          dtype_bytes=2 if p1 != 4 else 4,
                          prefill_chunk=64 if mb == 8 else 32)
                got = price_serving(mc, sysm, strategy, p1, p2, kv, mb,
                                    traffic, **kw)
                want = j_price_serving(jmc, j_sysm, strategy, p1, p2, kv, mb,
                                       j_traffic, **kw)
                _same(got, want, (strategy, p1, p2, kv, mb, rate))
                n_feasible += want.feasible
                n_bail += bool(want.limit)
    assert n_feasible and n_bail        # both kinds of row are exercised


@pytest.mark.parametrize("system,smoke", [("cpu-host", True),
                                          ("paper-cluster", False)])
def test_serve_sweep_and_tune_match_jax(system, smoke):
    """The sweep's rows in order, and serve_tune's winner and runner-up
    under an SLO that is met and one that nothing meets (the full model on
    the 8 GB host fits nowhere: both raise)."""
    mc, jmc = _models(smoke)
    make, j_make = SYSTEMS[system]
    sysm, j_sysm = make(), j_make()
    traffic, j_traffic = TrafficModel(4.0, 256, 64), JTrafficModel(4.0, 256,
                                                                   64)
    rows = serve_sweep(mc, sysm, 8, traffic, max_len=512)
    j_rows = j_serve_sweep(jmc, j_sysm, 8, j_traffic, max_len=512)
    assert len(rows) == len(j_rows) > 0
    for a, b in zip(rows, j_rows):
        _same(a, b, "sweep")
    for slo in (1e4, 1e-9):
        plan = serve_tune(mc, sysm, 8, traffic, slo, max_len=512)
        j_plan = j_serve_tune(jmc, j_sysm, 8, j_traffic, slo, max_len=512)
        assert plan.meets_slo == j_plan.meets_slo
        _same(plan.winner, j_plan.winner, ("winner", slo))
        _same(plan.runner_up, j_plan.runner_up, ("runner-up", slo))
        assert len(plan.rows) == len(j_plan.rows)
        assert plan.describe() == j_plan.describe()
    if system == "cpu-host":
        full, j_full = _models(False)
        with pytest.raises(ValueError, match="no feasible serving"):
            serve_tune(full, sysm, 8, traffic, 1e4, max_len=512)
        with pytest.raises(ValueError, match="no feasible serving"):
            j_serve_tune(j_full, j_sysm, 8, j_traffic, 1e4, max_len=512)
