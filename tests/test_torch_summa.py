"""The 2-D SUMMA grid (``parallel/summa.py``) on 4 gloo ranks on the CPU,
the world laid out as (data, model_r, model_c) grids by
``launch.mesh.make_grid_mesh``, against plain products, the port's
unsharded step and the reference's own summa step.

* The grid's coordinates are row-major and its groups are the ranks that
  share every other coordinate.
* ``summa_matmul`` of (4, 8, 32) × (32, 48) on the (1, 2, 2), (1, 4, 1)
  and (1, 1, 4) grids (a ring of two and of four rows, and none): the
  output and both gradients against the plain product and its backward at
  the reference's bars (1e-5; gradients 5e-4), reading ~1e-7 here.
* One SGD step (clipping off) of the fp32 smoke Qwen (2 layers, d 64, 4
  heads, QKV bias) at batch 4 × 32 under the "summa" rules on the
  (1, 2, 2) grid: the loss within 1e-5 relative of the unsharded step's,
  the clipping norm within 1e-5 and the updated parameters within 1e-4 in
  relative L2 (the pipeline's bars), with ``summa_matmul`` called 14 times
  (per layer q, k, v, the output and the FFN's three), so the grid path
  engaged. At seq 31 no shape divides the grid: the step takes the rules
  table's path (no SUMMA call) and matches the same way.
* ``validate(..., ["pipeline", "summa"], grid=(2, 2))`` of the 4-layer
  smoke Qwen gives measured points, the summa row projected as ``project``
  at p1 = 1, p2 = 4, p2r = p2c = 2. SUMMA on a CNN or an SSM model raises,
  naming ROADMAP queue 1 item 8.
* Witness: the JAX package's summa train step (its ``make_train_step``
  under the "summa" rules on ``make_grid_mesh(1, 2, 2)`` of 4 virtual host
  devices), in a subprocess (``python <this file> <out.npz>``); the port's
  summa step from the reference's weights gives its loss and updated
  parameters at the bars above.
"""
import contextlib
import dataclasses
import io
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.bridge import _unstack_layers, flatten, load_jax_params
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.oracle import OracleConfig, TimeModel, project
from repro_torch.core.validation import measure_step, validate
from repro_torch.launch.build import shard_batch
from repro_torch.launch.mesh import GRID_AXES, make_grid_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.cnn import CosmoFlow, CosmoFlowConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel import summa
from repro_torch.parallel.sharded import Sharded, sharded_copy
from repro_torch.parallel.strategies import make_rules
from repro_torch.training.steps import make_train_step, train_state

B, SEQ, CHUNK, LR = 4, 32, 8, 3e-3
CPU = ShardingCtx("cpu")
OPT = OptimizerConfig(name="sgd", lr=LR, grad_clip=1e9)
GRIDS = [(1, 2, 2), (1, 4, 1), (1, 1, 4)]


def _fp32(cfg, dtype=torch.float32, **kw):
    cfg = dataclasses.replace(cfg, **kw)
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=dtype)
           for k in ("attn", "ffn", "ssm") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=dtype, **sub)


def _lm(layers=2, arch="qwen1.5-4b", params=None):
    model = TransformerLM(
        _fp32(get_config(arch).smoke_model, n_layers=layers),
        device=torch.device("cpu"), generator=torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_params(model, params)
    return model


def _tokens(seq=SEQ) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 512, (B, seq)).astype(
        np.int32)


def _batch(seq=SEQ) -> dict:
    return {"tokens": torch.from_numpy(_tokens(seq)).long()}


def _rel_l2(got, want):
    num = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in want)
    return (num / sum(float(want[k].double().square().sum())
                      for k in want)) ** 0.5


def _whole(p, mesh) -> torch.Tensor:
    return Sharded(p.detach(), getattr(p, "global_shape", p.shape),
                   getattr(p, "place", ((),) * p.dim()), mesh).full()


def _serial(seq=SEQ, params=None):
    model = _lm(params=params)
    state, m = make_train_step(model, OPT, CPU, q_chunk=CHUNK,
                               kv_chunk=CHUNK)(train_state(model, OPT),
                                               _batch(seq))
    return float(m["loss"]), float(m["grad_norm"]), {
        k: p.detach().clone() for k, p in state["params"].items()}


def _grid_step(mesh, seq=SEQ, params=None):
    """One summa SGD step on the grid: (loss, norm, SUMMA calls, updated
    parameters gathered whole)."""
    ctx = ShardingCtx("cpu", mesh=mesh, rules=make_rules("summa"))
    local = sharded_copy(_lm(params=params), ctx)
    summa.summa_matmul.calls = 0
    _, m = make_train_step(local, OPT, ctx, q_chunk=CHUNK, kv_chunk=CHUNK)(
        train_state(local, OPT), shard_batch(_batch(seq), ctx))
    return (float(m["loss"]), float(m["grad_norm"]), summa.summa_matmul.calls,
            {k: _whole(p, mesh) for k, p in local.named_parameters()})


def _matmul(mesh):
    """summa_matmul's output and both gradients, gathered whole."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 48),
                                             dtype=np.float32) * 0.1)
    ct = torch.from_numpy(rng.standard_normal((4, 8, 48), dtype=np.float32))
    row, col = (summa._split(mesh, a) for a in (summa.ROW_AXIS,
                                                 summa.COL_AXIS))
    xs = Sharded.of(x, ((), row, col), mesh)
    ws = Sharded.of(w, (row, col), mesh)
    xl, wl = (t.local.requires_grad_() for t in (xs, ws))
    y = summa.summa_matmul(Sharded(xl, x.shape, xs.place, mesh),
                           Sharded(wl, w.shape, ws.place, mesh))
    (y.local * Sharded.of(ct, y.place, mesh).local).sum().backward()
    with torch.no_grad():
        return tuple(t.full() for t in (
            y, Sharded(xl.grad, x.shape, xs.place, mesh),
            Sharded(wl.grad, w.shape, ws.place, mesh))) + ((x, w, ct),)


def _ranks(mesh22, ref):
    grids = {g: make_grid_mesh(mesh22, *g) for g in GRIDS}
    mesh = grids[1, 2, 2]
    rank0 = mesh.rank == 0
    out = {"coords": tuple(mesh.coord(a) for a in GRID_AXES),
           "groups": {axes: mesh.group(axes).ranks for axes in (
               ("model_r",), ("model_c",), ("model_r", "model_c"),
               ("data", "model_c"))},
           "same": make_grid_mesh(mesh22, 1, 2, 2) is mesh}
    out["matmul"] = {g: _matmul(grids[g]) for g in GRIDS}
    if rank0:
        out["serial"] = {seq: _serial(seq) for seq in (SEQ, 31)}
        out["serial"]["ref"] = _serial(params=ref)
    out["step"] = {seq: _grid_step(mesh, seq) for seq in (SEQ, 31)}
    out["step"]["ref"] = _grid_step(mesh, params=ref)
    model = _lm(4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["validate"] = validate(
            model, model.cfg, _batch(), ShardingCtx("cpu", mesh=mesh22),
            ["pipeline", "summa"], flops_per_sample=1e6, B=B, S=SEQ,
            cluster=ClusterSpec.of("host"), grid=(2, 2))
    if not rank0:
        return {k: out[k] for k in ("coords", "groups", "same")}
    return out


# ---------------------------------------------------------------------------
# The witness: the reference's summa step in a subprocess
# ---------------------------------------------------------------------------

def _check(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.launch.mesh import make_grid_mesh as j_grid_mesh
    from repro.models.transformer import TransformerLM as JLM
    from repro.nn.module import ShardingCtx as JCtx
    from repro.nn.module import tree_init
    from repro.optim.optimizers import OptimizerConfig as JOpt
    from repro.parallel import summa as jsumma
    from repro.parallel.strategies import make_rules as j_rules
    from repro.training.steps import make_train_step as j_train_step
    from repro.training.steps import train_state_spec
    assert len(jax.devices()) == 4, jax.devices()
    ctx = JCtx(j_grid_mesh(1, 2, 2), j_rules("summa"))
    assert jsumma.summa_axes(ctx)
    model = JLM(_fp32(j_get_config("qwen1.5-4b").smoke_model, jnp.float32))
    opt = JOpt(name="sgd", lr=LR, zero1=False, grad_clip=1e9)
    state = tree_init(train_state_spec(model, opt), jax.random.PRNGKey(0))
    new, metrics = jax.jit(j_train_step(
        model, opt, ctx, scan_layers=False, q_chunk=CHUNK, kv_chunk=CHUNK))(
        state, {"tokens": jnp.asarray(_tokens())})
    out = {}
    for what, tree in (("init", state["params"]), ("new", new["params"])):
        for k, a in flatten(jax.tree.map(np.asarray, tree)).items():
            out[f"{what}/{k}"] = a
    out["loss"] = np.float64(metrics["loss"])
    np.savez(out_path, **out)
    print(f"summa: loss {float(metrics['loss'])!r}")
    print("WITNESS-WRITTEN")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("summa_witness") / "ref.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "WITNESS-WRITTEN" in run.stdout, run.stdout + run.stderr[-3000:]
    return dict(np.load(out))


def _flat(ref, prefix):
    return {k[len(prefix):]: a for k, a in ref.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def ranks(reference):
    return run_ranks(_ranks, 4, _flat(reference, "init/"), backend="gloo",
                     device="cpu", model=2, timeout_s=360)


def test_grid_mesh_coordinates_and_groups(ranks):
    """Rank r sits at row-major (data, model_r, model_c) coordinates; the
    row group shares (data, model_c), the column group (data, model_r);
    the grid is made once per split."""
    for r, got in enumerate(ranks):
        assert got["coords"] == (0, r // 2, r % 2)
        assert got["groups"][("model_r",)] == (r % 2, r % 2 + 2)
        assert got["groups"][("model_c",)] == (r - r % 2, r - r % 2 + 1)
        assert got["groups"][("model_r", "model_c")] == (0, 1, 2, 3)
        assert got["groups"][("data", "model_c")] == \
            got["groups"][("model_c",)]
        assert got["same"]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_summa_matmul_and_its_gradients(ranks, grid):
    y, gx, gw, (x, w, ct) = ranks[0]["matmul"][grid]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = xr @ wr
    want.backward(ct)
    np.testing.assert_allclose(y.numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), xr.grad.numpy(), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(gw.numpy(), wr.grad.numpy(), rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("seq", [SEQ, 31])
def test_summa_step_matches_the_unsharded_step(ranks, seq):
    """The grid engages at seq 32 (14 SUMMA products) and falls back to
    the rules table's path at 31; both give the unsharded step."""
    loss, norm, new = ranks[0]["serial"][seq]
    got_loss, got_norm, calls, params = ranks[0]["step"][seq]
    assert calls == (14 if seq == SEQ else 0)
    assert abs(got_loss - loss) <= 1e-5 * abs(loss), (got_loss, loss)
    assert abs(got_norm - norm) <= 1e-5 * norm, (got_norm, norm)
    assert set(params) == set(new)
    assert _rel_l2(params, new) <= 1e-4, _rel_l2(params, new)


def test_validate_measures_the_pipeline_and_summa_rows(ranks):
    """Both rows measured at p = 4; summa projected at its lattice point."""
    pipe, grid = ranks[0]["validate"]
    assert (pipe.strategy, grid.strategy) == ("pipeline", "summa")
    for pt in (pipe, grid):
        assert pt.p == 4 and math.isfinite(pt.measured_s) and \
            pt.measured_s > 0
    cluster = ClusterSpec.of("host")
    want = project("summa", stats_for(_lm(4).cfg, SEQ),
                   TimeModel(cluster.system),
                   OracleConfig(B=B, D=B, **cluster.oracle_kw()), 4, p1=1,
                   p2=4, p2r=2, p2c=2).total_s
    assert grid.projected_s == want


def test_summa_on_a_cnn_or_an_ssm_model_raises():
    class _Grid:
        shape = {"data": 1, "model_r": 2, "model_c": 2}
        size, device = 4, torch.device("cpu")
    ctx = ShardingCtx("cpu", mesh=_Grid(), rules=make_rules("summa"))
    assert summa.summa_axes(ctx) == summa.GRID_AXES
    cosmo = CosmoFlow(CosmoFlowConfig(img=16, n_conv=2, width=8),
                      device=torch.device("cpu"),
                      generator=torch.Generator().manual_seed(0))
    mamba = _lm(arch="mamba2-780m")
    for model in (cosmo, mamba):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            measure_step(model, {}, ctx, "summa", grid=(2, 2))
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            make_train_step(model, OPT, ctx)
    assert summa.summa_supported(_lm()) is None


def test_reference_summa_step_equals_the_ports(reference, ranks):
    """The reference's summa step and the port's, from the same weights,
    against each other and the port's unsharded step."""
    ref_loss = float(reference["loss"])
    want = {k: torch.from_numpy(a)
            for k, a in _unstack_layers(_flat(reference, "new/")).items()}
    loss, _, calls, params = ranks[0]["step"]["ref"]
    assert calls == 14
    assert abs(ref_loss - loss) <= 1e-5 * abs(ref_loss), (ref_loss, loss)
    assert set(params) == set(want)
    assert _rel_l2(params, want) <= 1e-4, _rel_l2(params, want)
    serial_loss, _, serial = ranks[0]["serial"]["ref"]
    assert abs(ref_loss - serial_loss) <= 1e-5 * abs(ref_loss)
    assert _rel_l2(serial, want) <= 1e-4


if __name__ == "__main__":
    _check(sys.argv[1])
