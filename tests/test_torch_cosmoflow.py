"""The port's CosmoFlow vs the JAX package's, with the same weights (carried
over by repro_torch.bridge) and the same batches: the smoke config (16³
volumes of 4 channels, 2 convs of width 8, 4 targets), batch 4, and the
``volume`` source bit for bit.

Bars: predictions |Δ| ≤ 1e-4·|ref| + 1e-4·max|ref| (fp32 3-D convs whose
sums XLA and PyTorch take in other orders; ~5e-7 of the scale is seen),
MSE 1e-5; gradients against jax.grad per tensor at the same bar; the
parameters and momenta after one SGD step from a carried-over state (JAX's
own step on both sides) the same. With ``use_pallas`` on, a 3-D HaloConv
runs the plain conv in both packages, so both settings give the same
numbers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticSource as JSource
from repro.models.cnn import CosmoFlow as JCosmoFlow
from repro.models.cnn import CosmoFlowConfig as JCosmoFlowConfig
from repro.nn.module import NULL_CTX, ShardingCtx as JCtx, tree_abstract
from repro.nn.module import tree_init
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.optim.optimizers import apply_update as j_apply_update
from repro_torch.bridge import flatten, load_jax_params, load_jax_state
from repro_torch.data.pipeline import DataConfig, Loader, SyntheticSource
from repro_torch.launch import train
from repro_torch.models.cnn import CosmoFlow, CosmoFlowConfig
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.training.steps import (make_eval_step, make_train_step,
                                        train_state)

BATCH = 4
CPU = ShardingCtx("cpu")
SMOKE = dict(img=16, n_conv=2, width=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, err_msg=""):
    """|got − want| ≤ 1e-4·|want| + 1e-4·max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=err_msg)


def _port_model(params):
    m = CosmoFlow(CosmoFlowConfig(**SMOKE), device=CPU.device,
                  generator=torch.Generator())
    load_jax_params(m, _np(params))
    return m


@pytest.fixture(scope="module")
def setup():
    jmodel = JCosmoFlow(JCosmoFlowConfig(**SMOKE))
    params = jax.jit(lambda k: tree_init(jmodel.params_spec(), k))(
        jax.random.PRNGKey(0))
    src = JSource(JDataConfig("volume", BATCH, image=16, channels=4,
                              n_targets=4))
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, NULL_CTX)[0]))
    return (jmodel, params, _port_model(params),
            [src.batch_at(s) for s in range(2)], value_and_grad)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cosmoflow_forward_matches_jax(setup, use_pallas):
    jmodel, params, tmodel, batches, _ = setup
    jctx = JCtx(mesh=None, rules=NULL_CTX.rules, use_pallas=use_pallas)
    b = batches[0]
    pred_j, loss_j = jax.jit(lambda p, b: (
        jmodel.apply(p, b["images"], jctx), jmodel.loss_fn(p, b, jctx)[0]))(
            params, b)
    out = make_eval_step(tmodel, ShardingCtx("cpu", use_pallas=use_pallas))(
        _torch_batch(b))
    assert out["outputs"].shape == (BATCH, 4)
    _close(out["outputs"].numpy(), pred_j)
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), rtol=1e-5,
                               atol=1e-5)
    assert set(out) == {"mse", "loss", "outputs"}


def test_cosmoflow_grads_match_jax(setup):
    _, params, tmodel, batches, value_and_grad = setup
    b = batches[0]
    grads_j = flatten(_np(value_and_grad(params, b)[1]))
    loss, _ = tmodel.loss_fn(_torch_batch(b), CPU)
    named = dict(tmodel.named_parameters())
    grads_t = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(grads_j) == set(grads_t)
    for k, g in grads_t.items():
        _close(g.numpy(), grads_j[k], err_msg=k)


def test_cosmoflow_one_sgd_step_from_carried_state_matches_jax(setup):
    """JAX takes steps 0 and 1 (value_and_grad, then apply_update); its
    state after step 0 is carried over and the port takes step 1 on the
    same batch: loss, parameters and momenta against JAX's."""
    _, params, _, batches, value_and_grad = setup
    jopt = JOpt(name="sgd", lr=0.1)
    update = jax.jit(j_apply_update, static_argnums=0)
    zeros = {"mom": jax.tree.map(jnp.zeros_like, params)}
    _, g0 = value_and_grad(params, batches[0])
    p1, o1, _ = update(jopt, params, g0, zeros, jnp.int32(0))
    loss_j, g1 = value_and_grad(p1, batches[1])
    p2, o2, _ = update(jopt, p1, g1, o1, jnp.int32(1))

    tmodel = _port_model(params)
    opt = OptimizerConfig(name="sgd", lr=0.1)
    tstate = train_state(tmodel, opt)
    load_jax_state(tstate, _np({"params": p1, "opt": o1,
                                "step": jnp.int32(1)}))
    tstate, metrics = make_train_step(tmodel, opt, CPU)(
        tstate, _torch_batch(batches[1]))
    assert tstate["step"] == 2
    np.testing.assert_allclose(metrics["loss"].item(), float(loss_j),
                               rtol=1e-5, atol=1e-5)
    want_p, want_m = flatten(_np(p2)), flatten(_np(o2["mom"]))
    for k, p in tstate["params"].items():
        _close(p.detach().numpy(), want_p[k], err_msg=k)
        _close(tstate["opt"]["mom"][k].numpy(), want_m[k], err_msg=f"mom/{k}")


def test_full_cosmoflow_tree_maps_one_to_one_on_meta():
    """The full config (128³, 5 convs): every leaf of the JAX tree has a port
    parameter of its shape and name (convs.{i}.w/b, fc1, fc2, out),
    3,283,060 parameters in both."""
    jmodel = JCosmoFlow(JCosmoFlowConfig(img=128))
    shapes = {k: tuple(v.shape) for k, v in
              flatten(tree_abstract(jmodel.params_spec())).items()}
    model = CosmoFlow(CosmoFlowConfig(img=128), device=torch.device("meta"),
                      generator=None)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == shapes
    assert model.num_params() == jmodel.num_params() == 3_283_060


@pytest.mark.parametrize("seed,step,n_targets", [(0, 0, 4), (0, 5, 4),
                                                  (3, 1, 2)])
def test_volume_source_is_bit_exact(seed, step, n_targets):
    kw = dict(image=12, channels=4, n_targets=n_targets, seed=seed)
    want = JSource(JDataConfig("volume", 3, **kw)).batch_at(step)
    got = SyntheticSource(DataConfig("volume", 3, **kw)).batch_at(step)
    placed = Loader(DataConfig("volume", 3, **kw), CPU.device).batch_at(step)
    assert set(got) == set(want) == {"images", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(placed[k].numpy(), want[k])


def test_train_cosmoflow_smoke_on_cpu():
    out = train.main(["--arch", "cosmoflow", "--device", "cpu", "--smoke",
                      "--steps", "2", "--batch", "2"])
    assert out["device"] == "cpu"
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    cfg = train.data_config_for(CosmoFlowConfig(**SMOKE), 2)
    assert (cfg.kind, cfg.image, cfg.channels, cfg.n_targets) == \
        ("volume", 16, 4, 4)
