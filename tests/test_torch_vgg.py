"""The port's VGG16 vs the JAX package's, with the same weights (carried over
by repro_torch.bridge) and the same batches: the smoke config (full widths,
13 convs, 32×32 px, 10 classes), batch 4.

Bars, all relative to the reference's scale: without BatchNorm, LeCun-normal
weights and ReLU shrink the logits through the 16 layers (max |logit| is
about 0.009 here), so an absolute bar like ResNet's 1e-4 would pass almost
anything. Logits: |Δ| ≤ 1e-4·|ref| + 1e-4·max|ref| (fp32 sums over up to
K = 4608 products in another order: ~1e-6 of the scale is seen); loss
1e-5. Gradients against jax.grad on the plain path (the reference cannot
differentiate the Pallas conv), per tensor 1e-4·|ref| + 1e-4·max|ref|;
parameters and momenta after one SGD step from a carried-over state the
same (see that test for which gradients it is given); the full-size
parameter tree checked on the meta device."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cnn import VGG as JVGG
from repro.models.cnn import VGGConfig as JVGGConfig
from repro.nn.module import NULL_CTX, ShardingCtx as JCtx, tree_abstract
from repro.nn.module import tree_init
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.optim.optimizers import apply_update as j_apply_update
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticSource as JSource
from repro_torch.bridge import flatten, load_jax_params, load_jax_state
from repro_torch.launch import train
from repro_torch.models.cnn import VGG, VGGConfig
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.training.steps import (make_eval_step, make_train_step,
                                        train_state)

IMG, BATCH, CLASSES = 32, 4, 10
CPU = ShardingCtx("cpu")
SMOKE = dict(name="vgg16-smoke", n_classes=CLASSES, img=IMG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, rtol=1e-4, scale_tol=1e-4, err_msg=""):
    """|got − want| ≤ rtol·|want| + scale_tol·max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_tol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _port_model(params):
    m = VGG(VGGConfig(**SMOKE), device=CPU.device, generator=torch.Generator())
    load_jax_params(m, _np(params))
    return m


@pytest.fixture(scope="module")
def setup():
    jmodel = JVGG(JVGGConfig(**SMOKE))
    params = jax.jit(lambda k: tree_init(jmodel.params_spec(), k))(
        jax.random.PRNGKey(0))
    src = JSource(JDataConfig("image", BATCH, image=IMG, classes=CLASSES))
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, NULL_CTX)[0]))
    return (jmodel, params, _port_model(params),
            [src.batch_at(s) for s in range(2)], value_and_grad)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vgg_forward_matches_jax(setup, use_pallas):
    """use_pallas on: the 13 HaloConvs run JAX's Pallas conv in interpret
    mode there and the port's conv2d_gemm wrapper (its plain version on the
    CPU) here."""
    jmodel, params, tmodel, batches, _ = setup
    jctx = JCtx(mesh=None, rules=NULL_CTX.rules, use_pallas=use_pallas)
    b = batches[0]
    logits_j, loss_j = jax.jit(lambda p, b: (
        jmodel.apply(p, b["images"], jctx), jmodel.loss_fn(p, b, jctx)[0]))(
            params, b)
    out = make_eval_step(tmodel, ShardingCtx("cpu", use_pallas=use_pallas))(
        _torch_batch(b))
    assert out["outputs"].shape == (BATCH, CLASSES)
    _close(out["outputs"].numpy(), logits_j)
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), rtol=1e-5,
                               atol=1e-5)


def test_vgg_flattens_channels_last(setup):
    """fc1 reads the last pool's output in (H, W, C) order, as the
    reference's reshape of its NHWC tensor: at 64 px that output is 2×2×512,
    and fc1's rows permuted as a channels-first flatten would read them
    give other logits."""
    cfg = dict(SMOKE, img=64)
    jmodel = JVGG(JVGGConfig(**cfg))
    params = jax.jit(lambda k: tree_init(jmodel.params_spec(), k))(
        jax.random.PRNGKey(1))
    b = JSource(JDataConfig("image", 2, image=64, classes=CLASSES)).batch_at(0)
    logits_j = jax.jit(lambda p, x: jmodel.apply(p, x, NULL_CTX))(
        params, b["images"])
    tmodel = VGG(VGGConfig(**cfg), device=CPU.device,
                 generator=torch.Generator())
    load_jax_params(tmodel, _np(params))
    logits_t = tmodel(torch.from_numpy(b["images"]), CPU)
    _close(logits_t.detach().numpy(), logits_j)
    with torch.no_grad():           # rows (h, w, c) → (c, h, w)
        w = tmodel.fc1.w.view(2, 2, 512, -1)
        tmodel.fc1.w.copy_(w.permute(2, 0, 1, 3).reshape(2048, -1))
    permuted = tmodel(torch.from_numpy(b["images"]), CPU).detach().numpy()
    assert np.abs(permuted - np.asarray(logits_j)).max() > \
        1e-2 * np.abs(np.asarray(logits_j)).max()


def _torch_grads(model, batch):
    loss, _ = model.loss_fn(batch, CPU)
    named = dict(model.named_parameters())
    return {k: g.numpy() for k, g in
            zip(named, torch.autograd.grad(loss, list(named.values())))}


def test_vgg_grads_match_jax(setup):
    _, params, tmodel, batches, value_and_grad = setup
    b = batches[0]
    grads_j = flatten(_np(value_and_grad(params, b)[1]))
    grads_t = _torch_grads(tmodel, _torch_batch(b))
    assert set(grads_j) == set(grads_t)
    for k, g in grads_t.items():
        _close(g, grads_j[k], err_msg=k)


def _like(tree, flat, prefix=""):
    """A tree shaped like ``tree`` holding ``flat[dotted path]``."""
    if isinstance(tree, dict):
        return {k: _like(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return jnp.asarray(flat[prefix])


def test_vgg_one_sgd_step_from_carried_state_matches_jax(setup):
    """JAX takes step 0 (value_and_grad, then apply_update); its state is
    carried over and both take step 1 on the next batch, so the momentum
    starts non-zero. Loss against JAX's; parameters and momenta against
    JAX's apply_update given the port's own gradients. After that step one
    ReLU input of conv 2 lies 1.2e-8 from zero (an fp64 forward), closer
    than either fp32 forward's rounding, so the two packages' gradients
    may take different branches there (ROADMAP caveat e); the forward and
    the step-0 gradients are held elementwise above."""
    _, params, _, batches, value_and_grad = setup
    jopt = JOpt(name="sgd", lr=0.1)
    update = jax.jit(j_apply_update, static_argnums=0)
    zeros = {"mom": jax.tree.map(jnp.zeros_like, params)}
    _, g0 = value_and_grad(params, batches[0])
    p1, o1, _ = update(jopt, params, g0, zeros, jnp.int32(0))
    state_np = _np({"params": p1, "opt": o1, "step": jnp.int32(1)})
    loss_j, _ = value_and_grad(p1, batches[1])

    tmodel = _port_model(params)
    opt = OptimizerConfig(name="sgd", lr=0.1)
    tstate = train_state(tmodel, opt)
    load_jax_state(tstate, state_np)
    tbatch = _torch_batch(batches[1])
    grads_t = _torch_grads(tmodel, tbatch)
    tstate, metrics = make_train_step(tmodel, opt, CPU)(tstate, tbatch)
    assert tstate["step"] == 2
    np.testing.assert_allclose(metrics["loss"].item(), float(loss_j),
                               rtol=1e-5, atol=1e-5)
    want_p, want_o, _ = update(jopt, p1, _like(state_np["params"], grads_t),
                               o1, jnp.int32(1))
    want_p, want_m = flatten(_np(want_p)), flatten(_np(want_o["mom"]))
    for k, p in tstate["params"].items():
        _close(p.detach().numpy(), want_p[k], err_msg=k)
        _close(tstate["opt"]["mom"][k].numpy(), want_m[k], err_msg=f"mom/{k}")


def test_full_vgg16_tree_maps_one_to_one_on_meta():
    """The published VGG16 (224 px, 1000 classes): every leaf of the JAX
    tree has a port parameter of its shape and name (convs.{i}.w/b, fc1–fc3),
    138,357,544 parameters in both; built on the meta device, so nothing is
    allocated."""
    jmodel = JVGG(JVGGConfig())
    shapes = {k: tuple(v.shape) for k, v in
              flatten(tree_abstract(jmodel.params_spec())).items()}
    model = VGG(VGGConfig(), device=torch.device("meta"), generator=None)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == shapes
    assert model.num_params() == jmodel.num_params() == 138_357_544


def test_train_vgg16_smoke_on_cpu():
    out = train.main(["--arch", "vgg16", "--device", "cpu", "--smoke",
                      "--steps", "2", "--batch", "2"])
    assert out["device"] == "cpu"
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
