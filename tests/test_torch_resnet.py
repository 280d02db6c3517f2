"""The port's smoke ResNet vs the JAX package's, with the same weights
(carried over by repro_torch.bridge) and the same batches: stages (1,1,1,1)
at full width 64, 10 classes, 64×64 px, batch 4 (at 32 px and batch 2, BN
over single pixels amplifies rounding).

Bars: logits 1e-4 and loss 1e-5, with use_pallas on (JAX's Pallas kernel in
interpret mode) and off; gradients against jax.grad on the plain path (the
reference cannot differentiate the Pallas conv), 1e-4 per bottleneck and
3e-3 in relative L2 for the whole model (see test_resnet_grads_match_jax);
parameters and optimizer moments after one SGD or AdamW step from a
carried-over state 1e-5; data batches bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticSource as JSource
from repro.models.cnn import Bottleneck as JBottleneck
from repro.models.cnn import ResNet as JResNet
from repro.models.cnn import ResNetConfig as JResNetConfig
from repro.nn.module import NULL_CTX, ShardingCtx as JCtx, tree_init
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.optim.optimizers import apply_update as j_apply_update
from repro.optim.optimizers import global_norm as j_global_norm
from repro_torch.bridge import flatten, load_jax_params, load_jax_state
from repro_torch.data.pipeline import DataConfig, Loader, SyntheticSource
from repro_torch.models.cnn import Bottleneck, ResNet, ResNetConfig
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig, apply_update
from repro_torch.training.steps import (make_eval_step, make_train_step,
                                        train_state)

IMG, BATCH, CLASSES = 64, 4, 10
CPU = ShardingCtx("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jmodel = JResNet(JResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                   n_classes=CLASSES))
    params = jax.jit(lambda k: tree_init(jmodel.params_spec(), k))(
        jax.random.PRNGKey(0))
    src = JSource(JDataConfig("image", BATCH, image=IMG, classes=CLASSES))
    tmodel = ResNet(ResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                 n_classes=CLASSES),
                    device=CPU.device, generator=torch.Generator())
    load_jax_params(tmodel, _np(params))
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, NULL_CTX)[0]))
    return (jmodel, params, tmodel, [src.batch_at(s) for s in range(2)],
            value_and_grad)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_resnet_forward_matches_jax(setup, use_pallas):
    jmodel, params, tmodel, batches, _ = setup
    jctx = JCtx(mesh=None, rules=NULL_CTX.rules, use_pallas=use_pallas)
    b = batches[0]
    logits_j, loss_j = jax.jit(lambda p, b: (
        jmodel.apply(p, b["images"], jctx), jmodel.loss_fn(p, b, jctx)[0]))(
            params, b)
    out = make_eval_step(tmodel, ShardingCtx("cpu", use_pallas=use_pallas))(
        _torch_batch(b))
    np.testing.assert_allclose(out["outputs"].numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["loss"].item(), float(loss_j),
                               rtol=1e-5, atol=1e-5)


def test_resnet_grads_match_jax(setup):
    """Whole-model gradients, compared per tensor in relative L2 norm.

    An elementwise 1e-4 bar does not hold here, and not because of the port:
    the reference's fp32 forward (XLA's CPU reductions for the BN
    statistics) drifts further from an fp64 evaluation of the same model
    than the port's does, so a ReLU input that close to zero takes the
    other branch in one package and not in the other. That moves every
    upstream gradient by far more than 1e-4. The elementwise 1e-4 bar is
    held per block in test_bottleneck_grads_match_jax."""
    _, params, tmodel, batches, value_and_grad = setup
    b = batches[0]
    grads_j = flatten(_np(value_and_grad(params, b)[1]))
    grads_t = _torch_grads(tmodel, _torch_batch(b))
    assert set(grads_j) == set(grads_t)
    for k, g in grads_t.items():
        err = np.linalg.norm(g - grads_j[k]) / np.linalg.norm(grads_j[k])
        assert err < 3e-3, (k, err)


def _like(tree, flat, prefix=""):
    """A tree shaped like ``tree`` holding ``flat[dotted path]``."""
    if isinstance(tree, dict):
        return {k: _like(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return jnp.asarray(flat[prefix])


def _torch_grads(model, batch):
    loss, _ = model.loss_fn(batch, CPU)
    named = dict(model.named_parameters())
    return {k: g.numpy() for k, g in
            zip(named, torch.autograd.grad(loss, list(named.values())))}


@pytest.mark.parametrize("cin,mid,stride", [(256, 64, 1), (256, 128, 2)])
def test_bottleneck_grads_match_jax(cin, mid, stride):
    """One bottleneck (identity shortcut; strided entry with projection),
    input and parameter gradients against jax.grad at 1e-4. At 8×8 px no
    ReLU input lies within the two fp32 forwards' drift of zero; one that
    did would move the gradients by O(1), as in the whole model."""
    jb = JBottleneck(cin, mid, stride, jnp.float32)
    params = tree_init(jb.params_spec(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((BATCH, 8, 8, cin)), 0).astype(
        np.float32)
    ho = 8 // stride
    r = (rng.standard_normal((BATCH, ho, ho, mid * 4))
         / np.sqrt(BATCH * ho * ho)).astype(np.float32)
    gp, gx = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jb.apply(p, xx, NULL_CTX) * r),
        argnums=(0, 1)))(params, jnp.asarray(x))
    gp = flatten(_np(gp))
    tb = Bottleneck(cin, mid, stride, torch.float32, device=CPU.device,
                    generator=torch.Generator())
    load_jax_params(tb, _np(params))
    tx = torch.from_numpy(x).requires_grad_()
    (tb(tx, CPU) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    for k, p in tb.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gp[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name,lr", [("sgd", 0.1), ("adamw", 3e-3)])
def test_one_step_from_carried_state_matches_jax(setup, name, lr):
    """JAX takes step 0 (its value_and_grad, then apply_update); its state
    (params, moments, step) is carried over and both take step 1 on the
    next batch, so bias correction runs at count 2 and the moments start
    non-zero. Loss and grad norm are held against JAX's; the new parameters
    and moments (1e-5) against JAX's apply_update given the port's own
    gradients, since the gradients themselves differ by the ReLU flips of
    test_resnet_grads_match_jax."""
    _, params, _, batches, value_and_grad = setup
    jopt = JOpt(name=name, lr=lr)
    update = jax.jit(j_apply_update, static_argnums=0)
    moments = ("m", "v") if name == "adamw" else ("mom",)
    zeros = {m: jax.tree.map(jnp.zeros_like, params) for m in moments}
    _, g0 = value_and_grad(params, batches[0])
    p1, o1, _ = update(jopt, params, g0, zeros, jnp.int32(0))
    state_np = _np({"params": p1, "opt": o1, "step": jnp.int32(1)})
    loss_j, g1 = value_and_grad(p1, batches[1])

    tmodel = ResNet(ResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                 n_classes=CLASSES),
                    device=CPU.device, generator=torch.Generator())
    opt = OptimizerConfig(name=name, lr=lr)
    tstate = train_state(tmodel, opt)
    load_jax_state(tstate, state_np)
    assert tstate["step"] == 1
    tbatch = _torch_batch(batches[1])
    grads_t = _torch_grads(tmodel, tbatch)
    tstate, metrics_t = make_train_step(tmodel, opt, CPU)(tstate, tbatch)
    assert tstate["step"] == 2
    np.testing.assert_allclose(metrics_t["loss"].item(), float(loss_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metrics_t["grad_norm"].item(),
                               float(j_global_norm(g1)), rtol=1e-3)

    grads_tree = _like(state_np["params"], grads_t)
    want_p, want_opt, _ = update(jopt, p1, grads_tree, o1, jnp.int32(1))
    want = flatten(_np(want_p))
    for k, p in tstate["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for moment, tensors in tstate["opt"].items():
        want = flatten(_np(want_opt[moment]))
        for k, t in tensors.items():
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{moment}/{k}")


def test_accum_averages_microbatch_grads(setup):
    """accum=2 takes the mean of the two half-batch losses and gradients
    (each half with its own BN statistics, as the reference's lax.scan
    does) before one update."""
    jmodel, params, _, batches, _ = setup
    b = batches[0]
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in b.items()} for i in (0, 1)]
    jloss = jax.jit(lambda p, h: jmodel.loss_fn(p, h, NULL_CTX)[0])
    loss_j = np.mean([float(jloss(params, h)) for h in halves])

    def model():
        m = ResNet(ResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                n_classes=CLASSES),
                   device=CPU.device, generator=torch.Generator())
        load_jax_params(m, _np(params))
        return m

    opt = OptimizerConfig(name="sgd", lr=0.1)
    m_acc = model()
    state, metrics = make_train_step(m_acc, opt, CPU, accum=2)(
        train_state(m_acc, opt), _torch_batch(b))
    np.testing.assert_allclose(metrics["loss"].item(), loss_j, rtol=1e-5,
                               atol=1e-5)

    m_ref = model()
    g = [_torch_grads(m_ref, _torch_batch(h)) for h in halves]
    ref = train_state(m_ref, opt)
    apply_update(opt, ref["params"],
                 {k: torch.from_numpy((g[0][k] + g[1][k]) / 2) for k in g[0]},
                 ref["opt"], 0)
    for k, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref["params"][k].detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 1)])
def test_synthetic_source_is_bit_exact(seed, step):
    kw = dict(image=24, classes=1000, seed=seed)
    want = JSource(JDataConfig("image", 3, **kw)).batch_at(step)
    got = SyntheticSource(DataConfig("image", 3, **kw)).batch_at(step)
    placed = Loader(DataConfig("image", 3, **kw), CPU.device).batch_at(step)
    for k in ("images", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(placed[k].numpy(), want[k])
