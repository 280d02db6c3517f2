"""One SGD step of each smoke CNN (ResNet-50's (1,1,1,1) and VGG16's at
32 px, CosmoFlow's at 16³; batch 8) under data, filter, channel, ds and
df on 4 gloo ranks on the CPU, against the port's unsharded step and JAX's,
from the same weights (JAX's ``tree_init``) and the same batch.

One spawn of 4 ranks serves the whole file: every strategy on the (2, 2)
mesh, and ResNet's also on (1, 4). Each rank runs the port's
``make_train_step`` on its blocks; the gradients it hands the optimizer are
gathered whole and compared here.

Bars. The gradients are compared, not the parameters after the step: with
lr 3e-3 a gradient p times too large moves a parameter by less than an
elementwise 1e-5 bar would notice. Clipping is off (``grad_clip`` 1e9, as
the reference's ``check_dp_numerics``): global-norm clipping would rescale a
uniformly p-times gradient back to the same update. Against the unsharded
step: loss within 1e-5 relative, the whole model's gradient within 1e-4 in
relative L2, each tensor within 1e-3 (fp32 sums in another order; the
smoke ResNet reads ~6e-6 in relative L2. At batch 4 its last stage's
BatchNorm runs over 4 values a channel, whose E[x²] − μ² amplifies those
roundings to ~7e-5, and at 64 px a conv split over filters rounds a ReLU
input near zero to the other side, 6e-4: both are why the batch is 8 and
the image 32 px). A p-times gradient reads p − 1 = 3. One more step with clipping on
(1.0): the global norm the optimizer clips by within 1e-5 relative of the
unsharded one. Against JAX's unsharded step, the per-model bars of the
single-device parity tests (ResNet: 3e-3 per tensor in relative L2, the
reference's CPU BatchNorm drift; VGG16 and CosmoFlow: 1e-4·|ref| +
1e-4·max|ref|).

The same ranks also load JAX's weights and an AdamW state straight into a
sharded model (``bridge.load_jax_params``/``load_jax_state`` on
``shard_params``' blocks) under every strategy, which must give bit for
bit the blocks ``sharded_copy`` cuts from the whole loaded model.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import flatten, load_jax_params, load_jax_state
from repro_torch.launch.build import shard_batch
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.cnn import (CosmoFlow, CosmoFlowConfig, ResNet,
                                    ResNetConfig, VGG, VGGConfig)
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.sharded import Sharded, shard_params, sharded_copy
from repro_torch.parallel.strategies import make_rules
from repro_torch.training import steps
from repro_torch.training.steps import make_train_step, train_state

STRATEGIES = ("data", "filter", "channel", "ds", "df")
BATCH = 8
CPU = ShardingCtx("cpu")
# (port model, its config, the JAX config's keywords, the batch's source)
ARCHS = {
    "resnet50": (ResNet, ResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                      n_classes=10),
                 ("image", dict(image=32, classes=10))),
    "vgg16": (VGG, VGGConfig(name="vgg16-smoke", n_classes=10, img=32),
              ("image", dict(image=32, classes=10))),
    "cosmoflow": (CosmoFlow, CosmoFlowConfig(img=16, n_conv=2, width=8),
                  ("volume", dict(image=16, channels=4, n_targets=4))),
}
MESH_14 = {"resnet50": STRATEGIES}
# gradient accumulation (2 microbatches of 4) across ranks
ACCUM = ("cosmoflow", ("data", "ds"))


def _jax_setup(arch):
    """JAX's weights, batch and unsharded (loss, gradients), as numpy (jax is
    imported here, not at the top: the spawned ranks import this module)."""
    import jax
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticSource as JSource
    from repro.models import cnn as jcnn
    from repro.nn.module import NULL_CTX, tree_init
    _, cfg, (kind, kw) = ARCHS[arch]
    jcfg = {"resnet50": lambda: jcnn.ResNetConfig(
                "resnet50-smoke", (1, 1, 1, 1), n_classes=10),
            "vgg16": lambda: jcnn.VGGConfig(name="vgg16-smoke", n_classes=10,
                                            img=32),
            "cosmoflow": lambda: jcnn.CosmoFlowConfig(img=16, n_conv=2,
                                                      width=8)}[arch]()
    jmodel = {"resnet50": jcnn.ResNet, "vgg16": jcnn.VGG,
              "cosmoflow": jcnn.CosmoFlow}[arch](jcfg)
    params = jax.jit(lambda k: tree_init(jmodel.params_spec(), k))(
        jax.random.PRNGKey(0))
    batch = JSource(JDataConfig(kind, BATCH, **kw)).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, NULL_CTX)[0]))(params, batch)
    np_params = jax.tree.map(np.asarray, params)
    return (np_params, {k: np.asarray(v) for k, v in batch.items()},
            float(loss), flatten(jax.tree.map(np.asarray, grads)))


def _model(arch, params):
    cls, cfg, _ = ARCHS[arch]
    model = cls(cfg, device=torch.device("cpu"), generator=torch.Generator())
    load_jax_params(model, params)
    return model


def _step(model, batch, ctx, grad_clip, accum=1):
    """One SGD step of the port's train step; (loss, the gradients handed
    to the optimizer, gathered whole; the norm it clipped by)."""
    captured = {}
    apply_update = steps.apply_update

    def capture(opt, params, grads, state, step, norm=None):
        captured.update(grads)
        return apply_update(opt, params, grads, state, step, norm)

    opt = OptimizerConfig(name="sgd", lr=3e-3, grad_clip=grad_clip)
    steps.apply_update = capture
    try:
        _, m = make_train_step(model, opt, ctx, accum=accum)(
            train_state(model, opt), batch)
    finally:
        steps.apply_update = apply_update
    grads = {}
    for k, p in model.named_parameters():
        g = captured[k].detach()
        if ctx.sharded:
            g = Sharded(g, getattr(p, "global_shape", p.shape),
                        getattr(p, "place", ((),) * p.dim()), ctx.mesh).full()
        grads[k] = g.numpy()
    return float(m["loss"]), grads, float(m["grad_norm"])


def _scaled(tree, c):
    """A numpy parameter tree times ``c``, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: _scaled(v, c) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_scaled(v, c) for v in tree]
    return tree * np.float32(c)


def _load_sharded(arch, params, whole, ctx):
    """JAX's params and an AdamW state (m = 2·params, v = 3·params, step 5)
    loaded into a freshly drawn sharded model; (the parameters and moments
    that differ from ``sharded_copy``'s blocks, how many parameters this
    rank holds only a block of)."""
    cls, cfg, _ = ARCHS[arch]
    model = shard_params(cls(cfg, device=torch.device("cpu"),
                             generator=torch.Generator().manual_seed(1)), ctx)
    load_jax_params(model, params)
    state = train_state(model, OptimizerConfig(name="adamw"))
    load_jax_state(state, {"params": params,
                           "opt": {"m": _scaled(params, 2),
                                   "v": _scaled(params, 3)},
                           "step": np.int32(5)})
    blocks = dict(sharded_copy(whole, ctx).named_parameters())
    bad = [k for k, p in model.named_parameters()
           if not torch.equal(p, blocks[k])]
    bad += [f"opt/{m}/{k}" for m, c in (("m", 2), ("v", 3))
            for k, t in state["opt"][m].items()
            if not torch.equal(t, blocks[k] * c)]
    if state["step"] != 5:
        bad.append("step")
    return bad, sum(tuple(p.shape) != tuple(p.global_shape)
                    for p in model.parameters())


def _ranks(mesh22, setups):
    mesh14 = Mesh(1, 4, backend="gloo", device=torch.device("cpu"))
    out, loads = {}, {}
    for arch, (params, batch) in setups.items():
        whole = _model(arch, params)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        for mesh, strategies in ((mesh22, STRATEGIES),
                                 (mesh14, MESH_14.get(arch, ()))):
            for s in strategies:
                ctx = ShardingCtx("cpu", mesh=mesh, rules=make_rules(s))
                b = shard_batch(batch, ctx)
                out[arch, mesh.shape["data"], s] = (
                    _step(sharded_copy(whole, ctx), b, ctx, 1e9),
                    _step(sharded_copy(whole, ctx), b, ctx, 1.0)[2])
                if mesh is mesh22:
                    loads["load", arch, s] = _load_sharded(arch, params,
                                                           whole, ctx)
        if arch == ACCUM[0]:
            for s in ACCUM[1]:
                ctx = ShardingCtx("cpu", mesh=mesh22, rules=make_rules(s))
                out[arch, "accum", s] = _step(
                    sharded_copy(whole, ctx), shard_batch(batch, ctx), ctx,
                    1e9, accum=2)
    return (out if mesh22.rank == 0 else None), loads


@pytest.fixture(scope="module")
def runs():
    jax_side, setups, ref = {}, {}, {}
    for arch in ARCHS:
        params, batch, jloss, jgrads = _jax_setup(arch)
        jax_side[arch] = (jloss, jgrads)
        setups[arch] = (params, batch)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        ref[arch] = (_step(_model(arch, params), b, CPU, 1e9),
                     _step(_model(arch, params), b, CPU, 1.0)[2])
        if arch == ACCUM[0]:
            ref["accum"] = _step(_model(arch, params), b, CPU, 1e9, accum=2)
    res = run_ranks(_ranks, 4, setups, backend="gloo", device="cpu",
                    model=2, timeout_s=600)
    got = res[0][0]
    for key in res[0][1]:
        got[key] = [loads[key] for _, loads in res]        # every rank's
    return jax_side, ref, got


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in want)) ** 0.5


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_matches_the_unsharded_step(runs, arch):
    """Every strategy's loss and gradients against the unsharded step's."""
    _, ref, got = runs
    (loss, grads, _), _ = ref[arch]
    keys = [k for k in got if k[0] == arch and k[1] != "accum"]
    assert len(keys) == len(STRATEGIES) * (1 + (arch in MESH_14))
    for key in keys:
        (l_s, g_s, _), _ = got[key]
        assert set(g_s) == set(grads)
        assert abs(l_s - loss) <= 1e-5 * abs(loss), key
        assert _rel_l2(g_s, grads) <= 1e-4, (key, _rel_l2(g_s, grads))
        for k in grads:
            err = np.linalg.norm(g_s[k] - grads[k]) / np.linalg.norm(grads[k])
            assert err <= 1e-3, (key, k, err)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_clipping_norm_is_the_whole_models(runs, arch):
    """With clipping on, the norm each rank clips by is the unsharded
    step's: each block's squares once, replicated blocks counted once."""
    _, ref, got = runs
    _, norm = ref[arch]
    for key in (k for k in got if k[0] == arch and k[1] != "accum"):
        assert abs(got[key][1] - norm) <= 1e-5 * norm, (key, got[key][1],
                                                         norm)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_matches_jax(runs, arch):
    """The sharded gradients against jax.grad of the unsharded reference
    step at the single-device tests' bars."""
    jax_side, _, got = runs
    jloss, jgrads = jax_side[arch]
    for key in (k for k in got if k[0] == arch and k[1] != "accum"):
        (loss, grads, _), _ = got[key]
        assert abs(loss - jloss) <= 1e-5 * max(abs(jloss), 1.0), key
        for k, g in grads.items():
            want = jgrads[k]
            if arch == "resnet50":
                err = np.linalg.norm(g - want) / np.linalg.norm(want)
                assert err < 3e-3, (key, k, err)
            else:
                np.testing.assert_allclose(
                    g, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                    err_msg=f"{key} {k}")


def test_accumulated_step_matches_the_unsharded_one(runs):
    """accum = 2 across ranks (CosmoFlow under data and ds): microbatch i is
    rows [4i, 4i + 4) of the whole batch, gathered and split again, as the
    unsharded step cuts it; loss and gradients at the bars of one step."""
    _, ref, got = runs
    loss, grads, _ = ref["accum"]
    for s in ACCUM[1]:
        l_s, g_s, _ = got[ACCUM[0], "accum", s]
        assert abs(l_s - loss) <= 1e-5 * abs(loss), s
        assert _rel_l2(g_s, grads) <= 1e-4, (s, _rel_l2(g_s, grads))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_jax_weights_load_into_a_sharded_model(runs, arch):
    """load_jax_params and load_jax_state into a sharded model copy each
    rank's block of the whole leaf, as sharded_copy cuts it, on every rank.
    Filter, channel and df hold some parameters in blocks; data and ds
    replicate every parameter."""
    _, _, got = runs
    for s in STRATEGIES:
        for rank, (bad, n_blocks) in enumerate(got["load", arch, s]):
            assert not bad, (s, rank, bad)
            assert (n_blocks > 0) == (s in ("filter", "channel", "df")), (
                s, rank, n_blocks)
