"""The LMs under the paper's strategies on 4 gloo ranks on the CPU: the
smoke Qwen1.5-4B (2 layers, d 64, 4 heads) and Mamba-2 780m (4 layers,
d 64, 2 heads of 64, chunk 16), in fp32, at batch 8 × seq 32, one SGD step
under data, spatial, filter, channel, df and ds on the (2, 2) mesh and df
also on (1, 4); the Qwen also under df_zero1 and df_zero3. Both packages
start from JAX's ``tree_init`` weights and the same token batch.

One spawn of 4 ranks serves the whole file. Each rank runs the port's
``make_train_step`` on its blocks; the gradients it hands the optimizer
are gathered whole and compared here. Rank 0 computes the unsharded
references on its one thread first (a reference at another thread count
rounds its sums differently).

Bars. Clipping is off (``grad_clip`` 1e9, as the reference's
``check_dp_numerics``), so a gradient p times too large shows. Against the
port's unsharded step (the bars of tests/test_torch_parallel_train.py):
the loss within 1e-5 relative, the whole model's gradient within 1e-4 in
relative L2, each tensor within 1e-3, the key biases with an absolute floor
of 1e-3 of the largest key-bias gradient of the unsharded step (their
gradient cancels in the softmax but for RoPE: ~1e-8 here, where fp32
roundings of the other terms are of the same size). Against JAX's
unsharded step, the bars of tests/test_torch_lm_train.py: the loss within
1e-6 relative, the gradients within 1e-5 in relative L2 (its bar on the
first AdamW moment, 0.1·g) over the whole model and per tensor, the per-
tensor bar over each tensor's size plus the same floor for the key
biases. One more step with clipping on (1.0): the global norm within 1e-5
of the unsharded one.

ZeRO-1: df_zero1's updated parameters equal df's within 1e-6 relative,
and each rank's optimizer state holds the blocks the reference's
``zero1_rules`` place (its spec_to_pspec on the same shapes), half of
df's or so on (2, 2); the attention biases' state stays whole on "data".
ZeRO-3: df_zero3's gradients pass the bars above; each rank holds the
parameter blocks the reference's df_zero3 rules place, and ``replicas``
leaves "data" out for a parameter split on it (its gradient is
reduce-scattered by the gather's adjoint, never summed again).

The same ranks load JAX's weights (and a ZeRO-1 AdamW state) straight
into a sharded LM, which must give bit for bit the blocks ``sharded_copy``
cuts; run the trainer across the ranks (``launch.train.main``, the
published bf16 smoke Qwen under df, whose first loss must be the single-
process trainer's within 1e-5); and time ``measure_step`` under df.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.bridge import (_unstack_layers, flatten, load_jax_params,
                                load_jax_state)
from repro_torch.configs import get_config
from repro_torch.core.validation import measure_step
from repro_torch.launch import train
from repro_torch.launch.build import shard_batch
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.sharded import (Sharded, replicas, shard_params,
                                          sharded_copy)
from repro_torch.parallel.strategies import make_rules
from repro_torch.training import steps
from repro_torch.training.steps import make_train_step, train_state

ARCHS = ("qwen1.5-4b", "mamba2-780m")
STRATEGIES = ("data", "spatial", "filter", "channel", "df", "ds")
ZERO = ("df_zero1", "df_zero3")
B, S, CHUNK, LR = 8, 32, 8, 3e-3
CPU = ShardingCtx("cpu")
TRAIN_ARGS = ["--arch", "qwen1.5-4b", "--smoke", "--steps", "1", "--batch",
              str(B), "--seq", str(S), "--device", "cpu"]


def _fp32(cfg):
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=torch.float32)
           for k in ("attn", "ffn", "ssm") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=torch.float32, **sub)


def _cases(arch):
    """(mesh's data extent, strategy) of every sharded run of ``arch``."""
    out = [(2, s) for s in STRATEGIES] + [(1, "df")]
    return out + [(2, s) for s in ZERO] if arch == ARCHS[0] else out


def _jax_setup(arch):
    """JAX's fp32 smoke weights, the batch and its unsharded (loss,
    gradients), as numpy (jax is imported here: the ranks import this
    module)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.data.pipeline import DataConfig, TokenSource
    from repro.models.transformer import TransformerLM as JLM
    from repro.nn.module import NULL_CTX, tree_init
    jcfg = j_get_config(arch).smoke_model
    sub = {k: dataclasses.replace(getattr(jcfg, k), dtype=jnp.float32)
           for k in ("attn", "ffn", "ssm") if getattr(jcfg, k) is not None}
    jm = JLM(dataclasses.replace(jcfg, dtype=jnp.float32, **sub))
    params = jax.jit(lambda k: tree_init(jm.params_spec(), k))(
        jax.random.PRNGKey(0))
    batch = TokenSource(DataConfig("lm", B, seq_len=S, vocab=jcfg.vocab,
                                   seed=0)).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(
        p, b, NULL_CTX, q_chunk=CHUNK, kv_chunk=CHUNK)[0]))(params, batch)
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            _unstack_layers(flatten(jax.tree.map(np.asarray, grads))))


def _model(arch, params, ctx=None):
    model = TransformerLM(_fp32(get_config(arch).smoke_model),
                          device=torch.device("cpu"),
                          generator=torch.Generator().manual_seed(1))
    if ctx is not None:
        shard_params(model, ctx)
    load_jax_params(model, params)
    return model


def _whole(t: torch.Tensor, mesh, p=None) -> np.ndarray:
    """A parameter's block, or a block of state (ZeRO-1's, or else placed
    as parameter ``p``), gathered whole."""
    src = t if hasattr(t, "place") else p if p is not None else t
    if mesh is None or not hasattr(src, "place"):
        return t.detach().numpy().copy()
    return Sharded(t.detach(), src.global_shape, src.place,
                   mesh).full().numpy()


def _step(model, batch, ctx, grad_clip, zero1=False):
    """One SGD step; (loss, the gradients handed to the optimizer gathered
    whole, the norm it clipped by, the updated parameters gathered whole,
    this rank's bytes of state and of parameters)."""
    captured = {}
    apply_update = steps.apply_update

    def capture(opt, params, grads, state, step, norm=None):
        captured.update(grads)
        return apply_update(opt, params, grads, state, step, norm)

    opt = OptimizerConfig(name="sgd", lr=LR, grad_clip=grad_clip,
                          zero1=zero1)
    state = train_state(model, opt, ctx)
    steps.apply_update = capture
    try:
        _, m = make_train_step(model, opt, ctx, q_chunk=CHUNK,
                               kv_chunk=CHUNK)(state, batch)
    finally:
        steps.apply_update = apply_update
    mesh = ctx.mesh if ctx.sharded else None
    grads, new = {}, {}
    for k, p in model.named_parameters():
        g = captured[k].detach()
        if mesh is not None:
            g = Sharded(g, getattr(p, "global_shape", p.shape),
                        getattr(p, "place", ((),) * p.dim()), mesh).full()
        grads[k] = g.numpy()
        new[k] = _whole(p, mesh)
    nbytes = {k: sum(t.numel() * t.element_size() for t in v.values())
              for k, v in (("state", state["opt"]["mom"]),
                           ("params", state["params"]))}
    shapes = {k: tuple(t.shape) for k, t in state["opt"]["mom"].items()}
    return (float(m["loss"]), grads, float(m["grad_norm"]), new, nbytes,
            shapes)


def _load(arch, params, whole, ctx, zero1):
    """JAX's weights loaded into a freshly drawn sharded model, and an AdamW
    state (m = 2·params, v = 3·params, step 5) into its train state (ZeRO-1
    blocks with ``zero1``); the names whose blocks differ from
    ``sharded_copy``'s (the moments gathered whole against 2 and 3 times
    the weights), and how many parameters this rank holds a block of."""
    model = _model(arch, params, ctx)
    opt = OptimizerConfig(name="adamw", zero1=zero1)
    state = train_state(model, opt, ctx)
    scaled = [_scaled(params, c) for c in (2, 3)]
    load_jax_state(state, {"params": params,
                           "opt": {"m": scaled[0], "v": scaled[1]},
                           "step": np.int32(5)})
    blocks = dict(sharded_copy(whole, ctx).named_parameters())
    bad = [k for k, p in model.named_parameters()
           if not torch.equal(p, blocks[k])]
    wm, wv = ({k: _whole(t, ctx.mesh, state["params"][k])
               for k, t in state["opt"][m].items()} for m in ("m", "v"))
    ref = dict(whole.named_parameters())
    bad += [f"opt/{k}" for k in wm
            if not (np.array_equal(wm[k], ref[k].detach().numpy() * 2)
                    and np.array_equal(wv[k], ref[k].detach().numpy() * 3))]
    if state["step"] != 5:
        bad.append("step")
    return bad, sum(tuple(p.shape) != tuple(p.global_shape)
                    for p in model.parameters())


def _scaled(tree, c):
    if isinstance(tree, dict):
        return {k: _scaled(v, c) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_scaled(v, c) for v in tree]
    return tree * np.float32(c)


def _ranks(mesh22, setups):
    mesh14 = Mesh(1, 4, backend="gloo", device=torch.device("cpu"))
    meshes = {2: mesh22, 1: mesh14}
    out, every = {}, {}
    for arch, (params, batch) in setups.items():
        whole = _model(arch, params)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        if mesh22.rank == 0:
            out["ref", arch] = (_step(_model(arch, params), batch, CPU,
                                      1e9)[:4],
                                _step(_model(arch, params), batch, CPU,
                                      1.0)[2])
        for data, s in _cases(arch):
            mesh = meshes[data]
            ctx = ShardingCtx("cpu", mesh=mesh, rules=make_rules(s))
            b = shard_batch(batch, ctx)
            zero1 = s == "df_zero1"
            run = _step(sharded_copy(whole, ctx), b, ctx, 1e9, zero1)
            every["bytes", arch, data, s] = run[4:]
            out[arch, data, s] = (run[:4], _step(sharded_copy(whole, ctx), b,
                                                 ctx, 1.0, zero1)[2])
            if data == 2:
                every["load", arch, s] = _load(arch, params, whole, ctx,
                                               zero1)
            if s == "df_zero3":
                every["replicas", s] = {
                    k: (p.place, replicas(p, mesh)) for k, p in
                    sharded_copy(whole, ctx).named_parameters()}
    ctx = ShardingCtx("cpu", mesh=mesh22)
    every["measure"] = measure_step(_model(ARCHS[0], setups[ARCHS[0]][0]),
                                    {k: torch.from_numpy(v) for k, v in
                                     setups[ARCHS[0]][1].items()}, ctx, "df")
    every["trainer"] = train.main(TRAIN_ARGS + ["--strategy", "df"])[
        "losses"]
    return (out if mesh22.rank == 0 else None), every


@pytest.fixture(scope="module")
def runs():
    jax_side, setups = {}, {}
    for arch in ARCHS:
        params, batch, jloss, jgrads = _jax_setup(arch)
        jax_side[arch] = (jloss, jgrads)
        setups[arch] = (params, batch)
    res = run_ranks(_ranks, 4, setups, backend="gloo", device="cpu",
                    model=2, timeout_s=360)
    got = res[0][0]
    for key in res[0][1]:
        got[key] = [every[key] for _, every in res]        # every rank's
    single = train.main(TRAIN_ARGS)["losses"]
    return jax_side, got, single


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in want)) ** 0.5


def _tensor_ok(got: dict, want: dict, rtol: float) -> list:
    """The tensors over ``rtol`` in relative L2, the key biases' bar
    floored at 1e-3 of the largest key-bias gradient."""
    floor = 1e-3 * max([float(np.abs(want[k]).max()) for k in want
                        if k.endswith(".bk")] or [0.0])
    bad = []
    for k in want:
        err = float(np.linalg.norm(got[k] - want[k]))
        bar = rtol * float(np.linalg.norm(want[k]))
        if k.endswith(".bk"):
            bar = max(bar, floor * math.sqrt(want[k].size))
        if not err <= bar:
            bad.append((k, err, bar))
    return bad


def _keys(got, arch):
    keys = [k for k in got if k[0] == arch]
    assert len(keys) == len(_cases(arch))
    return keys


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_lm_step_matches_the_unsharded_step(runs, arch):
    """Every strategy's loss and gradients against the port's unsharded
    step's."""
    _, got, _ = runs
    (loss, grads, _, _), _ = got["ref", arch]
    for key in _keys(got, arch):
        (l_s, g_s, _, _), _ = got[key]
        assert set(g_s) == set(grads)
        assert abs(l_s - loss) <= 1e-5 * abs(loss), key
        assert _rel_l2(g_s, grads) <= 1e-4, (key, _rel_l2(g_s, grads))
        assert not _tensor_ok(g_s, grads, 1e-3), (key, _tensor_ok(
            g_s, grads, 1e-3))


@pytest.mark.parametrize("arch", ARCHS)
def test_clipping_norm_is_the_whole_models(runs, arch):
    _, got, _ = runs
    _, norm = got["ref", arch]
    for key in _keys(got, arch):
        assert abs(got[key][1] - norm) <= 1e-5 * norm, (key, got[key][1],
                                                         norm)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_lm_step_matches_jax(runs, arch):
    """The sharded losses and gradients against jax.grad of the reference's
    unsharded loss at the single-device LM tests' bars."""
    jax_side, got, _ = runs
    jloss, jgrads = jax_side[arch]
    for key in _keys(got, arch):
        (loss, grads, _, _), _ = got[key]
        assert set(grads) == set(jgrads)
        assert abs(loss - jloss) <= 1e-6 * abs(jloss), (key, loss, jloss)
        assert _rel_l2(grads, jgrads) <= 1e-5, (key, _rel_l2(grads, jgrads))
        assert not _tensor_ok(grads, jgrads, 1e-5), (key, _tensor_ok(
            grads, jgrads, 1e-5))


def _local_bytes(params, rules_name, zero1):
    """Each parameter's local bytes (fp32) on a rank of the (2, 2) mesh,
    placed by the JAX package's rules (ZeRO-1's for the state)."""
    import types
    from repro.nn.module import spec_to_pspec
    from repro.optim.optimizers import zero1_rules
    from repro.parallel.strategies import make_rules as j_make_rules
    rules = j_make_rules(rules_name)
    rules = zero1_rules(rules) if zero1 else rules
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    out = {}
    for k, (axes, shape) in params.items():
        n = 1
        for d, entry in zip(shape, spec_to_pspec(axes, rules, mesh, shape)):
            parts = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            n *= d // math.prod(mesh.shape[a] for a in parts)
        out[k] = 4 * n
    return out


def _axes():
    model = TransformerLM(_fp32(get_config(ARCHS[0]).smoke_model),
                          device=torch.device("meta"), generator=None)
    return {k: (p.axes, tuple(p.shape)) for k, p in model.named_parameters()}


def test_zero1_updates_as_df_with_its_state_split(runs):
    _, got, _ = runs
    (_, _, _, df), _ = got[ARCHS[0], 2, "df"]
    (_, _, _, z1), _ = got[ARCHS[0], 2, "df_zero1"]
    for k in df:
        np.testing.assert_allclose(z1[k], df[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    axes = _axes()
    want = sum(_local_bytes(axes, "df_zero1", True).values())
    plain = sum(_local_bytes(axes, "df", False).values())
    for rank, ((nbytes, shapes), (df_bytes, df_shapes)) in enumerate(zip(
            got["bytes", ARCHS[0], 2, "df_zero1"],
            got["bytes", ARCHS[0], 2, "df"])):
        assert nbytes["state"] == want, (rank, nbytes, want)
        assert df_bytes["state"] == plain
        assert 0.45 <= want / plain <= 0.6, want / plain
        for k in shapes:
            if k.endswith((".bq", ".bk", ".bv")):
                assert shapes[k] == df_shapes[k], k


def test_zero3_splits_the_parameters_and_keeps_the_gradients(runs):
    """The gradient bars are in the tests above (df_zero3 is one of the
    Qwen's cases); here its blocks and replicas."""
    _, got, _ = runs
    axes = _axes()
    want = sum(_local_bytes(axes, "df_zero3", False).values())
    df = sum(_local_bytes(axes, "df", False).values())
    assert want < 0.7 * df
    for rank, (nbytes, _) in enumerate(got["bytes", ARCHS[0], 2,
                                           "df_zero3"]):
        assert nbytes["params"] == want, (rank, nbytes, want)
    for rank, reps in enumerate(got["replicas", "df_zero3"]):
        split_on_data = 0
        for k, (place, rep) in reps.items():
            used = {a for dim in place for a in dim}
            assert set(rep) == {"data", "model"} - used, (rank, k)
            split_on_data += "data" in used
        assert "data" not in reps["blocks.0.mixer.wq"][1]
        assert split_on_data >= len(reps) // 2, split_on_data


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_weights_load_into_a_sharded_lm(runs, arch):
    """load_jax_params and load_jax_state into a sharded LM copy each
    rank's block of the whole leaf, as sharded_copy cuts it (the ZeRO-1
    moments their own blocks), on every rank. Filter, channel, df and
    ZeRO hold some parameters in blocks; data, spatial and ds replicate
    every parameter."""
    _, got, _ = runs
    for s in STRATEGIES + (ZERO if arch == ARCHS[0] else ()):
        for rank, (bad, n_blocks) in enumerate(got["load", arch, s]):
            assert not bad, (s, rank, bad)
            assert (n_blocks > 0) == (s not in ("data", "spatial", "ds")), (
                s, rank, n_blocks)


def test_trainer_and_measure_step_across_ranks(runs):
    """launch.train.main on the ranks (the bf16 smoke Qwen under df) gives
    the single-process trainer's first loss; measure_step under df gives
    one positive time, the same on every rank."""
    _, got, single = runs
    for rank, losses in enumerate(got["trainer"]):
        assert abs(losses[0] - single[0]) <= 1e-5 * abs(single[0]), (
            rank, losses, single)
    times = got["measure"]
    assert math.isfinite(times[0]) and times[0] > 0
    assert times == [times[0]] * 4
