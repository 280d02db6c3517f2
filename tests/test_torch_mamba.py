"""The port's Mamba-2 780m serving path against the JAX package's, at the
smoke width (4 SSD layers, d 64, two heads of 64, d_state 16, chunk 16,
vocab 512, tied embeddings): the same parameters (JAX ``tree_init``,
carried over by repro_torch.bridge, the stacked layers unstacked) and the
same seeded prompts go through ``prefill`` and three ``decode_step``s, fed
the same tokens; logits and caches are compared after each. The full-width
tree is checked shape for shape on the ``meta`` device.

Each check runs on an fp32 copy of the smoke config at 1e-4 (the same
algorithm; the SSD's sums, cumsum and exp in another order) and on the
published bf16 config at the Qwen tests' bf16 bars, 0.1 absolute plus 5 %
relative (both packages round each bf16 op, but the GEMMs and the norms'
sums in another order flip a last bit now and then, and four layers carry
it into the logits). With ``use_pallas`` the port's norms and SSD take
their kernels' plain versions on the CPU, under the same bars."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.transformer import TransformerLM as JLM
from repro.nn.module import NULL_CTX, tree_abstract, tree_init
from repro_torch.bridge import flatten, load_jax_params
from repro_torch.configs import get_config
from repro_torch.launch.build import build_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx, zeros_like_spec
from repro_torch.training.steps import make_decode_step, make_prefill_step

B, S, MAX_LEN = 2, 32, 40
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=0.1)}
CPU = torch.device("cpu")
N_FULL = 780_148_992
CACHE_KEYS = ("state", "conv_x", "conv_B", "conv_C")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(dtype):
    jcfg = j_get_config("mamba2-780m").smoke_model
    tcfg = get_config("mamba2-780m").smoke_model
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, ssm=dataclasses.
                                   replace(jcfg.ssm, dtype=jnp.float32))
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32, ssm=dataclasses.
                                   replace(tcfg.ssm, dtype=torch.float32))
    return jcfg, tcfg


def _np(a):
    """fp32 numpy copy of a torch tensor or a jax array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference(request):
    """JAX params, prompts, and the JAX prefill + 3 decode steps."""
    dtype = request.param
    jcfg, tcfg = _configs(dtype)
    jm = JLM(jcfg)
    params = jax.jit(lambda k: tree_init(jm.params_spec(), k))(
        jax.random.PRNGKey(0))
    cache = jax.tree.map(jnp.zeros_like, tree_init(
        jm.cache_spec(B, MAX_LEN), jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    prefill = jax.jit(lambda p, t, c: jm.prefill(p, t, c, NULL_CTX))
    decode = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos,
                                                         NULL_CTX))
    logits, cache = prefill(params, tokens, cache)
    steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache), None)]
    tok = np.asarray(logits).argmax(-1).astype(np.int32)
    for i in range(3):
        logits, cache = decode(params, tok, cache, jnp.int32(S + i))
        steps.append((np.asarray(logits), jax.tree.map(np.asarray, cache),
                      tok))
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
    return dict(dtype=dtype, jcfg=jcfg, tcfg=tcfg, jm=jm, params=params,
                tokens=tokens, steps=steps)


def _port_model(ref):
    model = TransformerLM(ref["tcfg"], device=CPU, generator=None)
    load_jax_params(model, jax.tree.map(np.asarray, ref["params"]))
    return model


def _check_cache(tcache, jcache, tol):
    for layer, c in enumerate(tcache["blocks"]):
        for name in CACHE_KEYS:
            assert c[name].dtype == torch.float32
            np.testing.assert_allclose(
                _np(c[name]), _np(jcache["stacks"][0][name][layer]), **tol,
                err_msg=f"layer {layer} {name}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_jax(reference, use_pallas):
    ref = reference
    tol = TOL[ref["dtype"]]
    model = _port_model(ref)
    ctx = ShardingCtx("cpu", use_pallas=use_pallas)
    cache = zeros_like_spec(model.cache_spec(B, MAX_LEN), CPU)
    prefill = make_prefill_step(model, ctx)
    decode = make_decode_step(model, ctx)

    logits, cache = prefill({"tokens": torch.from_numpy(ref["tokens"])},
                            cache)
    j_logits, j_cache, _ = ref["steps"][0]
    assert logits.dtype == torch.float32 and \
        tuple(logits.shape) == (B, 1, ref["tcfg"].vocab)
    np.testing.assert_allclose(_np(logits), j_logits, **tol)
    _check_cache(cache, j_cache, tol)
    for i, (j_logits, j_cache, tok) in enumerate(ref["steps"][1:]):
        logits, cache = decode(torch.from_numpy(tok), cache, S + i)
        np.testing.assert_allclose(_np(logits), j_logits, **tol)
        _check_cache(cache, j_cache, tol)


def test_forward_matches_jax_apply(reference):
    ref = reference
    model = _port_model(ref)
    logits_j, aux_j = jax.jit(lambda p, t: ref["jm"].apply(p, t, NULL_CTX))(
        ref["params"], ref["tokens"])
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ref["tokens"]),
                            ShardingCtx("cpu", use_pallas=True))
    assert tuple(logits.shape) == (B, S, ref["tcfg"].vocab)
    np.testing.assert_allclose(_np(logits), _np(logits_j),
                               **TOL[ref["dtype"]])
    assert float(aux) == float(aux_j) == 0.0


def test_prefill_starts_from_the_cache_state(reference):
    """The SSM's prompt pass reads the state in its cache (the reference's
    ``init_state=cache["state"]``): a second pass over the same cache gives
    other logits than one over a zeroed cache, which gives the first's."""
    ref = reference
    model = _port_model(ref)
    prefill = make_prefill_step(model, ShardingCtx("cpu"))
    tokens = {"tokens": torch.from_numpy(ref["tokens"])}
    spec = model.cache_spec(B, MAX_LEN)
    cache = zeros_like_spec(spec, CPU)
    first, cache = prefill(tokens, cache)
    warm, _ = prefill(tokens, cache)
    fresh, _ = prefill(tokens, zeros_like_spec(spec, CPU))
    assert torch.equal(first, fresh)
    assert float((warm - first).abs().max()) > 1e-3


def test_full_param_tree_maps_one_to_one():
    """Every leaf of the full JAX tree (layers stacked, no head: the
    embedding is tied) lands on a port parameter of its shape and dtype
    (layers unstacked), and none is left over; checked on the meta device,
    so nothing full-width is made."""
    jm = JLM(j_get_config("mamba2-780m").model)
    leaves = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
        tree_abstract(jm.params_spec()))
    model = TransformerLM(get_config("mamba2-780m").model,
                          device=torch.device("meta"), generator=None)
    load_jax_params(model, leaves)
    flat = flatten(leaves)
    n_stacked = sum(1 for k in flat if k.startswith("stacks."))
    assert len(dict(model.named_parameters())) == \
        len(flat) - n_stacked + 48 * n_stacked
    assert model.num_params() == jm.num_params() == N_FULL
    assert not hasattr(model, "head") and "head" not in leaves
    mixer = model.blocks[0].mixer
    assert mixer.w_x.shape == (1536, 3072) and mixer.w_B.shape == (1536, 128)
    assert mixer.dt_bias.dtype == mixer.a_log.dtype == torch.float32
    assert mixer.out_proj.dtype == model.embed.table.dtype == torch.bfloat16


def test_bridge_rejects_a_mismatched_mamba_tree():
    jcfg, tcfg = _configs("bfloat16")
    jm = JLM(jcfg)
    tree = jax.tree.map(np.asarray, tree_init(jm.params_spec(),
                                              jax.random.PRNGKey(0)))
    model = TransformerLM(tcfg, device=CPU, generator=None)
    head = np.zeros((jcfg.d_model, jcfg.vocab), tree["embed"]["table"].dtype)
    with pytest.raises(ValueError, match=r"extra \['head'\]"):
        load_jax_params(model, dict(tree, head=head))
    one_layer = jax.tree.map(lambda a: a[:1], tree["stacks"])
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, dict(tree, stacks=one_layer))
    no_norm = [{"norm1": s["norm1"], "mixer": {
        k: v for k, v in s["mixer"].items() if k != "norm"}}
        for s in tree["stacks"]]
    with pytest.raises(ValueError, match="mixer.norm.scale"):
        load_jax_params(model, dict(tree, stacks=no_norm))


def test_mamba_build_on_the_cpu_and_same_seed_same_weights(monkeypatch):
    cfg = get_config("mamba2-780m")
    a, b = (build_model(cfg, ShardingCtx("cpu"), smoke=True, seed=3)
            for _ in range(2))
    jm = JLM(j_get_config("mamba2-780m").smoke_model)
    assert a.num_params() == jm.num_params()
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    dt = torch.nn.functional.softplus(a.blocks[0].mixer.dt_bias.detach())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and \
        float(dt.max()) <= 0.1 * (1 + 1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, ShardingCtx("cuda"), smoke=True)
