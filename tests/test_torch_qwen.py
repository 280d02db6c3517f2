"""The port's Qwen1.5-4B serving path against the JAX package's, at the smoke
width (2 layers, d 64, 4 heads of 16, vocab 512): the same parameters
(JAX ``tree_init``, carried over by repro_torch.bridge, the stacked layers
unstacked) and the same seeded prompts go through ``prefill`` and three
``decode_step``s, fed the same tokens; logits and caches are compared after
each. The full-width tree is checked shape for shape on the ``meta`` device.

Each check runs on an fp32 copy of the smoke config at 1e-5 (the same
algorithm; XLA's and torch's exp, rsqrt and cos differ in the last bit) and
on the published bf16 config at 0.1 absolute plus 5 % relative: both
packages round the attention scores to bf16 before the softmax, where a
one-ulp flip (2^-4 at |q·k| ≈ 10) moves a softmax weight by ~1.6 %, and two
layers carry that into the logits (≈ 0.05 at a logit scale of ~4). With
``use_pallas`` the port's norms and prompt attention take their kernels'
plain versions on the CPU (the full-matrix attention, which rounds no
scores), under the same bars."""
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

B, S, MAX_LEN = 2, 24, 32
CHUNK = 8
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=0.1)}
CPU = torch.device("cpu")
N_FULL = 3_950_369_280


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _in_dtype(cfg, dtype):
    """The config with model, attention and FFN in ``dtype``."""
    return dataclasses.replace(
        cfg, dtype=dtype, attn=dataclasses.replace(cfg.attn, dtype=dtype),
        ffn=dataclasses.replace(cfg.ffn, dtype=dtype))


def _configs(dtype):
    jcfg = j_get_config("qwen1.5-4b").smoke_model
    tcfg = get_config("qwen1.5-4b").smoke_model
    if dtype == "float32":
        jcfg, tcfg = _in_dtype(jcfg, jnp.float32), _in_dtype(tcfg,
                                                             torch.float32)
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
    cache_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cache = jax.tree.map(jnp.zeros_like, tree_init(
        jm.cache_spec(B, MAX_LEN, dtype=cache_dtype), jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    prefill = jax.jit(lambda p, t, c: jm.prefill(
        p, t, c, NULL_CTX, q_chunk=CHUNK, kv_chunk=CHUNK))
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
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(c[name]), _np(jcache["stacks"][0][name][layer]), **tol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_jax(reference, use_pallas):
    ref = reference
    tol = TOL[ref["dtype"]]
    model = _port_model(ref)
    ctx = ShardingCtx("cpu", use_pallas=use_pallas)
    cache = zeros_like_spec(model.cache_spec(B, MAX_LEN,
                                             dtype=ref["tcfg"].dtype), CPU)
    prefill = make_prefill_step(model, ctx, q_chunk=CHUNK, kv_chunk=CHUNK)
    decode = make_decode_step(model, ctx)

    logits, cache = prefill({"tokens": torch.from_numpy(ref["tokens"])},
                            cache)
    j_logits, j_cache, _ = ref["steps"][0]
    assert logits.dtype == torch.float32 and \
        tuple(logits.shape) == (B, 1, ref["tcfg"].vocab)
    np.testing.assert_allclose(_np(logits), j_logits, **tol)
    _check_cache(cache, j_cache, tol)
    for i, (j_logits, j_cache, tok) in enumerate(ref["steps"][1:]):
        # the last step gives each row its position as a (B,) tensor
        pos = S + i if i < 2 else torch.full((B,), S + i)
        logits, cache = decode(torch.from_numpy(tok), cache, pos)
        np.testing.assert_allclose(_np(logits), j_logits, **tol)
        _check_cache(cache, j_cache, tol)


def test_forward_matches_jax_apply(reference):
    ref = reference
    model = _port_model(ref)
    logits_j, aux_j = jax.jit(lambda p, t: ref["jm"].apply(
        p, t, NULL_CTX, q_chunk=CHUNK, kv_chunk=CHUNK))(ref["params"],
                                                         ref["tokens"])
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ref["tokens"]),
                            ShardingCtx("cpu"), q_chunk=CHUNK,
                            kv_chunk=CHUNK)
    assert tuple(logits.shape) == (B, S, ref["tcfg"].vocab)
    np.testing.assert_allclose(_np(logits), _np(logits_j),
                               **TOL[ref["dtype"]])
    assert float(aux) == float(aux_j) == 0.0


def test_full_param_tree_maps_one_to_one():
    """Every leaf of the full JAX tree (layers stacked) lands on a port
    parameter of its shape and dtype (layers unstacked), and none is left
    over; checked on the meta device, so nothing full-width is made."""
    jm = JLM(j_get_config("qwen1.5-4b").model)
    leaves = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
        tree_abstract(jm.params_spec()))
    model = TransformerLM(get_config("qwen1.5-4b").model,
                          device=torch.device("meta"), generator=None)
    load_jax_params(model, leaves)
    flat = flatten(leaves)
    n_stacked = sum(1 for k in flat if k.startswith("stacks."))
    assert len(dict(model.named_parameters())) == \
        len(flat) - n_stacked + 40 * n_stacked
    assert model.num_params() == jm.num_params() == N_FULL
    assert model.blocks[0].mixer.wq.shape == (2560, 20, 128)
    assert model.final_norm.scale.dtype == torch.float32
    assert model.head.dtype == torch.bfloat16


def test_bridge_rejects_a_mismatched_lm_tree():
    jcfg, tcfg = _configs("bfloat16")
    jm = JLM(jcfg)
    tree = jax.tree.map(np.asarray, tree_init(jm.params_spec(),
                                              jax.random.PRNGKey(0)))
    model = TransformerLM(tcfg, device=CPU, generator=None)
    one_layer = jax.tree.map(lambda a: a[:1], tree["stacks"])
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, dict(tree, stacks=one_layer))
    with pytest.raises(ValueError, match="wrong shape"):
        load_jax_params(model, dict(tree, head=tree["head"][:, :7]))
    with pytest.raises(ValueError, match="dtype"):
        load_jax_params(model, dict(tree, head=tree["head"].astype(
            np.float32)))


def test_lm_build_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    cfg = get_config("qwen1.5-4b")
    model = build_model(cfg, ShardingCtx("cpu"), smoke=True, seed=0)
    assert model.num_params() == 148_160
    assert model.head.dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, ShardingCtx("cuda"), smoke=True)


def test_same_seed_same_weights_on_the_cpu():
    a, b = (build_model(get_config("qwen1.5-4b"), ShardingCtx("cpu"),
                        smoke=True, seed=3) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
