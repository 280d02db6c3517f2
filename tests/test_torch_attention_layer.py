"""The port's ``Attention`` module against the JAX package's, with the JAX
weights carried over by ``repro_torch.bridge``: ``forward`` (the
reference's ``apply``) with ``use_pallas`` off and on, ``decode`` after a
prompt written into the cache, the kernel path's conditions, and the
(B, H, S, D) views of (B, S, H, D) tensors that it hands the kernel.

Bars: fp32 1e-5 (the same algorithm; XLA's and torch's exp differ in the
last bit). bf16: one bf16 ulp (8 significant bits: 2^-7 relative) where
neither side rounds the scores (the two full-matrix plain versions, the
cache contents); 3e-2 wherever one side rounds q·kᵀ to bf16 before the
softmax, as the reference's chunked and
plain paths do: a score of |q·k| ≈ 8-16 has a bf16 ulp of 2^-4, so one flip
of that rounding (the two frameworks sum the dot in another order) moves
its softmax weight by ~1.6 % (scale 1/4), and the output by up to ~3e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import _attn_prefill as j_attn_prefill
from repro.nn import attention as jatt
from repro.nn.module import NULL_CTX, tree_init
from repro_torch.bridge import load_jax_params
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.nn import attention as tatt
from repro_torch.nn.module import ShardingCtx, zeros_like_spec

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = dict(rtol=2 ** -7, atol=2 ** -8)
BF16_SCORES = dict(rtol=3e-2, atol=3e-2)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    """fp32 numpy copy of a torch tensor or a jax array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _attention_pair(dtype):
    """A JAX Attention and the port's, with the JAX weights carried over."""
    jdt, tdt = DT[dtype]
    jcfg = jatt.AttentionConfig(32, 4, 4, 8, use_bias=True, dtype=jdt)
    tcfg = tatt.AttentionConfig(32, 4, 4, 8, use_bias=True, dtype=tdt)
    jmod = jatt.Attention(jcfg)
    params = tree_init(jmod.params_spec(), jax.random.PRNGKey(0))
    # the reference initialises biases to zero: give them values
    rng = np.random.default_rng(2)
    params = {k: (jnp.asarray(0.1 * rng.standard_normal(p.shape), p.dtype)
                  if k.startswith("b") else p) for k, p in params.items()}
    tmod = tatt.Attention(tcfg, device=CPU, generator=torch.Generator())
    load_jax_params(tmod, jax.tree.map(np.asarray, params))
    return jmod, params, tmod


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_forward_matches_reference(use_pallas, dtype):
    jdt, tdt = DT[dtype]
    jmod, params, tmod = _attention_pair(dtype)
    x = np.random.default_rng(3).standard_normal((2, 24, 32)).astype(
        np.float32)
    y_j = jmod.apply(params, jnp.asarray(x, jdt), NULL_CTX, q_chunk=8,
                     kv_chunk=8)
    with torch.no_grad():
        y_t = tmod(torch.from_numpy(x).to(tdt),
                   ShardingCtx("cpu", use_pallas=use_pallas), q_chunk=8,
                   kv_chunk=8)
    tol = F32 if dtype == "float32" else BF16_SCORES
    np.testing.assert_allclose(_np(y_t), _np(y_j), **tol)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("S,cache_len", [
    (10, 16),                                  # cache longer than prompt
    (13, 16)])                                 # the last step fills it
def test_attention_decode_matches_reference(S, cache_len, dtype):
    """A prompt of S tokens written by the prefill, then three decode steps
    of one token; outputs and the cache after each."""
    jdt, tdt = DT[dtype]
    jmod, params, tmod = _attention_pair(dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    steps = rng.standard_normal((3, 2, 1, 32)).astype(np.float32)
    tol = F32 if dtype == "float32" else BF16_ULP

    jcache = jax.tree.map(jnp.zeros_like, tree_init(
        jmod.cache_spec(2, cache_len, dtype=jdt), jax.random.PRNGKey(0)))
    _, jcache = j_attn_prefill(jmod, params, jnp.asarray(x, jdt), jcache,
                               NULL_CTX, "chunked", 8, 8)
    tcache = zeros_like_spec(tmod.cache_spec(2, cache_len, dtype=tdt), CPU)
    ctx = ShardingCtx("cpu")
    with torch.no_grad():
        tmod.prefill(torch.from_numpy(x).to(tdt), tcache, ctx, q_chunk=8,
                     kv_chunk=8)
        for i, xs in enumerate(steps):
            y_j, jcache = jmod.decode(params, jnp.asarray(xs, jdt), jcache,
                                      S + i)
            y_t, tcache = tmod.decode(torch.from_numpy(xs).to(tdt), tcache,
                                      S + i, ctx)
            np.testing.assert_allclose(
                _np(y_t), _np(y_j), **(F32 if tol is F32 else BF16_SCORES))
            for name in ("k", "v"):
                np.testing.assert_allclose(_np(tcache[name]),
                                           _np(jcache[name]), **tol)


@pytest.mark.parametrize("kv_heads,S", [(4, 6), (4, 1), (2, 6), (1, 6)])
def test_kernel_path_checks_its_conditions(kv_heads, S):
    """The module computes only what the kernel takes (causal
    self-attention, equal q and kv heads), so with use_pallas the kernel
    (its plain version on the CPU) gives the full-matrix result; a config
    with grouped kv heads cannot be built."""
    cfg = tatt.AttentionConfig(32, 4, kv_heads, 8, dtype=torch.float32)
    if kv_heads != 4:
        with pytest.raises(NotImplementedError, match="grouped kv heads"):
            tatt.Attention(cfg, device=CPU, generator=torch.Generator())
        return
    mod = tatt.Attention(cfg, device=CPU, generator=torch.Generator())
    x = torch.randn(1, S, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        q, k, v = mod._qkv(x, torch.arange(S)[None])
        ref = mod._out(tatt.plain_attention(q, k, v))
        got = mod(x, ShardingCtx("cpu", use_pallas=True))
    torch.testing.assert_close(got, ref, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wrapper_takes_the_models_layout(causal):
    """(B, H, S, D) views of (B, S, H, D) tensors, as ``Attention`` passes
    them, give what contiguous copies give."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 40, 3, 16)))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    o = flash_attention(*views, causal=causal)
    assert torch.equal(o, flash_attention(
        *(t.contiguous() for t in views), causal=causal))
