"""The port's Mamba-2 ``SSDBlock`` against the JAX package's, at the smoke
Mamba's SSD (d_model 64, d_state 16, two heads of 64, one group, chunk 16):
the same parameters (JAX ``tree_init``, with the zero and one initialised
leaves perturbed so that a misplaced bias or skip shows, carried over by
``bridge.load_jax_params``) and the same seeded inputs through ``forward``
(the reference's ``apply``), ``prefill`` (its ``_recurrent_prefill``, from
a nonzero cache) and ``decode``, with ``use_pallas`` off and on (on the CPU
the kernel's plain version).

Bars: fp32 at 1e-4 (the same algorithm; sums, cumsum and exp in another
order); the conv's bf16 op order exactly (both round each op); the bf16
block at the Qwen tests' bf16 bars, 0.1 absolute plus 5 % relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.transformer import _recurrent_prefill
from repro.nn.module import NULL_CTX, tree_abstract, tree_init
from repro.nn.ssm import SSDBlock as JSSDBlock
from repro.nn.ssm import SSMConfig as JSSMConfig
from repro_torch.bridge import flatten, load_jax_params
from repro_torch.nn.module import ShardingCtx, zeros_like_spec
from repro_torch.nn.ssm import SSDBlock, SSMConfig, _softplus

B, S = 2, 48
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=0.1)
CPU = torch.device("cpu")
SMOKE = dict(d_state=16, head_dim=64, expand=2, chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _blocks(dtype=None):
    """(JAX block, its params, the port's block with them loaded)."""
    jcfg = JSSMConfig(64, dtype=dtype and jnp.bfloat16, **SMOKE)
    jb = JSSDBlock(jcfg)
    params = tree_init(jb.params_spec(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for name in ("conv_b_x", "conv_b_B", "conv_b_C", "d_skip"):
        p = params[name]
        params[name] = (p + rng.standard_normal(p.shape) * 0.1).astype(
            p.dtype)
    params["norm"]["scale"] = params["norm"]["scale"] + 0.1
    tb = SSDBlock(SSMConfig(64, dtype=dtype, **SMOKE), device=CPU,
                  generator=None)
    load_jax_params(tb, jax.tree.map(np.asarray, params))
    return jb, params, tb


def _u(seed=0, dtype=np.float32, steps=S):
    return (np.random.default_rng(seed).standard_normal((B, steps, 64)) * 0.5
            ).astype(dtype)


def _warm_cache(jb):
    """A nonzero cache, the same numbers for both packages."""
    rng = np.random.default_rng(6)
    spec = tree_abstract(jb.cache_spec(B))
    return {k: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
            for k, s in spec.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax_apply(use_pallas):
    jb, params, tb = _blocks()
    u = _u()
    y_j = jax.jit(jb.apply)(params, u)
    with torch.no_grad():
        y = tb(torch.from_numpy(u), ShardingCtx("cpu", use_pallas=use_pallas))
    np.testing.assert_allclose(_np(y), _np(y_j), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax_recurrent_prefill(use_pallas):
    """y and every cache leaf, starting from a nonzero state and tails."""
    jb, params, tb = _blocks()
    u, warm = _u(1), _warm_cache(jb)
    y_j, cache_j = jax.jit(lambda p, x, c: _recurrent_prefill(
        jb, p, x, c, NULL_CTX))(params, u, warm)
    cache = {k: torch.from_numpy(v.copy()) for k, v in warm.items()}
    with torch.no_grad():
        y, out = tb.prefill(torch.from_numpy(u), cache,
                            ShardingCtx("cpu", use_pallas=use_pallas))
    assert out is cache                      # written in place
    np.testing.assert_allclose(_np(y), _np(y_j), **TOL)
    for k in cache_j:
        assert cache[k].dtype == torch.float32
        np.testing.assert_allclose(_np(cache[k]), _np(cache_j[k]), **TOL,
                                   err_msg=k)


def test_decode_matches_jax_decode():
    """Three single-token steps from a nonzero cache."""
    jb, params, tb = _blocks()
    cache_j = _warm_cache(jb)
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_j.items()}
    step = jax.jit(lambda p, x, c: jb.decode(p, x, c, 0))
    ctx = ShardingCtx("cpu", use_pallas=True)
    for t in range(3):
        u = _u(10 + t, steps=1)
        y_j, cache_j = step(params, u, cache_j)
        with torch.no_grad():
            y, cache = tb.decode(torch.from_numpy(u), cache, t, ctx)
        np.testing.assert_allclose(_np(y), _np(y_j), **TOL)
        for k in cache_j:
            np.testing.assert_allclose(_np(cache[k]), _np(cache_j[k]), **TOL,
                                       err_msg=f"step {t} {k}")


def test_chunked_prefill_equals_stepwise_decode():
    """The port's own consistency, as tests/test_blocks.py pins the
    reference's: a 48-token prompt pass (3 chunks, from a zero cache) equals
    48 single-token decode steps, in y and in the final cache, at 2e-3."""
    _, _, tb = _blocks()
    u = torch.from_numpy(_u(2))
    ctx = ShardingCtx("cpu")
    spec = tb.cache_spec(B)
    with torch.no_grad():
        full = zeros_like_spec(spec, CPU)
        y, full = tb.prefill(u, full, ctx)
        step = zeros_like_spec(spec, CPU)
        ys = []
        for t in range(S):
            yt, step = tb.decode(u[:, t:t + 1], step, t, ctx)
            ys.append(yt)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y), rtol=2e-3,
                               atol=2e-3)
    for k in spec:
        np.testing.assert_allclose(_np(step[k]), _np(full[k]), rtol=2e-3,
                                   atol=2e-3, err_msg=k)


def test_softplus_matches_jax_at_the_init_dt_range():
    """dt = softplus(u·w_dt + dt_bias): dt_bias spans softplus⁻¹ of [1e-3,
    0.1] = [-6.9, -2.25] at init and u·w_dt is O(1); the grid runs past 20,
    where F.softplus switches to x. The port's logaddexp form, F.softplus
    and jax.nn.softplus agree to 2 ulp there."""
    x = np.concatenate([np.linspace(-12.0, 4.0, 4001),
                        np.linspace(18.0, 30.0, 101)]).astype(np.float32)
    ref = np.asarray(jax.nn.softplus(x))
    for mine in (_softplus(torch.from_numpy(x)), F.softplus(
            torch.from_numpy(x))):
        np.testing.assert_allclose(mine.numpy(), ref, rtol=2.5e-7, atol=0)


def test_bf16_causal_conv_and_conv_step_round_as_jax():
    """The conv's op order in bf16 (sum of K products, + bias, SiLU, each
    rounded) and the one-token step's (fp32 tail, bf16 einsum): equal to
    the reference's bit for bit."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((B, 20, 96)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 96)) * 0.5, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(96) * 0.1, jnp.bfloat16)
    buf = rng.standard_normal((B, 3, 96)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(np.array(a).view(np.uint16)).view(
        torch.bfloat16) for a in (x, w, b))
    out_j = JSSDBlock._causal_conv(x, w, b)
    out = SSDBlock._causal_conv(tx, tw, tb)
    np.testing.assert_array_equal(_np(out), _np(out_j))
    step_j, tail_j = JSSDBlock._conv_step(buf, x[:, 0], w, b)
    step, tail = SSDBlock._conv_step(torch.from_numpy(buf), tx[:, 0], tw, tb)
    np.testing.assert_array_equal(_np(step), _np(step_j))
    np.testing.assert_array_equal(_np(tail), _np(tail_j))


def test_cache_spec_matches_jax():
    """fp32 leaves of the reference's shapes, whatever the block's dtype."""
    cfg = SSMConfig(1536, d_state=128, dtype=torch.bfloat16)
    jspec = tree_abstract(JSSDBlock(JSSMConfig(
        1536, d_state=128, dtype=jnp.bfloat16)).cache_spec(4))
    spec = SSDBlock(cfg, device=torch.device("meta"),
                    generator=None).cache_spec(4)
    assert {k: (tuple(t.shape), t.dtype) for k, t in spec.items()} == \
        {k: (tuple(s.shape), torch.float32) for k, s in jspec.items()}
    assert all(s.dtype == jnp.float32 for s in jspec.values())
    assert tuple(spec["state"].shape) == (4, 48, 64, 128)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_prefill_matches_jax(use_pallas):
    jb, params, tb = _blocks(torch.bfloat16)
    u = _u(3, dtype=np.float32)
    warm = _warm_cache(jb)
    y_j, cache_j = jax.jit(lambda p, x, c: _recurrent_prefill(
        jb, p, x.astype(jnp.bfloat16), c, NULL_CTX))(params, u, warm)
    cache = {k: torch.from_numpy(v.copy()) for k, v in warm.items()}
    with torch.no_grad():
        y, cache = tb.prefill(torch.from_numpy(u).bfloat16(), cache,
                              ShardingCtx("cpu", use_pallas=use_pallas))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(y_j), **BF16_TOL)
    np.testing.assert_allclose(_np(cache["state"]), _np(cache_j["state"]),
                               **BF16_TOL)


def test_config_and_parameters_match_jax():
    """The port's SSMConfig has the reference's fields, order and defaults,
    and the block's parameters its tree's names, shapes and dtypes."""
    jf = [(f.name, f.default) for f in dataclasses.fields(JSSMConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(SSMConfig)]
    assert tf == jf
    jb, _, tb = _blocks(torch.bfloat16)
    leaves = flatten(jax.tree.map(lambda s: f"{tuple(s.shape)} {s.dtype}",
                                  tree_abstract(jb.params_spec())))
    assert {k: f"{tuple(p.shape)} {str(p.dtype).removeprefix('torch.')}"
            for k, p in tb.named_parameters()} == leaves


def test_gradients_match_jax_where_the_masked_exp_overflows():
    """16 heads (A to −16) with dt ≈ 1 over a chunk of 128: the upper
    triangle's cum_i − cum_j reaches ~2000, so exp overflows there, as it
    does at Mamba-2 780m's widths. The reference's where(causal, exp(diff),
    0) backs that inf through exp as 0·inf = NaN into the gradients of the
    decay path (w_dt, dt_bias, a_log; in a whole model, through the
    clipping norm, every update). The port masks diff before exp: the same
    forward, finite gradients (ROADMAP caveat m). The forward and every
    gradient the reference keeps finite against the reference's, at the
    fp32 bar; the decay path's finite (its formula is held to the
    reference's where nothing overflows, tests/test_torch_lm_train.py)."""
    cfg = dict(d_state=16, head_dim=8, expand=2, chunk=128)
    jb = JSSDBlock(JSSMConfig(64, **cfg))
    params = tree_init(jb.params_spec(), jax.random.PRNGKey(0))
    params["dt_bias"] = jnp.full_like(params["dt_bias"], 0.5413)  # dt ≈ 1
    tb = SSDBlock(SSMConfig(64, **cfg), device=CPU, generator=None)
    load_jax_params(tb, jax.tree.map(np.asarray, params))
    u = _u(steps=128)
    y_j, g_j = jax.value_and_grad(
        lambda p: jb.apply(p, jnp.asarray(u), NULL_CTX).sum())(params)
    y = tb(torch.from_numpy(u), ShardingCtx("cpu")).sum()
    y.backward()
    np.testing.assert_allclose(float(y.detach()), float(y_j), rtol=1e-4)
    want = flatten(jax.tree.map(np.asarray, g_j))
    nan_in_jax = {k for k, g in want.items() if not np.isfinite(g).all()}
    assert nan_in_jax == {"w_dt", "dt_bias", "a_log"}
    for name, p in tb.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        if name not in nan_in_jax:
            np.testing.assert_allclose(_np(p.grad), want[name], err_msg=name,
                                       rtol=1e-4,
                                       atol=1e-4 * np.abs(want[name]).max())
