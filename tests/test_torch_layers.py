"""Port's CNN layers vs the JAX package's, forward and gradients (against
jax.grad), on the same numpy inputs and the same weights (carried over by
repro_torch.bridge), at 1e-5 in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as jl
from repro.nn.module import tree_init
from repro_torch.bridge import load_jax_params
from repro_torch.nn import layers as tl
from repro_torch.nn.module import ShardingCtx

TOL = 1e-5
CPU = ShardingCtx("cpu")
GEN = torch.Generator().manual_seed(0)


def _check(jax_fn, jax_params, torch_fn, torch_module, x, seed=1):
    """Forward y and the gradients of sum(y·r) w.r.t. x and every param.

    r is scaled by 1/sqrt(positions), as a mean over the batch and pixels
    would scale it, so weight gradients are O(1) and 1e-5 is a bar on the
    algorithm rather than on fp32 summation order."""
    y_j = jax.jit(jax_fn)(jax_params, jnp.asarray(x))
    r = (np.random.default_rng(seed).standard_normal(y_j.shape)
         / np.sqrt(y_j.size / y_j.shape[-1])).astype(np.float32)
    gp_j, gx_j = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jax_fn(p, xx) * r), argnums=(0, 1)))(
            jax_params, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    y_t = torch_fn(tx)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=TOL, atol=TOL)
    (y_t * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_j),
                               rtol=TOL, atol=TOL)
    if torch_module is not None:
        for name, p in torch_module.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_j[name]),
                                       rtol=TOL, atol=TOL, err_msg=name)


def _x(shape, seed=0, loc=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("HW,C,F,k,s,bias,groups", [
    ((32, 32), 3, 8, 7, 2, False, 1),     # the stem: SAME pads (2, 3)
    ((16, 16), 8, 8, 3, 2, False, 1),     # bottleneck entry: pads (0, 1)
    ((15, 13), 4, 6, 2, 2, True, 1),      # even kernel, odd extents
    ((14, 14), 8, 16, 1, 2, False, 1),    # the strided 1×1 projection
    ((9, 11), 8, 8, 3, 1, True, 2),       # grouped
    ((6, 7, 5), 2, 4, 3, 1, True, 1),     # 3-D
])
def test_conv_matches_jax(HW, C, F, k, s, bias, groups):
    nd = len(HW)
    kw = dict(strides=(s,) * nd, use_bias=bias, feature_group_count=groups)
    jconv = jl.Conv(C, F, (k,) * nd, **kw)
    params = tree_init(jconv.params_spec(), jax.random.PRNGKey(0))
    if bias:    # zeros at init: give the bias something to carry
        params["b"] = jnp.asarray(_x((F,), seed=3))
    tconv = tl.Conv(C, F, (k,) * nd, **kw, device=CPU.device, generator=GEN)
    load_jax_params(tconv, jax.tree.map(np.asarray, params))
    _check(jconv.apply, params, lambda x: tconv(x, CPU), tconv,
           _x((2, *HW, C)))


@pytest.mark.parametrize("HW,window,strides,padding", [
    ((14, 14), (3, 3), (2, 2), "SAME"),   # the stem's pool: pads (0, 1)
    ((15, 15), (3, 3), (2, 2), "SAME"),
    ((8, 12), (2, 2), (2, 2), "VALID"),
])
def test_max_pool_matches_jax(HW, window, strides, padding):
    _check(lambda p, x: jl.max_pool(x, window, strides, padding), {},
           lambda x: tl.max_pool(x, window, strides, padding), None,
           _x((2, *HW, 4)))


def test_batchnorm_matches_jax():
    """Batch statistics with the E[x²]−μ² variance, on inputs off zero."""
    C = 6
    params = {"scale": jnp.asarray(_x((C,), seed=4, loc=1.0)),
              "bias": jnp.asarray(_x((C,), seed=5))}
    tbn = tl.BatchNorm(C, device=CPU.device)
    load_jax_params(tbn, jax.tree.map(np.asarray, params))
    _check(jl.BatchNorm(C).apply, params, lambda x: tbn(x, CPU), tbn,
           _x((4, 5, 5, C), loc=3.0, scale=2.0))


def test_dense_matches_jax():
    jd = jl.Dense(16, 10, use_bias=True)
    params = tree_init(jd.params_spec(), jax.random.PRNGKey(0))
    params["b"] = jnp.asarray(_x((10,), seed=3))
    td = tl.Dense(16, 10, use_bias=True, device=CPU.device, generator=GEN)
    load_jax_params(td, jax.tree.map(np.asarray, params))
    _check(jd.apply, params, lambda x: td(x, CPU), td, _x((4, 16)))


def test_global_avg_pool_matches_jax():
    _check(lambda p, x: jl.global_avg_pool(x), {},
           tl.global_avg_pool, None, _x((3, 7, 7, 8)))


def test_fan_in_init_scale():
    """Fan-in normal over the same axes as repro's fan_in_init: conv
    weights over (kh, kw, C), dense over in_dim."""
    conv = tl.Conv(64, 256, (3, 3), device=CPU.device, generator=GEN)
    dense = tl.Dense(2048, 1000, device=CPU.device, generator=GEN)
    np.testing.assert_allclose(conv.w.std().item(), 1 / np.sqrt(9 * 64),
                               rtol=0.02)
    np.testing.assert_allclose(dense.w.std().item(), 1 / np.sqrt(2048),
                               rtol=0.02)
    assert float(conv.b.detach().abs().max()) == 0.0
