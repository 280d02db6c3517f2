"""The port's ``RMSNorm`` layer against the JAX package's ``RMSNorm.apply``,
on the same seeded numpy inputs, with ``use_pallas`` off (the plain
version) and on (the kernel's wrapper, which runs the plain version on CPU
tensors).

Bars: fp32 1e-5 (XLA's and torch's rsqrt differ in the last bit, nothing
more); bf16 one bf16 ulp (8 significant bits: rtol 2^-7, atol 2^-8 near 0),
since such a last-bit difference in fp32 can flip the final rounding to
bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.layers import RMSNorm as JRMSNorm
from repro_torch.nn.layers import RMSNorm
from repro_torch.nn.module import ShardingCtx

DTYPES = {"float32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16,
                       dict(rtol=2 ** -7, atol=2 ** -8))}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale


def _np(a):
    """fp32 numpy copy of a torch tensor or a jax array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_rmsnorm_layer_matches_jax(use_pallas, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, scale = _inputs((3, 7, 64), seed=1)
    y_j = JRMSNorm(64).apply({"scale": jnp.asarray(scale)},
                             jnp.asarray(x, jdt))
    layer = RMSNorm(64, device=torch.device("cpu"))
    assert layer.scale.dtype == torch.float32
    with torch.no_grad():
        layer.scale.copy_(torch.from_numpy(scale))
        y_t = layer(torch.from_numpy(x).to(tdt),
                    ShardingCtx("cpu", use_pallas=use_pallas))
    np.testing.assert_allclose(_np(y_t), _np(y_j), **tol)
