"""The rmsnorm kernel's wrapper and plain version against the JAX package's,
on the same seeded numpy inputs: the Pallas ``rmsnorm`` in interpret mode
and its ``rmsnorm_ref``. The ``RMSNorm`` layer is in
``test_torch_rmsnorm_layer.py``.

Bars: fp32 1e-5 (XLA's and torch's rsqrt differ in the last bit, nothing
more); bf16 one bf16 ulp (8 significant bits: rtol 2^-7, atol 2^-8 near 0),
since such a last-bit difference in fp32 can flip the final rounding to
bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as j_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm

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
@pytest.mark.parametrize("shape,block_rows", [
    ((8, 128), 256), ((2, 16, 256), 8), ((4, 1, 2560), 256),
    ((37, 128), 16),     # prime row count: the Pallas kernel pads to 48 rows
    ((101, 64), 64)])
def test_rmsnorm_matches_pallas_interpret(shape, block_rows, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, scale = _inputs(shape)
    y_j = j_rmsnorm(jnp.asarray(x, jdt), jnp.asarray(scale),
                    block_rows=block_rows, interpret=True)
    xt = torch.from_numpy(x).to(tdt)
    before = rmsnorm.launches
    y_t = rmsnorm(xt, torch.from_numpy(scale))
    assert rmsnorm.launches == before      # the CPU runs the plain version
    assert y_t.dtype == tdt and tuple(y_t.shape) == shape
    np.testing.assert_allclose(_np(y_t), _np(y_j), **tol)
    np.testing.assert_allclose(_np(rmsnorm_ref(xt, torch.from_numpy(scale))),
                               _np(j_rmsnorm_ref(jnp.asarray(x, jdt),
                                                 jnp.asarray(scale))), **tol)


def test_rmsnorm_rejects_what_it_cannot_take():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(x, torch.ones(7))
    with pytest.raises(NotImplementedError, match="backward"):
        rmsnorm(x.requires_grad_(), torch.ones(8))
