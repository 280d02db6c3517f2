"""The flash_attention kernel's wrapper and plain version against the JAX
package, on the same seeded numpy inputs: on CPU tensors the wrapper runs
the plain version (``attention_ref``), held against the reference's
``attention_ref`` and its chunked ``nn.attention.flash_attention`` (the
Pallas flash kernel does not run on this jax, ROADMAP caveat 3.a). The
module-level attention is in ``test_torch_attention*.py``.

Bars: fp32 1e-5 (the same algorithm; XLA's and torch's exp differ in the
last bit). bf16: one bf16 ulp (8 significant bits: 2^-7 relative) where
neither side rounds the scores (the two full-matrix plain versions, the
cache contents); 3e-2 wherever one side rounds q·kᵀ to bf16 before the
softmax, as the reference's chunked and
plain paths do: a score of |q·k| ≈ 8-16 has a bf16 ulp of 2^-4, so one flip
of that rounding (the two frameworks sum the dot in another order) moves
its softmax weight by ~1.6 % (scale 1/4), and the output by up to ~3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.nn import attention as jatt
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = dict(rtol=2 ** -7, atol=2 ** -8)
BF16_SCORES = dict(rtol=3e-2, atol=3e-2)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 64, 16), (1, 3, 37, 32),
                                   (1, 2, 96, 128)])
def test_kernel_plain_version_matches_reference(shape, causal, dtype):
    """The wrapper on CPU tensors = the plain version; (B, H, S, D)."""
    jdt, tdt = DT[dtype]
    q, k, v = _qkv(shape)
    o_j = j_attention_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          causal=causal)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = flash_attention.launches
    o_t = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == before
    assert torch.equal(o_t, attention_ref(tq, tk, tv, causal=causal))
    assert o_t.dtype == tdt and tuple(o_t.shape) == shape
    np.testing.assert_allclose(_np(o_t), _np(o_j),
                               **(F32 if dtype == "float32" else BF16_ULP))
    # against the reference's chunked flash, the model's own path, (B,S,H,D)
    o_c = jatt.flash_attention(*(jnp.asarray(a, jdt).transpose(0, 2, 1, 3)
                                 for a in (q, k, v)), causal=causal,
                               q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(_np(o_t), _np(o_c).transpose(0, 2, 1, 3),
                               **(F32 if dtype == "float32" else BF16_SCORES))


def test_flash_wrapper_rejects_what_it_cannot_take():
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(q, q[:, :1], q)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(q.requires_grad_(), q, q)
