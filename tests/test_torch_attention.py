"""The port's chunked ``flash_attention`` and ``plain_attention`` (plain
torch, (B, S, H, D)) against the JAX package's, on the same seeded numpy
inputs, causal and not, with ragged chunks and Sq < Skv; and the port's
``AttentionConfig`` against the reference's.

Bars: fp32 1e-5 (the same algorithm; XLA's and torch's exp differ in the
last bit). bf16: one bf16 ulp (8 significant bits: 2^-7 relative) where
neither side rounds the scores (the two full-matrix plain versions, the
cache contents); 3e-2 wherever one side rounds q·kᵀ to bf16 before the
softmax, as the reference's chunked and
plain paths do: a score of |q·k| ≈ 8-16 has a bf16 ulp of 2^-4, so one flip
of that rounding (the two frameworks sum the dot in another order) moves
its softmax weight by ~1.6 % (scale 1/4), and the output by up to ~3e-2."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jatt
from repro_torch.nn import attention as tatt

F32 = dict(rtol=1e-5, atol=1e-5)
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


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False)])
@pytest.mark.parametrize("sq,skv,chunk", [(24, 24, 8), (21, 21, 8),
                                          (8, 24, 4)])
def test_chunked_and_plain_attention_match_reference(sq, skv, chunk, kw,
                                                     dtype):
    """(B, S, H, D) layout; Sq < Skv puts the queries at the end."""
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 3, 16)).astype(np.float32)
            for _ in range(2))
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    tol = F32 if dtype == "float32" else BF16_SCORES
    o_j = jatt.flash_attention(*jargs, q_chunk=chunk, kv_chunk=chunk, **kw)
    o_t = tatt.flash_attention(*targs, q_chunk=chunk, kv_chunk=chunk, **kw)
    np.testing.assert_allclose(_np(o_t), _np(o_j), **tol)
    np.testing.assert_allclose(_np(tatt.plain_attention(*targs, **kw)),
                               _np(jatt.plain_attention(*jargs, **kw)), **tol)


def test_attention_config_fields_match_reference():
    """The port keeps the reference's fields that Qwen1.5-4B sets, in its
    order and with its defaults."""
    j_default = {f.name: f.default
                 for f in dataclasses.fields(jatt.AttentionConfig)}
    names = [f.name for f in dataclasses.fields(tatt.AttentionConfig)]
    assert names == [n for n in j_default if n in names]
    for f in dataclasses.fields(tatt.AttentionConfig):
        assert f.default == j_default[f.name], f.name
