"""The port's ``ssd_chunk`` (on the CPU: its plain version, ``ssd_chunk_ref``
plus the inter-chunk recurrence) against the JAX package's, on the same
seeded numpy inputs: the Pallas ``ssd_chunk`` in interpret mode at
``test_ssd_chunk_sweep``'s shapes, with one group expanded over the heads
and with a chunk that does not divide S; the naive ``ssd_ref``; and
``SSDBlock._ssd`` with an initial state.

Bars: rtol = atol = 1e-4 against the chunked JAX functions (the same fp32
algorithm, its sums and cumsum taken in another order); the reference's own
2e-3 against the naive per-token recurrence; 1e-5 between the two naive
recurrences (the same order of operations)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_chunk as j_ssd_chunk
from repro.kernels import ssd_ref as j_ssd_ref
from repro.nn.ssm import SSDBlock as JSSDBlock
from repro.nn.ssm import SSMConfig as JSSMConfig
from repro_torch.kernels import ssd_chunk, ssd_ref
from repro_torch.nn.module import ShardingCtx
from repro_torch.nn.ssm import SSDBlock, SSMConfig

B = 2
CHUNK_TOL = dict(rtol=1e-4, atol=1e-4)
# (S, H, P, N, chunk): test_ssd_chunk_sweep's two shapes
SWEEP = [(64, 4, 8, 16, 16), (128, 2, 16, 8, 32)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(S, H, P, N, groups=None, seed=0):
    """x, dt (after softplus), A, Bm, Cm as fp32 numpy arrays, drawn as
    ``test_ssd_chunk_sweep`` draws them; Bm and Cm with ``groups`` groups
    (default: one per head)."""
    rng = np.random.default_rng(seed)
    G = groups or H
    x = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, G, N)) * 0.5
    Cm = rng.standard_normal((B, S, G, N)) * 0.5
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S,H,P,N,chunk,groups", [
    *(s + (None,) for s in SWEEP),
    (64, 4, 8, 16, 16, 1),     # one group, an expand view over the heads
    (100, 2, 8, 16, 16, None),  # largest_divisor(100, 16) = 10
])
def test_ssd_chunk_matches_jax_pallas(S, H, P, N, chunk, groups):
    x, dt, A, Bm, Cm = _inputs(S, H, P, N, groups)
    jB, jC = (np.repeat(m, H // m.shape[2], axis=2) for m in (Bm, Cm))
    y_j, st_j = j_ssd_chunk(x, dt, A, jB, jC, chunk=chunk, interpret=True)
    tx, tdt, tA, tB, tC = _t(x, dt, A, Bm, Cm)
    if groups == 1:
        tB, tC = (m.expand(B, S, H, N) for m in (tB, tC))
    y, st = ssd_chunk(tx, tdt, tA, tB, tC, chunk=chunk)
    assert tuple(y.shape) == (B, S, H, P) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **CHUNK_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), **CHUNK_TOL)


@pytest.mark.parametrize("S,H,P,N,chunk", SWEEP)
def test_ssd_chunk_matches_the_naive_recurrence(S, H, P, N, chunk):
    x, dt, A, Bm, Cm = _inputs(S, H, P, N, seed=1)
    y_j, st_j = j_ssd_ref(x, dt, A, Bm, Cm)
    y, st = ssd_chunk(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=2e-3,
                               atol=2e-3)


def test_port_naive_ref_matches_jax_naive_ref():
    x, dt, A, Bm, Cm = _inputs(*SWEEP[0][:4], seed=2)
    y_j, st_j = j_ssd_ref(x, dt, A, Bm, Cm)
    y, st = ssd_ref(*_t(x, dt, A, Bm, Cm))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssd_with_init_state_matches_jax_ssd(use_pallas):
    """``SSDBlock._ssd`` from a nonzero state, one group over two heads of
    64 (the smoke Mamba's SSD), 3 chunks of 16: the plain chunked path and
    the kernel's wrapper against the reference's ``_ssd``."""
    S, H, P, N = 48, 2, 64, 16
    x, dt, A, Bm, Cm = _inputs(S, H, P, N, groups=1, seed=3)
    init = (np.random.default_rng(4).standard_normal((B, H, P, N)) * 0.5
            ).astype(np.float32)
    jcfg = JSSMConfig(64, d_state=N, head_dim=P, chunk=16)
    y_j, st_j = JSSDBlock(jcfg)._ssd(x, dt, A, Bm, Cm, init_state=init)
    blk = SSDBlock(SSMConfig(64, d_state=N, head_dim=P, chunk=16),
                   device=torch.device("meta"), generator=None)
    y, st = blk._ssd(*_t(x, dt, A, Bm, Cm), init_state=torch.from_numpy(init),
                     ctx=ShardingCtx("cpu", use_pallas=use_pallas))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **CHUNK_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), **CHUNK_TOL)
    # the wrapper's own init_state entry gives the same numbers
    Bh, Ch = (torch.from_numpy(m).expand(B, S, H, N) for m in (Bm, Cm))
    y2, st2 = ssd_chunk(*_t(x, dt, A), Bh, Ch, chunk=16,
                        init_state=torch.from_numpy(init))
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_j), **CHUNK_TOL)
    np.testing.assert_allclose(st2.numpy(), np.asarray(st_j), **CHUNK_TOL)


def test_ssd_chunk_raises_under_autograd():
    x, dt, A, Bm, Cm = _t(*_inputs(*SWEEP[0][:4]))
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ssd_chunk(x, dt, A, Bm, Cm, chunk=16)
    with torch.no_grad():
        y, _ = ssd_chunk(x, dt, A, Bm, Cm, chunk=16)
    assert not y.requires_grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_ssd_chunk_takes_fp32_only(dtype):
    x, dt, A, Bm, Cm = _t(*_inputs(*SWEEP[0][:4]))
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x.to(dtype), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x, dt, A, Bm, Cm.to(dtype), chunk=16)


def test_model_path_raises_when_the_chunk_does_not_divide_s():
    """The wrapper cuts S = 100 into chunks of 10, but the model path keeps
    the reference's rule (Q = min(chunk, S), S % Q raises) on both paths."""
    x, dt, A, Bm, Cm = _t(*_inputs(100, 2, 64, 16, groups=1))
    blk = SSDBlock(SSMConfig(64, d_state=16, chunk=16),
                   device=torch.device("meta"), generator=None)
    for use_pallas in (False, True):
        with pytest.raises(ValueError, match="must divide chunk"):
            blk._ssd(x, dt, A, Bm, Cm,
                     ctx=ShardingCtx("cpu", use_pallas=use_pallas))
    with pytest.raises(ValueError, match="must divide chunk"):
        JSSDBlock(JSSMConfig(64, d_state=16, chunk=16))._ssd(
            *(jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm)))
