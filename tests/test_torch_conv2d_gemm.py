"""Port's conv2d_gemm (plain version on the CPU) vs the JAX package's Pallas
kernel in interpret mode and its lax.conv reference, on the cases of
tests/test_kernels.py. Same numpy inputs to both; tolerances as there:
2e-4 fp32, 3e-2 bf16, 1e-5 on ResNet-50's stride-2 shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv2d_gemm as jax_conv2d_gemm
from repro.kernels import conv2d_ref as jax_conv2d_ref
from repro_torch.kernels import conv2d_gemm, conv2d_ref

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape_x, shape_w, seed=0, w_scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_x, dtype=np.float32),
            (rng.standard_normal(shape_w, dtype=np.float32) * w_scale))


def _both(x, w, dtype="float32"):
    jd, td = _DTYPES[dtype]
    return (jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
            torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("HW,C,F,k", [((16, 12), 32, 64, 3), ((8, 8), 16, 16, 1),
                                      ((12, 16), 8, 128, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_gemm_sweep_matches_jax(HW, C, F, k, dtype):
    x, w = _inputs((2, *HW, C), (k, k, C, F))
    jx, jw, tx, tw = _both(x, w, dtype)
    out = conv2d_gemm(tx, tw)
    assert out.dtype == tw.dtype and out.is_contiguous()
    tol = 2e-4 if dtype == "float32" else 3e-2
    for ref in (jax_conv2d_gemm(jx, jw, interpret=True), jax_conv2d_ref(jx, jw)):
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


RESNET50_STRIDE2 = [((56, 56), 64, 64, 3), ((28, 28), 128, 128, 3),
                    ((14, 14), 256, 256, 3), ((56, 56), 256, 512, 1)]


@pytest.mark.parametrize("HW,C,F,k", RESNET50_STRIDE2)
def test_conv2d_gemm_stride2_resnet50_shapes_match_jax(HW, C, F, k):
    """Weights at the model's own fan-in scale (1/sqrt(k·k·C)), so outputs
    are O(1) as in the network: at the 0.1 scale of test_kernels.py they
    reach ~5, where oneDNN's and XLA's fp32 sums over K = 2304, taken in
    another order, already differ by ~1e-5."""
    x, w = _inputs((2, *HW, C), (k, k, C, F), w_scale=1 / np.sqrt(k * k * C))
    jx, jw, tx, tw = _both(x, w)
    out = conv2d_gemm(tx, tw, strides=(2, 2))
    assert tuple(out.shape) == (2, HW[0] // 2, HW[1] // 2, F)
    np.testing.assert_allclose(_f32(out), _f32(jax_conv2d_ref(jx, jw, (2, 2))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _f32(out), _f32(jax_conv2d_gemm(jx, jw, strides=(2, 2), interpret=True)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("HW,C,F,k,s", [((15, 13), 8, 16, 5, 2),
                                        ((16, 12), 8, 16, 2, 2),
                                        ((32, 32), 16, 32, 3, 4),
                                        ((17, 17), 5, 12, 3, 3),
                                        ((224, 224), 3, 8, 7, 2)])
def test_conv2d_gemm_strided_odd_shapes_match_jax(HW, C, F, k, s):
    """Non-dividing extents, even kernels and the 7×7/2 stem keep XLA's
    asymmetric SAME split."""
    x, w = _inputs((1, *HW, C), (k, k, C, F))
    jx, jw, tx, tw = _both(x, w)
    out = conv2d_gemm(tx, tw, strides=(s, s))
    ref = jax_conv2d_ref(jx, jw, (s, s))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_f32(conv2d_ref(tx, tw, (s, s))), _f32(ref),
                               rtol=2e-4, atol=2e-4)
    if HW[0] < 64:       # interpret mode is slow at the stem's 224²
        np.testing.assert_allclose(
            _f32(out),
            _f32(jax_conv2d_gemm(jx, jw, strides=(s, s), interpret=True)),
            rtol=2e-4, atol=2e-4)


def test_conv2d_gemm_halo_aware_consumes_padded_tile():
    """pad_h=False: the tile already carries its kh−1 boundary rows —
    VALID over H, SAME over W."""
    H, W, C, F, k = 12, 16, 8, 16, 3
    x, w = _inputs((2, H + k - 1, W, C), (k, k, C, F))
    jx, jw, tx, tw = _both(x, w)
    out = conv2d_gemm(tx, tw, pad_h=False)
    assert tuple(out.shape) == (2, H, W, F)
    np.testing.assert_allclose(
        _f32(out), _f32(jax_conv2d_gemm(jx, jw, pad_h=False, interpret=True)),
        rtol=2e-4, atol=2e-4)


def test_conv2d_gemm_halo_aware_rejects_strides():
    x, w = _inputs((1, 10, 8, 4), (3, 3, 4, 8))
    with pytest.raises(ValueError, match="stride-1 only"):
        conv2d_gemm(torch.from_numpy(x), torch.from_numpy(w), strides=(2, 2),
                    pad_h=False)


def test_conv2d_gemm_rejects_what_the_kernel_cannot_take():
    x, w = _inputs((1, 8, 8, 4), (3, 3, 5, 8))
    with pytest.raises(ValueError, match="channels"):
        conv2d_gemm(torch.from_numpy(x), torch.from_numpy(w))
    with pytest.raises(ValueError, match="B,H,W,C"):
        conv2d_gemm(torch.from_numpy(x)[0], torch.from_numpy(w))


def test_conv2d_gemm_refuses_autograd_like_the_reference():
    """jax.grad through the Pallas conv fails to linearize; the port raises
    instead of differentiating a different function."""
    x, w = _inputs((1, 8, 8, 4), (3, 3, 4, 8))
    tw = torch.from_numpy(w).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv2d_gemm(torch.from_numpy(x), tw)
    with torch.no_grad():
        conv2d_gemm(torch.from_numpy(x), tw)


def test_conv2d_gemm_launch_counter_stays_zero_on_cpu():
    x, w = _inputs((2, 8, 8, 4), (3, 3, 4, 8))
    before = conv2d_gemm.launches
    conv2d_gemm(torch.from_numpy(x), torch.from_numpy(w), strides=(2, 2))
    assert conv2d_gemm.launches == before == 0
