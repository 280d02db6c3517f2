"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. They import no jax, so they run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels.conv2d_gemm.conv2d_gemm import conv2d_gemm
from repro_torch.kernels.conv2d_gemm.ref import conv2d_padded
from repro_torch.kernels.util import same_pads
from repro_torch.nn.module import resolve_device


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return resolve_device("cuda")        # TF32 off for the plain version


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,F,k,s,pad_h,dtype", [
    (56, 56, 64, 64, 3, 1, True, torch.float32),
    (224, 224, 3, 64, 7, 2, True, torch.float32),
    (17, 17, 5, 12, 3, 3, True, torch.float32),
    (30, 28, 128, 128, 3, 1, False, torch.float32),
    (28, 28, 128, 128, 3, 2, True, torch.bfloat16),
])
def test_conv2d_gemm_kernel_matches_plain(cuda, H, W, C, F, k, s, pad_h,
                                          dtype):
    """fp32: 1e-4 (sums over K taken in another order); bf16: 3e-2."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, H, W, C), generator=gen).to(cuda, dtype)
    w = (torch.randn((k, k, C, F), generator=gen) / math.sqrt(k * k * C)
         ).to(cuda, dtype)
    before = conv2d_gemm.launches
    y = conv2d_gemm(x, w, strides=(s, s), pad_h=pad_h)
    torch.cuda.synchronize()
    assert conv2d_gemm.launches == before + 1
    ref = conv2d_padded(x, w, (s, s),
                        same_pads(H, k, s) if pad_h else (0, 0),
                        same_pads(W, k, s))
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_conv2d_gemm_rejects_what_the_kernel_cannot_take(cuda):
    x = torch.randn((1, 8, 8, 4), device=cuda)
    w = torch.randn((3, 3, 4, 8), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv2d_gemm(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv2d_gemm(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="one CUDA device"):
        conv2d_gemm(x, w.cpu())
