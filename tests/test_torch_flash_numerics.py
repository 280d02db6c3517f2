"""The arithmetic of the tensor-core ``flash_attention`` kernel (the bf16
entry of ``csrc/flash_attention.cu``), which cannot run here, emulated in
plain torch and held against the port's ``attention_ref`` and the JAX
package's ``attention_ref`` on the same seeded numpy inputs in bf16.

The emulation follows the kernel: tiles of 64 or 128 keys; S = q·kᵀ of the
bf16 values summed in fp32 (each bf16 product is exact in fp32), times
scale·log2(e) after the sum; masked logits -1e30; an online softmax with a
running max and sum in the log2 domain; P = exp2(s - m) split into P_hi =
bf16(P) and P_lo = bf16(P - P_hi), both multiplied with V's bf16 values
and summed in fp32; o = acc / max(l, 1e-30) rounded to bf16; the depth
zero-padded to 64 or 128 as the kernel's shared tiles are.

Bar: the one ``chip_smoke.py`` and the ``cuda`` tests hold the kernel to,
|o - ref| ≤ 1e-3 + 2^-7·|ref| (one bf16 ulp of the output, which a last-bit
fp32 difference can flip, plus 1e-3 for outputs near 0). One test pins why
P is split: rounded once to bf16 it moves the output past that bar."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention.ref import attention_ref

RTOL, ATOL = 2 ** -7, 1e-3
LOG2E = 1.4426950408889634
NEG_INF = -1e30


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as fp32."""
    return x.to(torch.bfloat16).float()


def emulate(q, k, v, *, causal: bool, block_k: int = 64,
            split: bool = True) -> torch.Tensor:
    """The kernel's arithmetic on bf16 (B, H, S, D) q, k, v; ``split=False``
    rounds P once to bf16 instead, as a kernel without the split would."""
    B, H, S, D = q.shape
    depth = 64 if D <= 64 else 128
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, depth - D))
                  for t in (q, k, v))
    scale = float(np.float32(1.0 / math.sqrt(D)))   # the wrapper's c_float
    scale_log2 = float(np.float32(scale * LOG2E))
    m = torch.full((B, H, S, 1), NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, depth))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (qf @ kt.transpose(-1, -2)) * scale_log2
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(kpos > qpos, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = _bf16(p)
        pv = p_hi @ vt
        if split:
            pv = pv + _bf16(p - p_hi) @ vt
        acc = acc * alpha + pv
        m = m_new
    o = acc / l.clamp_min(1e-30)
    assert not o[..., D:].any()         # the padded depth stays zero
    return o[..., :D].to(torch.bfloat16)


def _bar_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (atol + rtol·|ref|): the bar fails above 1."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (ATOL + RTOL * ref.abs())
                  ).max())


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in qkv],
            [jnp.asarray(a, jnp.bfloat16) for a in qkv])


@pytest.mark.parametrize("shape,causal,block_k", [
    ((1, 2, 2048, 128), True, 64),     # the Qwen prompt's rows, 2 heads
    ((1, 2, 2048, 128), True, 128),
    ((1, 2, 1000, 128), True, 64),     # a ragged last tile
    ((1, 2, 512, 64), False, 64),      # non-causal, depth 64
    ((1, 2, 300, 72), True, 64),       # depth 72, zero-padded to 128
])
def test_split_p_holds_the_bar_against_both_references(shape, causal,
                                                       block_k):
    (q, k, v), (jq, jk, jv) = _inputs(shape)
    o = emulate(q, k, v, causal=causal, block_k=block_k)
    assert o.shape == q.shape and bool(torch.isfinite(o.float()).all())
    ref = attention_ref(q, k, v, causal=causal)
    ref_j = torch.from_numpy(np.asarray(
        j_attention_ref(jq, jk, jv, causal=causal), dtype=np.float32))
    assert _bar_ratio(o, ref) <= 1.0
    assert _bar_ratio(o, ref_j) <= 1.0


def test_p_rounded_once_exceeds_the_bar():
    """Why the kernel splits P: rounded once to bf16 (relative error up to
    2^-9, the usual tensor-core flash kernel), the output leaves the bar at
    the Qwen prompt's rows, while the split stays inside it. Pins the reason
    for the split and ``chip_smoke.py``'s planted ``fault_p_bf16``."""
    (q, k, v), _ = _inputs((1, 4, 2048, 128))
    ref = attention_ref(q, k, v, causal=True)
    assert _bar_ratio(emulate(q, k, v, causal=True, split=False), ref) > 1.0
    assert _bar_ratio(emulate(q, k, v, causal=True), ref) <= 1.0


def test_hi_lo_split_carries_16_bits():
    """P_hi + P_lo is within 2^-16 of P for any P in (0, 1]: the residual
    P - P_hi is exact in fp32, and each bf16 rounding is within 2^-9."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(np.exp2(-rng.uniform(0, 100, 100_000)).astype(
        np.float32))
    p_hi = _bf16(p)
    assert torch.equal((p - p_hi) + p_hi, p)
    err = ((p_hi + _bf16(p - p_hi)) - p).abs() / p
    assert float(err.max()) <= 2 ** -16
    assert float((p_hi - p).abs().div(p).max()) > 2 ** -10   # hi alone not
