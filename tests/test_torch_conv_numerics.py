"""The arithmetic of the tensor-core ``conv2d_gemm`` kernel
(``csrc/conv2d_gemm.cu``), which cannot run here, emulated in plain torch
and held against the JAX package's ``conv2d_gemm`` (Pallas, interpret mode)
and ``conv2d_ref`` on the same seeded numpy inputs.

The emulation (``repro_torch.kernels.conv2d_gemm.emulate``) follows the
kernel: TF32 rounding on the int32 bits (hi to nearest, lo = x − hi
truncated as the tensor core reads it), three products per k-step of 8
summed in fp32, and, where ``split_plan`` (for 132 SMs) splits K, the
ranges' sums added in order.

Bar: the one ``chip_smoke.py`` and the ``cuda`` tests hold the kernel to
in fp32, |y − ref| ≤ 1e-4 + 1e-4·|ref| (sums over K of up to 4608 terms
taken in another order); the emulation is held to a tenth of it. One test
pins why the operands are split: one TF32 pass (hi·hi only, as cuDNN with
TF32 on) reads 7–10× that bar at K ≥ 1152, while 3×TF32 stays within a
few hundredths of it. Another pins that bf16 inputs lose nothing in one
TF32 product (8 significant bits fit TF32's 11), so the bf16 entry is
exact up to its fp32 sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv2d_gemm as jax_conv2d_gemm
from repro.kernels import conv2d_ref as jax_conv2d_ref
from repro_torch.kernels.conv2d_gemm.conv2d_gemm import (BLOCK_K, BLOCK_M,
                                                         split_plan)
from repro_torch.kernels.conv2d_gemm.emulate import (emulate, tf32_rna,
                                                     tf32_trunc)
from repro_torch.kernels.util import cdiv

TOL = 1e-4          # the fp32 bar: atol = rtol = 1e-4
SMS = 132           # an H100's SMs, for split_plan


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bar_ratio(out, ref) -> float:
    """max |out - ref| / (TOL + TOL·|ref|): the bar fails above 1."""
    out, ref = (torch.from_numpy(np.array(t, dtype=np.float32))
                for t in (out, ref))
    return float(((out - ref).abs() / (TOL + TOL * ref.abs())).max())


def _inputs(B, H, C, F, seed=0):
    """N(0, 1) x and w at the model's fan-in scale, 3 × 3 filters."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, C), dtype=np.float32)
    w = (rng.standard_normal((3, 3, C, F)) / np.sqrt(9 * C)).astype(np.float32)
    return x, w


def _plan_split(x, w, s) -> int:
    B, H, _, C = x.shape
    return split_plan(B * cdiv(H, s) ** 2, w.shape[-1], 9 * C, SMS)[1]


# (B, H, C, F, stride): ResNet-50's stage-2 (K = 1152), stage-3 stride-2
# (K = 2304) and stage-4 (K = 4608) convs at a few filters
SHAPES = [(2, 14, 128, 64, 1), (2, 14, 256, 32, 2), (8, 7, 512, 32, 1)]


@pytest.mark.parametrize("B,H,C,F,s", SHAPES)
def test_three_tf32_holds_the_bar_against_both_references(B, H, C, F, s):
    x, w = _inputs(B, H, C, F)
    split = _plan_split(x, w, s)
    assert split > 1                   # these shapes take the split-K path
    y = emulate(torch.from_numpy(x), torch.from_numpy(w), s, split=split)
    assert bool(torch.isfinite(y).all())
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for ref in (jax_conv2d_gemm(jx, jw, strides=(s, s), interpret=True),
                jax_conv2d_ref(jx, jw, (s, s))):
        assert y.shape == ref.shape
        assert _bar_ratio(y, ref) <= 0.1


@pytest.mark.parametrize("B,H,C,F,s", SHAPES[:2])
def test_one_tf32_pass_exceeds_the_bar(B, H, C, F, s):
    """Why the kernel splits its operands: hi·hi alone (cuDNN's TF32, and
    ``chip_smoke.py``'s planted fault_tf32_once) reads several times the
    bar at K ≥ 1152, against the JAX package's fp32 conv."""
    x, w = _inputs(B, H, C, F, seed=1)
    ref = jax_conv2d_ref(jnp.asarray(x), jnp.asarray(w), (s, s))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert _bar_ratio(emulate(tx, tw, s, products=1), ref) > 3.0
    assert _bar_ratio(emulate(tx, tw, s), ref) <= 0.1


def test_truncated_accumulation_keeps_the_bar_at_k4608():
    """Tensor cores are reported to add into their fp32 accumulator with
    truncation. Even with every one of the 3 × 576 additions at K = 4608
    rounded toward zero, 3×TF32 stays under 0.3 of the bar, the level at
    which a second accumulator (per-k-tile sums added in fp32 registers)
    would be needed; against an fp64 reference, so only the kernel's own
    error counts."""
    x, w = _inputs(8, 7, 512, 32, seed=2)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ref64 = torch.nn.functional.conv2d(
        tx.double().permute(0, 3, 1, 2), tw.double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    y = emulate(tx, tw, 1, split=_plan_split(x, w, 1), truncate=True)
    assert _bar_ratio(y, ref64.float()) <= 0.3


def test_split_carries_22_bits():
    """hi + lo is x exactly; lo as the tensor core reads it (truncated to
    TF32) leaves at most 2^-21 of |x|, where hi alone leaves up to 2^-11."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(100_000) * np.exp2(
        rng.uniform(-20, 20, 100_000))).astype(np.float32))
    hi = tf32_rna(x)
    assert torch.equal((x - hi) + hi, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    rel = ((hi + tf32_trunc(x - hi)).double() - x.double()).abs() \
        / x.double().abs()
    assert float(rel.max()) <= 2 ** -21
    assert float((hi - x).abs().div(x.abs()).max()) > 2 ** -13


def test_bf16_is_exact_in_one_tf32_product():
    """The bf16 entry runs hi·hi alone with hi = the widened bf16 value: TF32
    rounding leaves it unchanged, lo is 0, and every product is the exact
    product of the bf16 values, so the only roundings are the fp32 sums."""
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(50_000, dtype=np.float32)
                             * 100).to(torch.bfloat16).float()
            for _ in range(2))
    for v in (a, b):
        assert torch.equal(tf32_rna(v), v) and torch.equal(tf32_trunc(v), v)
        assert not (v - tf32_rna(v)).any()
    assert torch.equal((a * b).double(), a.double() * b.double())


def test_split_plan_fills_an_h100_at_resnet50_shapes():
    """Every ResNet-50 conv shape at batch 32 puts at least 132 blocks in
    flight; the 17 sites' stages 3-4 split K, the stem and stage 1 take
    64-wide tiles."""
    cases = {  # name: (M, F, K)
        "stem": (32 * 112 * 112, 64, 147), "s1_56": (32 * 56 * 56, 64, 576),
        "s2_56to28": (32 * 28 * 28, 128, 1152),
        "s1_28": (32 * 28 * 28, 128, 1152),
        "s2_28to14": (32 * 14 * 14, 256, 2304),
        "s1_14": (32 * 14 * 14, 256, 2304),
        "s2_14to7": (32 * 7 * 7, 512, 4608), "s1_7": (32 * 7 * 7, 512, 4608)}
    plans = {}
    for name, (M, F, K) in cases.items():
        block_n, split = plan = split_plan(M, F, K, SMS)
        plans[name] = plan
        assert cdiv(M, BLOCK_M) * cdiv(F, block_n) * split >= SMS, name
    assert plans["stem"][0] == plans["s1_56"][0] == 64
    assert all(plans[n][1] > 1 for n in ("s1_14", "s2_14to7", "s1_7"))
    # the splits that timed fastest, or within 0.6 % of it, among 1-6 on
    # an H100 (scripts/conv_gemm_study.py)
    assert [plans[n][1] for n in cases] == [1, 1, 2, 2, 4, 4, 5, 5]


def test_split_plan_leaves_no_range_empty():
    """The kernel refuses a split whose last range holds no k-tile; the plan
    never asks for one, at any K from one k-tile up."""
    for K in list(range(1, 80)) + [147, 576, 1152, 2304, 4608, 9999]:
        for M, F in ((128, 64), (1568, 512), (6272, 256), (10 ** 6, 16)):
            block_n, split = split_plan(M, F, K, SMS)
            k_tiles = cdiv(K, BLOCK_K)
            assert block_n in (64, 128) and 1 <= split <= k_tiles
            assert (split - 1) * cdiv(k_tiles, split) < k_tiles
