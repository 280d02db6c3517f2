"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The parallel ones start ranks that share the card over gloo
(``repro_torch.launch.spawn``). They import no jax, so they run where only PyTorch is
installed (``--noconftest``: ``tests/conftest.py`` imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.kernels.conv2d_gemm.conv2d_gemm import conv2d_gemm
from repro_torch.kernels.conv2d_gemm.ref import conv2d_padded
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref, ssd_combine
from repro_torch.kernels.ssd_scan.ssd_scan import chunk_outputs, ssd_chunk
from repro_torch.configs import get_config
from repro_torch.core.calibration import calibrate_host_system
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.validation import validate
from repro_torch.data.pipeline import Loader
from repro_torch.launch import train
from repro_torch.launch.build import build_model
from repro_torch.kernels.util import largest_divisor, same_pads
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx, resolve_device, zeros_like_spec
from repro_torch.training.steps import (make_decode_step, make_eval_step,
                                        make_prefill_step)


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


def _conv_inputs(B, H, C, F, k, dtype, device):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((B, H, H, C), generator=gen).to(device, dtype)
    w = (torch.randn((k, k, C, F), generator=gen) / math.sqrt(k * k * C)
         ).to(device, dtype)
    return x, w


# ResNet-50's stage-3 (K = 2304) and stage-4 (K = 4608) convs at batch 8,
# where the wrapper splits K into ranges reduced by a second kernel
@pytest.mark.cuda
@pytest.mark.parametrize("H,C,F,dtype", [
    (14, 256, 256, torch.float32), (7, 512, 512, torch.float32),
    (14, 256, 256, torch.bfloat16), (7, 512, 512, torch.bfloat16)])
def test_conv2d_gemm_split_k_matches_plain(cuda, H, C, F, dtype):
    """fp32: 1e-4; bf16: 3e-2, as above."""
    x, w = _conv_inputs(8, H, C, F, 3, dtype, cuda)
    before = conv2d_gemm.launches
    y = conv2d_gemm(x, w)
    torch.cuda.synchronize()
    assert conv2d_gemm.launches == before + 1     # one per conv
    ref = conv2d_padded(x, w, (1, 1), (1, 1), (1, 1))
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,C,F", [(14, 256, 256), (7, 512, 512)])
def test_conv2d_gemm_is_deterministic(cuda, H, C, F):
    """Split-K partial sums are reduced in a fixed order, never by atomics:
    two calls on the same inputs agree bit for bit."""
    x, w = _conv_inputs(8, H, C, F, 3, torch.float32, cuda)
    assert torch.equal(conv2d_gemm(x, w), conv2d_gemm(x, w))


@pytest.mark.cuda
def test_conv2d_gemm_refuses_autograd_on_the_card(cuda):
    x, w = _conv_inputs(1, 8, 4, 8, 3, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        conv2d_gemm(x, w.requires_grad_())
    with torch.no_grad():
        assert conv2d_gemm(x, w).shape == (1, 8, 8, 8)


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


# rmsnorm: fp32 1e-5 (the sum of squares taken in another order, rsqrt to
# 2 ulp); bf16 one bf16 ulp of the output (8 significant bits: 2^-7
# relative), since a last-bit fp32 difference can flip the final rounding.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,D,dtype", [
    (8192, 2560, torch.bfloat16),      # the Qwen1.5-4B prompt pass
    (4, 2560, torch.bfloat16),         # a decode step
    (8191, 2560, torch.float32),       # a prime row count
    (37, 100, torch.float32),          # rows of 400 B: the scalar path
    (3, 20, torch.bfloat16),
])
def test_rmsnorm_kernel_matches_plain(cuda, rows, D, dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((rows, D), generator=gen).to(cuda, dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=gen)).to(cuda)
    before = rmsnorm.launches
    y = rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    ref = rmsnorm_ref(x, scale)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2 ** -8)
    torch.testing.assert_close(y.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_rmsnorm_rejects_what_the_kernel_cannot_take(cuda):
    x = torch.randn((4, 64), device=cuda)
    scale = torch.ones(64, device=cuda)
    with pytest.raises(TypeError, match="float32 scale"):
        rmsnorm(x.bfloat16(), scale.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsnorm(x.half(), scale)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(torch.randn((64, 4), device=cuda).t(), scale)
    with pytest.raises(ValueError, match="one CUDA device"):
        rmsnorm(x, scale.cpu())


# flash_attention against the full-matrix plain version: fp32 1e-4 (online
# softmax and sums in another order); bf16 one bf16 ulp (2^-7 relative: both
# work in fp32, the tensor-core kernel's P·V with P split into two bf16
# parts, and round only the output, so a last-bit fp32 difference flips
# that rounding by one ulp) plus 1e-3 for outputs near 0, the bar
# chip_smoke.py holds the kernel to and shows to reject planted faults.
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D,causal,dtype,model_layout", [
    (1, 20, 2048, 128, True, torch.bfloat16, True),   # a Qwen1.5-4B prompt
    (1, 20, 2048, 128, True, torch.bfloat16, False),
    (1, 4, 1000, 128, True, torch.bfloat16, False),   # a ragged last tile
    (2, 4, 300, 128, False, torch.bfloat16, True),
    (1, 4, 257, 128, True, torch.float32, False),
    (2, 4, 64, 16, True, torch.float32, True),        # the smoke head dim
    (1, 3, 130, 72, False, torch.float32, False),
    # the tensor-core kernel's branches: depth 64, a depth padded to 128
    # that is not a multiple of 16, one row, a ragged tile past the first
    # K tile, a non-causal ragged S, the smoke head dim (16 columns of a
    # 64-column tile)
    (2, 4, 256, 64, True, torch.bfloat16, True),
    (1, 3, 200, 72, True, torch.bfloat16, False),
    (2, 3, 1, 128, True, torch.bfloat16, False),
    (1, 4, 65, 128, True, torch.bfloat16, True),
    (1, 3, 130, 128, False, torch.bfloat16, False),
    (2, 4, 64, 16, True, torch.bfloat16, True),
])
def test_flash_attention_kernel_matches_plain(cuda, B, H, S, D, causal,
                                              dtype, model_layout):
    """model_layout: (B, H, S, D) views of (B, S, H, D) tensors, as
    ``Attention`` passes them; the output keeps q's strides."""
    gen = torch.Generator().manual_seed(0)
    shape = (B, S, H, D) if model_layout else (B, H, S, D)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for _ in range(3))
    if model_layout:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert o.stride() == q.stride()
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_cannot_take(cuda):
    q = torch.randn((1, 2, 64, 128), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(-1, -2)            # the last dim strided
        flash_attention(t, t, t)
    with pytest.raises(ValueError, match="16 bytes"):
        t = torch.randn((1, 2, 64, 130), device=cuda)[..., :128]
        flash_attention(q, q, t)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn((1, 2, 64, 136), device=cuda)
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q.cpu(), q)


# ssd_chunk against its plain version, both fp32: max |kernel - plain| at
# most 1e-4 of max |plain|, for y and for the states (sums over N and over
# the chunk in another order; the in-block cumsum in another order than
# torch.cumsum, whose last-bit differences at |cum| ~ 10^2 reach exp(cum_i -
# cum_j) as ~1e-5 relative), the bar chip_smoke.py holds the kernel to and
# shows to reject planted faults.
def _ssd_inputs(B, S, H, P, N, groups, device):
    """Mamba-2's distributions: dt = softplus(N(0, 0.5) + dt_bias) with
    dt_bias from the init's range, A = -(1 .. H)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((B, S, H, P), generator=gen)
    dt_bias = torch.log(torch.expm1(torch.exp(
        torch.rand(H, generator=gen) * math.log(100) + math.log(1e-3))))
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((B, S, H), generator=gen) + dt_bias)
    A = -torch.arange(1, H + 1, dtype=torch.float32)
    Bm, Cm = (torch.randn((B, S, groups or H, N), generator=gen)
              for _ in range(2))
    out = [t.to(device) for t in (x, dt, A, Bm, Cm)]
    if groups == 1:
        out[3:] = [m.expand(B, S, H, N) for m in out[3:]]
    return out


def _within_ssd_bar(out, ref):
    return float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk,groups", [
    (2, 64, 4, 8, 16, 16, None),           # test_ssd_chunk_sweep's shape
    (2, 48, 2, 64, 16, 16, 1),             # the smoke Mamba's SSD
    (1, 1000, 4, 64, 128, 256, 1),         # Q = 250: a ragged last tile
    (4, 2048, 48, 64, 128, 256, 1),        # a Mamba-2 780m prompt pass
    (1, 512, 8, 64, 128, 256, None),       # per-head B and C
])
def test_ssd_chunk_kernel_matches_plain(cuda, B, S, H, P, N, chunk, groups):
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, groups, cuda)
    Q = largest_divisor(S, chunk)
    before = ssd_chunk.launches
    got = chunk_outputs(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    ref = ssd_chunk_ref(x, dt, A, Bm, Cm, Q)
    for name, g, r in zip(("y_intra", "states", "decays"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _within_ssd_bar(g, r), name
    init = 0.3 * torch.randn((B, H, P, N), device=cuda)
    y, final = ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk, init_state=init)
    y_p, final_p = ssd_combine(*ref, dt, A, Cm, init)
    assert _within_ssd_bar(y, y_p) and _within_ssd_bar(final, final_p)


@pytest.mark.cuda
def test_ssd_chunk_is_bitwise_repeatable(cuda):
    """Whole tiles (Q 256, N 128, P 64), two chunks and four heads, one group
    and per head: the prep, both stages of the ring and the state block,
    with no atomics, give bitwise the same outputs in every call."""
    for groups in (1, None):
        x, dt, A, Bm, Cm = _ssd_inputs(1, 512, 4, 64, 128, groups, cuda)
        first = chunk_outputs(x, dt, A, Bm, Cm, 256)
        for _ in range(2):
            again = chunk_outputs(x, dt, A, Bm, Cm, 256)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_ssd_chunk_full_tiles_hold_the_bar_with_a_down_to_minus_48(cuda):
    """The Mamba-2 780m chunk (Q 256, N 128, P 64) with its 48 heads, A =
    −(1 .. 48): cum falls to ~−10³ within a chunk, and the 3×TF32 kernel
    stays within the fp32 bar of every output."""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 512, 48, 64, 128, 1, cuda)
    got = chunk_outputs(x, dt, A, Bm, Cm, 256)
    ref = ssd_chunk_ref(x, dt, A, Bm, Cm, 256)
    assert float(ref[2].min()) == 0.0          # exp(cum_end) underflows
    for name, g, r in zip(("y_intra", "states", "decays"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _within_ssd_bar(g, r), name


@pytest.mark.cuda
def test_ssd_chunk_rejects_what_the_kernel_cannot_take(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 2, 8, 16, None, cuda)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="unit-stride"):
        ssd_chunk(x.transpose(-1, -2).contiguous().transpose(-1, -2), dt, A,
                  Bm, Cm)
    with pytest.raises(ValueError, match="P ≤ 64"):
        wide = torch.randn((1, 64, 2, 72), device=cuda)
        ssd_chunk(wide, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_chunk(x, dt.cpu(), A, Bm, Cm)


@pytest.mark.cuda
def test_mamba_smoke_kernel_path_matches_plain(cuda):
    """The smoke Mamba-2 (4 layers, fp32 copy) on the card: a prompt pass
    and two decode steps with use_pallas (9 rmsnorm and 4 ssd_chunk
    launches in the prompt pass) against the plain path, at 1e-4 of the
    logit scale."""
    cfg = get_config("mamba2-780m").smoke_model
    cfg = dataclasses.replace(cfg, dtype=torch.float32, ssm=dataclasses.replace(
        cfg.ssm, dtype=torch.float32))
    model = TransformerLM(cfg, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    outs = []
    for use_pallas in (True, False):
        ctx = ShardingCtx(cuda, use_pallas=use_pallas)
        cache = zeros_like_spec(model.cache_spec(2, 66), cuda)
        r0, s0 = rmsnorm.launches, ssd_chunk.launches
        logits, cache = make_prefill_step(model, ctx)({"tokens": tokens},
                                                      cache)
        if use_pallas:
            assert (rmsnorm.launches - r0, ssd_chunk.launches - s0) == (9, 4)
        seq = [logits]
        decode = make_decode_step(model, ctx)
        for i in range(2):
            logits, cache = decode(seq[0].argmax(-1), cache, 64 + i)
            seq.append(logits)
        outs.append(torch.cat(seq, 1))
    scale = float(outs[1].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_vgg16_smoke_eval_launches_conv2d_gemm_13_times(cuda):
    """The smoke VGG16 (full widths, 32 px) on the card: the use_pallas
    forward runs its 13 HaloConvs on the kernel, and its logits agree with
    the plain path within 1e-3 of |plain| + max|plain| (the logits shrink
    through 16 layers without BatchNorm, so the bar follows their scale)."""
    cfg = get_config("vgg16")
    model = build_model(cfg, ShardingCtx(cuda), smoke=True)
    batch = Loader(train.data_config_for(cfg.smoke_model, 8), cuda).batch_at(0)
    before = conv2d_gemm.launches
    out_k = make_eval_step(model, ShardingCtx(cuda, use_pallas=True))(batch)
    torch.cuda.synchronize()
    assert conv2d_gemm.launches == before + 13
    out_p = make_eval_step(model, ShardingCtx(cuda))(batch)
    assert conv2d_gemm.launches == before + 13
    scale = float(out_p["outputs"].abs().max())
    torch.testing.assert_close(out_k["outputs"], out_p["outputs"], rtol=1e-3,
                               atol=1e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["vgg16", "cosmoflow"])
def test_validate_on_the_card_returns_finite_points(cuda, arch):
    """The smoke models, self-calibrated and with a cluster calibrated on the
    card: one "data" point each, measured and projected finite and
    positive; the card's system model holds its own memory and a measured
    HBM rate."""
    cfg = get_config(arch)
    mc = cfg.smoke_model
    ctx = ShardingCtx(cuda)
    model = build_model(cfg, ctx, smoke=True)
    batch = Loader(train.data_config_for(mc, 4), cuda).batch_at(0)
    fps = float(sum(s.flops_fwd for s in stats_for(mc)))
    sysm = calibrate_host_system(lambda b: model.loss_fn(b, ctx),
                                 model.parameters(), batch, 4 * fps)
    props = torch.cuda.get_device_properties(cuda)
    assert sysm.mem_capacity == props.total_memory
    assert 1e11 < sysm.hbm_bw < 1e14 and sysm.peak_flops > 0
    for cluster in (None, ClusterSpec.from_system(sysm)):
        (pt,) = validate(model, mc, batch, ctx, ["serial", "data"],
                         flops_per_sample=fps, B=4, cluster=cluster)
        assert (pt.strategy, pt.p) == ("data", 1)
        for t in (pt.measured_s, pt.projected_s, pt.projected_serial_s):
            assert math.isfinite(t) and t > 0


def _sharded_haloconv_rank(mesh):
    """A 3×3 HaloConv under the ds rules on a (1, 2) mesh sharing the card:
    the kernel path (pad_h=False on the interior and boundary tiles) and
    the plain path, gathered whole; the kernel's launches."""
    from repro_torch.parallel.halo import HaloConv
    from repro_torch.parallel.sharded import Sharded, placement
    from repro_torch.parallel.strategies import make_rules
    dev = mesh.device
    hc = HaloConv(64, 64, (3, 3), use_bias=True, device=dev,
                  generator=torch.Generator().manual_seed(0))
    x, _ = _conv_inputs(2, 56, 64, 64, 3, torch.float32, "cpu")
    xs = Sharded.of(x.to(dev), placement(mesh, (None, "model", None, None)),
                    mesh)
    out = {}
    for pl in (True, False):
        ctx = ShardingCtx(dev, use_pallas=pl, mesh=mesh,
                          rules=make_rules("ds"))
        before = conv2d_gemm.launches
        with torch.no_grad():
            out[pl] = hc(xs, ctx).full().cpu()
        torch.cuda.synchronize(dev)
        out[f"launches_{pl}"] = conv2d_gemm.launches - before
    return out


@pytest.mark.cuda
def test_sharded_haloconv_on_the_kernel_matches_the_plain_path(cuda):
    """Two ranks on the card over gloo: each runs conv2d_gemm three times
    (interior, top and bottom tiles through the pad_h=False entry) and the
    gathered output agrees with the plain path at the conv bar (1e-4)."""
    from repro_torch.launch.spawn import run_ranks
    res = run_ranks(_sharded_haloconv_rank, 2, backend="gloo",
                    device="cuda", model=2, timeout_s=300)
    for r in res:
        assert r["launches_True"] == 3 and r["launches_False"] == 0
        torch.testing.assert_close(r[True], r[False], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(res[0][True], res[1][True], rtol=0, atol=0)


def _staged_collectives_rank(mesh):
    """The collectives and the halo exchange on CUDA tensors over gloo
    (all-gather, reduce-scatter and send/recv through host buffers,
    all-reduce on the card's tensor as gloo takes it), forward and
    backward, beside the same on CPU tensors."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.halo import halo_exchange
    dev, g = mesh.device, mesh.group(("data", "model"))
    out = {}
    for where in (dev, torch.device("cpu")):
        gen = torch.Generator().manual_seed(mesh.rank)
        x = torch.randn((2, 6, 5, 3), generator=gen).to(where)
        x.requires_grad_()
        r = torch.randn((2, 6 * g.size, 5, 3), generator=gen).to(where)
        y = C.all_gather(x, 1, g)
        h = halo_exchange(x, (1, 2), g)
        s = C.all_reduce(x * 1.0, g)
        loss = (y * r).sum() + (h * h).sum() + s.sum()
        (gx,) = torch.autograd.grad(loss, (x,))
        m = C.all_reduce_max(x.detach().amax().reshape(1), g)
        rs = C.reduce_scatter_blocks(r, 1, g)
        out[where.type] = [t.detach().cpu() for t in (y, h, s, gx, m, rs)]
    return out


@pytest.mark.cuda
def test_host_staged_collectives_on_cuda_tensors(cuda):
    """Four ranks on the card: every collective and the halo exchange give
    on CUDA tensors, forward and backward, what they give on CPU tensors:
    the moved rows and the max bitwise, the sums (gloo's all-reduce of a
    CUDA tensor may add in another order) within 1e-5 of their scale."""
    from repro_torch.launch.spawn import run_ranks
    res = run_ranks(_staged_collectives_rank, 4, backend="gloo",
                    device="cuda", model=2, timeout_s=300)
    names = ("all_gather", "halo", "all_reduce", "grad", "max",
             "reduce_scatter")
    for r in res:
        for name, a, b in zip(names, r["cuda"], r["cpu"]):
            tol = 0.0 if name in ("all_gather", "halo", "max") else \
                1e-5 * float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=lambda m:
                                       f"{name}: {m}")
