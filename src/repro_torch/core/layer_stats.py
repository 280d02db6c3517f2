"""Per-layer tensor statistics (paper Table 2 notation); the port's copy of
``repro.core.layer_stats`` over the port's configs.

The oracle consumes a list of ``LayerStat`` — per-layer |x|, |y|, |w|, FLOPs
and the split-dimension sizes that bound each parallel strategy (F_l, C_l,
spatial size, halo size). Sizes are ELEMENTS PER SAMPLE (paper convention);
a "sample" is an image for CNNs and a full sequence for LMs.

Extractors are analytic (no tracing): they walk the same config objects the
models are built from, so the oracle stays allocation-free. The port has the
four CNNs and the LM block kinds "attn" and "ssm" (Qwen1.5-4B, Mamba-2
780m); the MoE, MLA and recurrent stats, and the encoder-decoder's, come
with those models.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.cnn import (CosmoFlowConfig, ResNetConfig, VGGConfig,
                          _VGG16_LAYOUT)
from ..models.transformer import LMConfig


@dataclass(frozen=True)
class LayerStat:
    name: str
    kind: str            # conv | fc | attn | ffn | moe | ssm | rec | norm | embed
    x: int               # |x_l| elements per sample
    y: int               # |y_l| elements per sample
    w: int               # |w_l| (+bias) elements
    flops_fwd: float     # FLOPs per sample, forward
    F: int = 0           # output channels / filters / heads (filter-par limit)
    C: int = 0           # input channels (channel-par limit)
    spatial: int = 0     # spatial/sequence extent (spatial-par limit)
    halo: int = 0        # halo elements per spatial boundary (paper halo(|x|))
    seq_recurrent: bool = False  # True → spatial/sequence split inapplicable
    flops_bwd_exact: float = 0.0  # measured/derived backward FLOPs per
                                  # sample when the extractor can compute
                                  # them (conv: dL/dx + dL/dw each cost a
                                  # full conv → 2×fw, plus the fw-shaped
                                  # recompute-free term differs from the
                                  # 2×fw heuristic on strided/1x1 layers);
                                  # 0.0 → unknown, consumers fall back

    @property
    def flops_bwd(self) -> float:
        # the oracle's TimeModel keeps the paper's BW ≈ 2× forward
        # approximation (calibrations and pinned crossovers assume it);
        # stage partitioners that want the exact count read
        # ``flops_bwd_exact`` directly (parallel/schedules/stages.py)
        return 2.0 * self.flops_fwd  # BW_data + BW_weight ≈ 2× forward


# ---------------------------------------------------------------------------
# CNNs
# ---------------------------------------------------------------------------

def _conv_stat(name, cin, cout, k, spatial_in, stride, nd) -> LayerStat:
    sp_out = tuple(max(1, s // stride) for s in spatial_in)
    x = cin * int(np.prod(spatial_in))
    y = cout * int(np.prod(sp_out))
    w = cout * cin * k ** nd
    flops = 2.0 * y * cin * k ** nd
    # halo: K/2 rows on each side of a 1-D split of the first spatial dim
    halo = (k // 2) * cin * int(np.prod(spatial_in[1:])) if k > 1 else 0
    # exact backward: dL/dw correlates x with dy (2·y·cin·k^nd, same as
    # fw) and dL/dx is the transposed conv over the INPUT extent
    # (2·x·cout·k^nd) — on strided layers that is more than fw, so the
    # 2×fw heuristic undercounts
    bwd = 2.0 * x * cout * k ** nd + flops
    return LayerStat(name, "conv", x, y, w, flops, F=cout, C=cin,
                     spatial=int(np.prod(spatial_in)), halo=halo,
                     flops_bwd_exact=bwd), sp_out


def resnet_stats(cfg: ResNetConfig, img: int = 224) -> list[LayerStat]:
    stats = []
    st, sp = _conv_stat("stem", 3, cfg.width, 7, (img, img), 2, 2)
    stats.append(st)
    sp = tuple(s // 2 for s in sp)  # maxpool
    in_ch = cfg.width
    for stage, n in enumerate(cfg.stage_sizes):
        mid = cfg.width * (2 ** stage)
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            st1, _ = _conv_stat(f"s{stage}b{b}c1", in_ch, mid, 1, sp, 1, 2)
            st2, sp2 = _conv_stat(f"s{stage}b{b}c2", mid, mid, 3, sp, stride, 2)
            st3, _ = _conv_stat(f"s{stage}b{b}c3", mid, mid * 4, 1, sp2, 1, 2)
            stats += [st1, st2, st3]
            if stride != 1 or in_ch != mid * 4:
                stp, _ = _conv_stat(f"s{stage}b{b}proj", in_ch, mid * 4, 1, sp,
                                    stride, 2)
                stats.append(stp)
            sp = sp2
            in_ch = mid * 4
    head_in = in_ch
    stats.append(LayerStat("head", "fc", head_in, cfg.n_classes,
                           head_in * cfg.n_classes, 2.0 * head_in * cfg.n_classes,
                           F=cfg.n_classes, C=head_in, spatial=1))
    return stats


def vgg_stats(cfg: VGGConfig) -> list[LayerStat]:
    stats, in_ch, sp = [], 3, (cfg.img, cfg.img)
    i = 0
    for v in _VGG16_LAYOUT:
        if v == "M":
            sp = tuple(s // 2 for s in sp)
            continue
        st, _ = _conv_stat(f"conv{i}", in_ch, v, 3, sp, 1, 2)
        stats.append(st)
        in_ch = v
        i += 1
    flat = in_ch * int(np.prod(sp))
    for j, (fin, fout) in enumerate([(flat, 4096), (4096, 4096),
                                     (4096, cfg.n_classes)]):
        stats.append(LayerStat(f"fc{j}", "fc", fin, fout, fin * fout,
                               2.0 * fin * fout, F=fout, C=fin, spatial=1))
    return stats


def cosmoflow_stats(cfg: CosmoFlowConfig) -> list[LayerStat]:
    stats, in_ch = [], cfg.in_ch
    sp = (cfg.img,) * 3
    for i in range(cfg.n_conv):
        out = cfg.width * (2 ** i)
        st, _ = _conv_stat(f"conv{i}", in_ch, out, 3, sp, 1, 3)
        stats.append(st)
        sp = tuple(s // 2 for s in sp)
        in_ch = out
    flat = in_ch * int(np.prod(sp))
    for j, (fin, fout) in enumerate([(flat, 128), (128, 64),
                                     (64, cfg.n_targets)]):
        stats.append(LayerStat(f"fc{j}", "fc", fin, fout, fin * fout,
                               2.0 * fin * fout, F=fout, C=fin, spatial=1))
    return stats


# ---------------------------------------------------------------------------
# Transformers (per-layer; a "sample" = one sequence of length S)
# ---------------------------------------------------------------------------

def _attn_stat(name, d, Hq, Hkv, hd, S, bias=False) -> LayerStat:
    """Full causal attention (the reference's ``window=None`` case)."""
    w = d * (Hq + 2 * Hkv) * hd + Hq * hd * d + (Hq + 2 * Hkv) * hd * (1 if bias else 0)
    proj_flops = 2.0 * S * (d * (Hq + 2 * Hkv) * hd + Hq * hd * d)
    attn_flops = 2.0 * 2.0 * S * S / 2 * Hq * hd
    return LayerStat(name, "attn", S * d, S * d, w,
                     proj_flops + attn_flops, F=Hq, C=Hkv,
                     spatial=S, halo=0)


def _ffn_stat(name, d, ff, S) -> LayerStat:
    """The gated (GLU) FFN: three d×ff weights."""
    w = d * ff * 3
    return LayerStat(name, "ffn", S * d, S * d, w, 2.0 * S * w, F=ff, C=d,
                     spatial=S)


def _ssm_stat(name, c, S) -> LayerStat:
    w = (2 * c.d_inner + 2 * c.bc_dim + c.n_heads) * c.d_model \
        + c.d_conv * (c.d_inner + 2 * c.bc_dim) + c.d_inner * c.d_model \
        + 3 * c.n_heads + c.d_inner
    proj = 2.0 * S * ((2 * c.d_inner + 2 * c.bc_dim + c.n_heads) * c.d_model
                      + c.d_inner * c.d_model)
    Q = c.chunk
    ssd = S / Q * (2.0 * Q * Q * c.n_heads * c.d_state          # scores
                   + 2.0 * Q * Q * c.d_inner                     # intra y
                   + 4.0 * Q * c.d_inner * c.d_state)            # states+inter
    return LayerStat(name, "ssm", S * c.d_model, S * c.d_model, w,
                     proj + ssd, F=c.n_heads, C=c.n_heads, spatial=S,
                     seq_recurrent=True)


def lm_stats(cfg: LMConfig, S: int) -> list[LayerStat]:
    """The reference's ``lm_stats`` for the block kinds the port's LM has:
    "attn" (full causal attention, bias as configured, a SiLU-GLU FFN) and
    "ssm" (the SSD, no FFN)."""
    stats = [LayerStat("embed", "embed", S, S * cfg.d_model,
                       cfg.vocab * cfg.d_model, 0.0, F=cfg.d_model,
                       C=cfg.vocab, spatial=S)]
    for i, kind in enumerate(cfg.block_kinds()):
        if kind == "attn":
            a = cfg.attn
            stats.append(_attn_stat(f"L{i}.attn", cfg.d_model, a.n_heads,
                                    a.n_kv_heads, a.head_dim, S,
                                    bias=a.use_bias))
            stats.append(_ffn_stat(f"L{i}.ffn", cfg.d_model, cfg.ffn.d_ff, S))
        elif kind == "ssm":
            stats.append(_ssm_stat(f"L{i}.ssm", cfg.ssm, S))
        else:
            raise NotImplementedError(
                f"layer stats of block kind {kind!r} come with the port of "
                f"its model (ROADMAP queue 1 item 10)")
    stats.append(LayerStat("head", "fc", S * cfg.d_model, S * cfg.vocab,
                           0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab,
                           2.0 * S * cfg.d_model * cfg.vocab,
                           F=cfg.vocab, C=cfg.d_model, spatial=S))
    return stats


def stats_for(model_cfg, S: int = 4096) -> list[LayerStat]:
    if isinstance(model_cfg, LMConfig):
        return lm_stats(model_cfg, S)
    if isinstance(model_cfg, ResNetConfig):
        return resnet_stats(model_cfg)
    if isinstance(model_cfg, VGGConfig):
        return vgg_stats(model_cfg)
    if isinstance(model_cfg, CosmoFlowConfig):
        return cosmoflow_stats(model_cfg)
    raise TypeError(f"no layer stats for {type(model_cfg).__name__}")
