"""The port's Mamba-2 780m config against the JAX package's, field by field
(recursing into ``ssm``; every field the port leaves out is at the
reference's default), and the block kinds the port's LM does not build
yet, which raise at construction."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro_torch.configs import get_config
from repro_torch.models.transformer import TransformerLM


def _same_fields(tcfg, jcfg, where):
    """Every field of the port's config equals the reference's, and every
    field the port leaves out is at the reference's default; nested
    configs (``attn``, ``ffn``, ``ssm``) are compared the same way."""
    mine = {f.name for f in dataclasses.fields(tcfg)}
    for f in dataclasses.fields(jcfg):
        j = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(j):
            assert f.name in mine, (where, f.name)
            _same_fields(getattr(tcfg, f.name), j, f"{where}.{f.name}")
        elif f.name == "dtype":
            assert j == jnp.bfloat16 and tcfg.dtype == torch.bfloat16, where
        elif f.name in mine:
            assert getattr(tcfg, f.name) == j, (where, f.name)
        else:
            assert j == f.default, (where, f.name, j)


def test_mamba_config_matches_jax():
    jc, tc = j_get_config("mamba2-780m"), get_config("mamba2-780m")
    assert (tc.name, tc.family, tc.source) == (jc.name, jc.family, jc.source)
    _same_fields(tc.model, jc.model, "model")
    _same_fields(tc.smoke_model, jc.smoke_model, "smoke_model")
    m = tc.model
    assert (m.d_model, m.n_layers, m.vocab, m.pattern) == (1536, 48, 50280,
                                                           ("ssm",))
    assert (m.ssm.d_inner, m.ssm.n_heads, m.ssm.bc_dim, m.ssm.chunk) == \
        (3072, 48, 128, 256)
    assert m.tie_embeddings and m.attn is None and m.ffn is None


@pytest.mark.parametrize("kind", ["moe", "mla", "rec", "local_attn"])
def test_unported_block_kinds_raise(kind):
    cfg = dataclasses.replace(get_config("mamba2-780m").smoke_model,
                              pattern=("ssm", kind))
    with pytest.raises(NotImplementedError, match=kind):
        TransformerLM(cfg, device=torch.device("meta"), generator=None)


def test_unknown_block_kind_raises():
    cfg = dataclasses.replace(get_config("mamba2-780m").smoke_model,
                              pattern=("conv",))
    with pytest.raises(ValueError, match="unknown block kind"):
        TransformerLM(cfg, device=torch.device("meta"), generator=None)


def test_cache_spec_per_kind():
    """SSM layers keep an fp32 state and conv tails whatever dtype the
    attention caches ask for; attention layers keep k and v."""
    model = TransformerLM(get_config("mamba2-780m").model,
                          device=torch.device("meta"), generator=None)
    spec = model.cache_spec(4, 2080, dtype=torch.bfloat16)["blocks"]
    assert len(spec) == 48
    assert {k: (tuple(t.shape), t.dtype) for k, t in spec[0].items()} == {
        "state": ((4, 48, 64, 128), torch.float32),
        "conv_x": ((4, 3, 3072), torch.float32),
        "conv_B": ((4, 3, 128), torch.float32),
        "conv_C": ((4, 3, 128), torch.float32)}
    qwen = TransformerLM(get_config("qwen1.5-4b").smoke_model,
                         device=torch.device("meta"), generator=None)
    kv = qwen.cache_spec(2, 16)["blocks"][0]
    assert set(kv) == {"k", "v"} and kv["k"].dtype == torch.bfloat16
