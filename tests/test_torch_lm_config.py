"""The port's Qwen1.5-4B config against the JAX package's (every field the
port keeps is equal, every field it lacks is at the reference's default),
the features the port's LM does not take yet, and the bridge's mapping of
the reference's stacked layers onto per-layer modules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.attention import AttentionConfig
from repro_torch.nn.ffn import FFNConfig


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_fields(tcfg, jcfg, where):
    """Every field of the port's config equals the reference's, and every
    field the port leaves out is at the reference's default: the reference
    asks for nothing the port lacks."""
    mine = {f.name for f in dataclasses.fields(tcfg)}
    for f in dataclasses.fields(jcfg):
        j = getattr(jcfg, f.name)
        if f.name in ("attn", "ffn"):
            _same_fields(getattr(tcfg, f.name), j, f"{where}.{f.name}")
        elif f.name == "dtype":
            assert j == jnp.bfloat16 and tcfg.dtype == torch.bfloat16, where
        elif f.name in mine:
            assert getattr(tcfg, f.name) == j, (where, f.name)
        else:
            assert j == f.default, (where, f.name, j)


def test_qwen_config_matches_jax():
    jc, tc = j_get_config("qwen1.5-4b"), get_config("qwen1.5-4b")
    assert (tc.name, tc.family, tc.source) == (jc.name, jc.family, jc.source)
    _same_fields(tc.model, jc.model, "model")
    _same_fields(tc.smoke_model, jc.smoke_model, "smoke_model")
    assert tc.model.attn.rope_base == 10000.0


@pytest.mark.parametrize("change", [
    dict(attn=AttentionConfig(64, 4, 2, 16)),
    dict(attn=AttentionConfig(64, 4, 1, 16)),
    dict(ffn=FFNConfig(64, 128, activation="gelu"))])
def test_unported_lm_features_raise(change):
    cfg = dataclasses.replace(get_config("qwen1.5-4b").smoke_model, **change)
    with pytest.raises(NotImplementedError):
        TransformerLM(cfg, device=torch.device("meta"), generator=None)


def test_bridge_unstacks_pattern_positions_in_layer_order():
    """With a pattern of two kinds the reference stacks layers 0, 2, 4 at
    stacks/0 and 1, 3, 5 at stacks/1; they land on blocks 0..5 in order."""
    model = torch.nn.Module()
    model.blocks = torch.nn.ModuleList(torch.nn.Module() for _ in range(6))
    for blk in model.blocks:
        blk.w = torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16))
    layer = np.arange(6, dtype=np.float32)[:, None] * np.ones(2, np.float32)
    tree = {"stacks": [{"w": jnp.asarray(layer[p::2], jnp.bfloat16)}
                       for p in range(2)]}
    load_jax_params(model, jax.tree.map(np.asarray, tree))
    assert [float(b.w.detach()[0]) for b in model.blocks] == [0, 1, 2, 3, 4, 5]
