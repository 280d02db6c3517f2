"""The port's strategy tables and ``spec_to_pspec`` against the JAX
package's, on every strategy × the CNNs' parameter and activation axes ×
meshes (1, 4), (2, 2) and (4, 1). ``spec_to_pspec`` reads only the mesh's
``shape`` mapping, so both get the same stand-in; no ranks are started."""
import types

import pytest
import torch

from repro.nn.module import spec_to_pspec as j_spec_to_pspec
from repro.parallel.strategies import list_strategies as j_list_strategies
from repro.parallel.strategies import make_rules as j_make_rules
from repro_torch.configs import get_config
from repro_torch.launch.build import batch_axes, build_model
from repro_torch.nn.module import ShardingCtx, spec_to_pspec
from repro_torch.parallel.strategies import list_strategies, make_rules
from repro_torch.models.cnn import ACT_2D, ACT_3D, VGG, CosmoFlow, ResNet

MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
          {"data": 4, "model": 1}]
ARCHS = {"resnet50": ResNet, "vgg16": VGG, "cosmoflow": CosmoFlow}


def _axes_and_shapes():
    """(logical axes, shape) of every parameter of the three CNNs (full
    width, on ``meta``), their batch leaves and the activations at the
    reference's constraint points."""
    out = set()
    for arch, cls in ARCHS.items():
        model = cls(get_config(arch).model, device=torch.device("meta"),
                    generator=None)
        for p in model.parameters():
            out.add((p.axes, tuple(p.shape)))
        for name, shape in (("images", (8, 32, 32, 3)), ("labels", (8,)),
                            ("images", (8, 16, 16, 16, 4)),
                            ("targets", (8, 4))):
            out.add((batch_axes(name, len(shape)), shape))
    for shape in ((8, 56, 56, 256), (8, 7, 7, 2048), (6, 14, 14, 10)):
        out.add((ACT_2D, shape))
    out.add((ACT_3D, (8, 16, 16, 16, 32)))
    out.add((ACT_3D, (4, 6, 6, 6, 10)))
    return sorted(out, key=repr)


def test_strategy_tables_match_jax():
    assert list_strategies() == j_list_strategies()
    for s in list_strategies():
        assert make_rules(s).table == j_make_rules(s).table, s
    with pytest.raises(KeyError, match="unknown strategy"):
        make_rules("bogus")


# the CNN rows one by one, then every other table together
@pytest.mark.parametrize("strategies", [
    ("data",), ("spatial",), ("filter",), ("channel",), ("df",), ("ds",),
    ("df_zero3", "df_zero1", "ep_df", "summa", "serve_tp", "serve_seqkv",
     "pipeline")], ids=lambda s: "+".join(s))
def test_spec_to_pspec_matches_jax(strategies):
    """Every (axes, shape) under the strategy on each mesh resolves to the
    same mesh axes per dim, with and without the shape (the fallbacks: a
    mesh axis used at most once, a dim no requested axis divides
    replicates)."""
    cases = _axes_and_shapes()
    for strategy in strategies:
        rules, jrules = make_rules(strategy), j_make_rules(strategy)
        for shape_map in MESHES:
            mesh = types.SimpleNamespace(shape=shape_map)
            for axes, shape in cases:
                for sh in (shape, None):
                    want = tuple(j_spec_to_pspec(axes, jrules, mesh, sh))
                    got = spec_to_pspec(axes, rules, mesh, sh)
                    assert got == want, (strategy, shape_map, axes, sh)


def test_fallbacks_of_the_cnn_heads_and_stems():
    """Under df the ResNet head puts mlp and vocab both on "model", so vocab
    replicates; under channel the 3-channel stem's conv_in replicates; a
    10-class head on a 4-wide axis replicates; a batch of 6 under data on a
    (2, 2) mesh keeps the prefix of its axes that divides."""
    m22 = types.SimpleNamespace(shape={"data": 2, "model": 2})
    m14 = types.SimpleNamespace(shape={"data": 1, "model": 4})
    assert spec_to_pspec(("mlp", "vocab"), make_rules("df"), m22,
                         (2048, 1000)) == ("model", None)
    assert spec_to_pspec(("conv_k", None, "conv_in", "conv_out"),
                         make_rules("channel"), m22, (7, 7, 3, 64)) == \
        (None, None, None, None)
    assert spec_to_pspec(("vocab",), make_rules("df"), m14, (10,)) == (None,)
    assert spec_to_pspec(("batch",), make_rules("data"), m22, (6,)) == \
        ("data",)


def test_parameters_record_the_reference_axes():
    """Each port parameter's logical axes are its JAX ParamSpec's."""
    from repro.models.cnn import VGG as JVGG
    from repro.models.cnn import VGGConfig as JVGGConfig
    from repro.models.cnn import ResNet as JResNet
    from repro.models.cnn import ResNetConfig as JResNetConfig
    from repro_torch.bridge import flatten
    for arch, jmodel in (
            ("vgg16", JVGG(JVGGConfig(n_classes=10, img=32))),
            ("resnet50", JResNet(JResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                               n_classes=10)))):
        spec = flatten(jmodel.params_spec())
        model = build_model(get_config(arch), ShardingCtx("cpu"), smoke=True)
        named = dict(model.named_parameters())
        assert set(named) == set(spec)
        for k, p in named.items():
            assert p.axes == spec[k].axes, (arch, k)
