"""A witness of the reference's pipeline step, which the port's copies: the
JAX package's ``make_pipeline_train_step`` on a (1, 4) mesh of 4 virtual
host devices (its hetero path: the CNN cut into blocks, ``lax.switch``
stage programs over a flat buffer) gives the port's serial SGD step on the
same weights and batch: the smoke CosmoFlow (3 convs, 16³, batch 8, S = 4)
under gpipe, one_f_one_b and interleaved (v = 1: 4 blocks hold no 8
chunks, as the reference's own schedule check runs it) against the port's
plain step, and the smoke ResNet-50 ((1, 1, 1, 1), 64 px, batch 16, S = 4)
under gpipe against the port's ``make_train_step(accum=4)``: the
reference's BatchNorm takes per-microbatch statistics under the pipe, as
the port's does.

The reference runs in a subprocess (``python <this file> <out.npz>``) with
XLA_FLAGS set for 4 host devices, as the JAX package's multi-device checks
do, and writes its initial weights, its losses and its updated parameters;
the test loads the weights into the port's model and steps it. Clipping is
off (grad_clip 1e9). Bars, with what the CPU reads: the loss within 1e-5
relative and the updated parameters within 1e-4 in relative L2 over the
whole model, the port's own pipeline bars (CosmoFlow reads 0 and 5e-9,
ResNet 4.5e-7 and 3.6e-6). The update (new − initial parameters: lr times
the gradient) is held too: CosmoFlow's within 1e-5 (reads 9.8e-7); the
ResNet's within 1e-4 of the reference's own serial step at the microbatch
size (``make_train_step(accum=4)``, reads 4.1e-6: the reference's pipeline
is exact against its own serial step), but within 2e-2 of the port's (reads
7.1e-3): XLA's CPU forward drifts from the port's in BatchNorm's statistics
(ROADMAP caveat e), which four samples a microbatch amplify, as in the
sharded witness (caveat j).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_params
from repro_torch.models.cnn import (CosmoFlow, CosmoFlowConfig, ResNet,
                                    ResNetConfig)
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.training.steps import make_train_step, train_state

LR, S = 3e-3, 4
# (model, schedule, interleaved v)
CASES = [("cosmoflow", s, 1) for s in ("gpipe", "one_f_one_b",
                                        "interleaved")] + [
    ("resnet", "gpipe", 1)]
SHAPES = {"cosmoflow": ((8, 16, 16, 16, 4), "targets"),
          "resnet": ((16, 64, 64, 3), "labels")}


def _batch(arch):
    shape, kind = SHAPES[arch]
    rng = np.random.default_rng(0)
    images = rng.standard_normal(shape, dtype=np.float32)
    other = (rng.standard_normal((shape[0], 4), dtype=np.float32)
             if kind == "targets" else
             rng.integers(0, 10, shape[0]).astype(np.int32))
    return {"images": images, kind: other}


def _check(out_path):
    import jax
    from repro.launch.compat import make_mesh
    from repro.models.cnn import CosmoFlow as JCosmoFlow
    from repro.models.cnn import CosmoFlowConfig as JCosmoFlowConfig
    from repro.models.cnn import ResNet as JResNet
    from repro.models.cnn import ResNetConfig as JResNetConfig
    from repro.nn.module import ShardingCtx as JCtx
    from repro.nn.module import tree_init
    from repro.optim.optimizers import OptimizerConfig as JOpt
    from repro.parallel import make_pipeline_train_step, make_rules
    from repro.nn.module import NULL_CTX
    from repro.training.steps import make_train_step as j_train_step
    from repro.training.steps import train_state_spec
    from repro_torch.bridge import flatten
    assert len(jax.devices()) == 4, jax.devices()
    mesh = make_mesh((1, 4), ("data", "model"))
    ctx = JCtx(mesh, make_rules("pipeline"))
    opt = JOpt(name="sgd", lr=LR, zero1=False, grad_clip=1e9)
    models = {"cosmoflow": JCosmoFlow(JCosmoFlowConfig(img=16, n_conv=3,
                                                       width=8)),
              "resnet": JResNet(JResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                              n_classes=10))}
    out = {}
    for arch, schedule, v in CASES:
        model = models[arch]
        state = tree_init(train_state_spec(model, opt), jax.random.PRNGKey(0))
        batch = {k: jax.numpy.asarray(a) for k, a in _batch(arch).items()}
        step = jax.jit(make_pipeline_train_step(
            model, opt, ctx, segments=S, schedule=schedule,
            virtual_stages=v))
        new, metrics = step(state, batch)
        tag = f"{arch}/{schedule}"
        for k, a in flatten(jax.tree.map(np.asarray, state["params"])).items():
            out[f"{arch}/init/{k}"] = a
        for k, a in flatten(jax.tree.map(np.asarray, new["params"])).items():
            out[f"{tag}/new/{k}"] = a
        out[f"{tag}/loss"] = np.float64(metrics["loss"])
        out[f"{tag}/S"] = np.int64(metrics["pipeline_segments"])
        print(f"{tag}: loss {float(metrics['loss'])!r}")
        if arch == "resnet":
            # the reference's own serial step at the microbatch size
            serial, _ = jax.jit(j_train_step(model, opt, NULL_CTX,
                                             accum=S))(state, batch)
            for k, a in flatten(jax.tree.map(np.asarray,
                                             serial["params"])).items():
                out[f"{arch}/serial/{k}"] = a
    np.savez(out_path, **out)
    print("WITNESS-WRITTEN")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_witness") / "ref.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "WITNESS-WRITTEN" in run.stdout, run.stdout + run.stderr[-3000:]
    return dict(np.load(out))


def _port_step(arch, ref):
    """The port's serial SGD step on the reference's initial weights: the
    plain step for CosmoFlow, the microbatch-size one for ResNet."""
    gen = torch.Generator().manual_seed(1)
    if arch == "cosmoflow":
        model = CosmoFlow(CosmoFlowConfig(img=16, n_conv=3, width=8),
                          device=torch.device("cpu"), generator=gen)
        accum = 1
    else:
        model = ResNet(ResNetConfig("resnet50-smoke", (1, 1, 1, 1),
                                    n_classes=10),
                       device=torch.device("cpu"), generator=gen)
        accum = S
    prefix = f"{arch}/init/"
    load_jax_params(model, {k[len(prefix):]: v for k, v in ref.items()
                            if k.startswith(prefix)})
    opt = OptimizerConfig(name="sgd", lr=LR, grad_clip=1e9)
    batch = {k: torch.from_numpy(a) for k, a in _batch(arch).items()}
    state, metrics = make_train_step(model, opt, ShardingCtx("cpu"),
                                     accum=accum)(train_state(model, opt),
                                                  batch)
    return float(metrics["loss"]), {k: p.detach().numpy()
                                    for k, p in state["params"].items()}


def _tree(ref, prefix):
    return {k[len(prefix):]: a for k, a in ref.items() if k.startswith(prefix)}


def _rel_l2(got, want):
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in want)) ** 0.5


def _update(new, init):
    return {k: new[k] - init[k] for k in init}


@pytest.mark.parametrize("arch,schedule,v", CASES)
def test_reference_pipeline_step_equals_the_ports_serial_step(
        reference, arch, schedule, v):
    loss, params = _port_step(arch, reference)
    tag = f"{arch}/{schedule}"
    assert int(reference[f"{tag}/S"]) == S
    ref_loss = float(reference[f"{tag}/loss"])
    assert abs(ref_loss - loss) <= 1e-5 * abs(loss), (tag, ref_loss, loss)
    new, init = _tree(reference, f"{tag}/new/"), _tree(reference,
                                                      f"{arch}/init/")
    assert set(new) == set(params)
    assert _rel_l2(new, params) <= 1e-4, (tag, _rel_l2(new, params))
    upd = _rel_l2(_update(new, init), _update(params, init))
    if arch == "cosmoflow":
        assert upd <= 1e-5, (tag, upd)
    else:
        serial = _tree(reference, f"{arch}/serial/")
        own = _rel_l2(_update(new, init), _update(serial, init))
        assert own <= 1e-4, (tag, own)
        assert upd <= 2e-2, (tag, upd)


if __name__ == "__main__":
    _check(sys.argv[1])
