"""The LM's per-block remat switch (``TransformerLM.forward``/``loss_fn``
``remat=True``: each block under a non-reentrant
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of each
block) on the smoke Qwen1.5-4B (2 layers, d 64) and Mamba-2 780m (4
layers, d 64, chunk 16) in fp32, with JAX's ``tree_init`` weights carried
over by ``repro_torch.bridge``, on one token batch.

Remat recomputes each block's forward in the backward with the same
operations on the same inputs, so on one device the loss and every
gradient are equal, bit for bit, with it on and off. Against the
reference's ``jax.grad`` of ``loss_fn(..., remat=True)`` (its default) the
bars of tests/test_torch_lm_train.py: the loss within 1e-6 relative, each
gradient within 1e-5 in relative L2 (that file's bar on the first AdamW
moment, 0.1·g). With remat on, the bytes saved for the backward (counted
with ``torch.autograd.graph.saved_tensors_hooks``; the checkpointed blocks'
own saves go to the checkpoint's hooks and are recomputed) fall below
half of those without it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenSource as JTokenSource
from repro.models.transformer import TransformerLM as JLM
from repro.nn.module import NULL_CTX, tree_init
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.schedules import make_pipeline_train_step
from repro_torch.training.steps import make_train_step, train_state

ARCHS = ("qwen1.5-4b", "mamba2-780m")
B, S, CHUNK = 4, 32, 8
CPU = ShardingCtx("cpu")
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fp32(cfg, f32):
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=f32)
           for k in ("attn", "ffn", "ssm") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=f32, **sub)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The fp32 JAX model, its tree_init parameters, a token batch, and the
    reference's loss and gradients with remat on."""
    arch = request.param
    jm = JLM(_fp32(j_get_config(arch).smoke_model, jnp.float32))
    params = jax.jit(lambda k: tree_init(jm.params_spec(), k))(
        jax.random.PRNGKey(0))
    batch = JTokenSource(JDataConfig("lm", B, seq_len=S, vocab=jm.cfg.vocab,
                                     seed=0)).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, batch, NULL_CTX, q_chunk=CHUNK,
                             kv_chunk=CHUNK, remat=True), has_aux=True))(
        params)
    tcfg = _fp32(get_config(arch).smoke_model, torch.float32)
    return dict(arch=arch, tcfg=tcfg, params=jax.tree.map(np.asarray, params),
                grads=jax.tree.map(np.asarray, grads), loss=float(loss),
                batch={"tokens": torch.from_numpy(np.asarray(
                    batch["tokens"]))})


def _model(ref, tree=None):
    model = TransformerLM(ref["tcfg"], device=CPU.device, generator=None)
    load_jax_params(model, ref["params"] if tree is None else tree)
    return model


def _loss_and_grads(model, batch, remat):
    loss, _ = model.loss_fn(batch, CPU, q_chunk=CHUNK, kv_chunk=CHUNK,
                            remat=remat)
    names, ps = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, ps)))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    d = torch.linalg.vector_norm((got.double() - want.double()).flatten())
    return float(d / torch.linalg.vector_norm(want.double().flatten())
                 .clamp(min=1e-30))


def test_remat_leaves_the_loss_and_every_gradient_unchanged(ref,
                                                             monkeypatch):
    """Bit for bit, and the blocks really ran under the checkpoint: one
    call a layer."""
    model = _model(ref)
    calls = []

    def counted(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    off = _loss_and_grads(model, ref["batch"], False)
    assert calls == []
    on = _loss_and_grads(model, ref["batch"], True)
    assert calls == [False] * ref["tcfg"].n_layers
    assert torch.equal(on[0], off[0])
    assert on[1].keys() == off[1].keys()
    for k, g in off[1].items():
        assert torch.equal(on[1][k], g), k


def test_remat_matches_the_references_grad(ref):
    """The port with remat on against ``jax.grad`` through the reference's
    ``_forward(remat=True)``."""
    loss, grads = _loss_and_grads(_model(ref), ref["batch"], True)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL)
    want = dict(_model(ref, ref["grads"]).named_parameters())
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        assert _rel_l2(g, want[k].detach()) < GRAD_RTOL, k


def test_remat_saves_fewer_bytes_for_the_backward(ref):
    model = _model(ref)
    saved = {}
    for remat in (False, True):
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss_fn(ref["batch"], CPU, q_chunk=CHUNK,
                                    kv_chunk=CHUNK, remat=remat)
        loss.backward()
        saved[remat] = n[0]
    assert 0 < saved[True] < saved[False] / 2, saved


def test_train_step_passes_remat_through(ref):
    """``make_train_step(..., remat=True)`` (how the trainer deploys a
    plan's switch): one AdamW step gives the parameters and moments of the
    step without it, bit for bit."""
    out = []
    for remat in (False, True):
        model = _model(ref)
        opt = OptimizerConfig(lr=1e-3)
        state, m = make_train_step(model, opt, CPU, q_chunk=CHUNK,
                                   kv_chunk=CHUNK, remat=remat)(
            train_state(model, opt), ref["batch"])
        out.append((float(m["loss"]), float(m["grad_norm"]), state))
    (l0, n0, s0), (l1, n1, s1) = out
    assert (l0, n0) == (l1, n1)
    for k, p in s0["params"].items():
        assert torch.equal(p, s1["params"][k]), k
        for slot in ("m", "v"):
            assert torch.equal(s0["opt"][slot][k], s1["opt"][slot][k])


def test_the_pipeline_step_refuses_remat():
    """A pipeline plan deploys no memory switch (the tuner's
    ``deployable_switch_mask``); asked for remat, the step says so."""

    class _Mesh:
        shape, device = {"data": 1, "model": 1}, torch.device("cpu")
    model = TransformerLM(get_config("qwen1.5-4b").smoke_model,
                          device=CPU.device, generator=None)
    with pytest.raises(NotImplementedError, match="no memory switch"):
        make_pipeline_train_step(model, OptimizerConfig(),
                                 ShardingCtx("cpu", mesh=_Mesh()),
                                 remat=True)
