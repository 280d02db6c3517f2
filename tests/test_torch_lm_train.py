"""The port's LM training against the JAX package's, at the smoke widths
(Qwen1.5-4B: 2 layers, d 64; Mamba-2 780m: 4 layers, d 64, chunk 16), on
fp32 copies of the smoke configs unless a test says otherwise: the same
``tree_init`` parameters and optimizer state (carried over by
repro_torch.bridge) and the same token batches go through ``loss_fn`` and
one AdamW ``make_train_step`` of each package.

Bars: the loss and its ``ce`` within 1e-6 relative (fp32; the two packages'
exp, log and sums round differently in the last bit: ~1e-7 is seen); the
first AdamW moment m = 0.1·g within 1e-5 in relative L2 per tensor, the
second, v = 0.05·g², within 2e-5, twice g's bar as it is quadratic in g
(the gradients' last-bit differences: ~1.2e-6 is typical; Mamba's dt_bias,
a sum over every token of products through exp and softplus, reads ~6e-6).
The updated parameters elementwise within 1e-5 of their size plus 0.05·lr:
the first update is lr·g/(|g| + eps), which ignores g's size wherever
|g| ≫ eps = 1e-8, but turns a gradient difference Δg into lr·Δg/eps
where |g| ≈ eps. The key biases sit there: their gradient cancels in the
softmax but for RoPE, ~1e-8 here, and the packages' 4e-10 apart there moves
the update by 7.5e-3·lr; 0.05·lr allows Δg up to 5e-10. The published bf16
config at the bf16 bar of
tests/test_torch_qwen.py (0.1 absolute plus 5 % relative; both packages
round every matmul to bf16, and a one-ulp flip moves a value by 2^-8).
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
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.training.steps import make_train_step as j_make_train_step
from repro.training.steps import train_state_spec
from repro_torch.bridge import load_jax_state
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenSource, make_source
from repro_torch.launch import train
from repro_torch.launch.build import build_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.schedules import make_pipeline_train_step
from repro_torch.training.steps import make_train_step, train_state

B, S, CHUNK = 4, 32, 8
LR = 1e-3
CPU = ShardingCtx("cpu")
LOSS_RTOL, STATE_RTOL = 1e-6, 1e-5
MOMENT_RTOL = {"m": STATE_RTOL, "v": 2 * STATE_RTOL}
BF16_TOL = dict(rtol=5e-2, atol=0.1)
ARCHS = ("qwen1.5-4b", "mamba2-780m")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _in_fp32(cfg, f32):
    """The config with every dtype field in ``f32``."""
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=f32)
           for k in ("attn", "ffn", "ssm") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=f32, **sub)


def _configs(arch, dtype="float32"):
    jcfg = j_get_config(arch).smoke_model
    tcfg = get_config(arch).smoke_model
    if dtype == "float32":
        jcfg, tcfg = _in_fp32(jcfg, jnp.float32), _in_fp32(tcfg, torch.float32)
    return jcfg, tcfg


def _batches(vocab, n=2):
    src = JTokenSource(JDataConfig("lm", B, seq_len=S, vocab=vocab, seed=0))
    return [src.batch_at(s) for s in range(n)]


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _reference_step(jm, state, batch, accum):
    step = jax.jit(j_make_train_step(jm, JOpt(lr=LR), NULL_CTX, accum=accum,
                                     q_chunk=CHUNK, kv_chunk=CHUNK))
    new, m = step(state, batch)
    return jax.tree.map(np.asarray, new), {k: float(v) for k, v in m.items()}


def _jax_state(jm):
    return jax.jit(lambda k: tree_init(train_state_spec(jm, JOpt(lr=LR)),
                                       k))(jax.random.PRNGKey(0))


def _port_state(tcfg, state_np):
    """A port model and its AdamW train state, filled from a JAX state."""
    model = TransformerLM(tcfg, device=CPU.device, generator=None)
    state = train_state(model, OptimizerConfig(lr=LR))
    load_jax_state(state, state_np)
    return model, state


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """fp32 JAX model, its train state from tree_init, two token batches,
    and the reference's AdamW steps at accum 1 and 2 from that state."""
    jcfg, tcfg = _configs(request.param)
    jm = JLM(jcfg)
    state = _jax_state(jm)
    batches = _batches(jcfg.vocab)
    steps = {a: _reference_step(jm, state, batches[0], a) for a in (1, 2)}
    return dict(jm=jm, tcfg=tcfg, state=jax.tree.map(np.asarray, state),
                batches=batches, steps=steps)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    d = torch.linalg.vector_norm((got.double() - want.double()).flatten())
    return float(d / torch.linalg.vector_norm(want.double().flatten())
                 .clamp(min=1e-30))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_loss_fn_matches_jax(reference, masked):
    """Loss and ce against the reference's, with the default targets and
    mask, and with given ones (a random mask, targets from another batch)."""
    ref = reference
    batch = dict(ref["batches"][0])
    if masked:
        rng = np.random.default_rng(1)
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
        batch["targets"] = ref["batches"][1]["tokens"]
    params = jax.tree.map(jnp.asarray, ref["state"]["params"])
    loss_j, m_j = jax.jit(lambda p, b: ref["jm"].loss_fn(
        p, b, NULL_CTX, q_chunk=CHUNK, kv_chunk=CHUNK))(params, batch)
    model, _ = _port_state(ref["tcfg"], ref["state"])
    with torch.no_grad():
        loss, m = model.loss_fn(_torch(batch), CPU, q_chunk=CHUNK,
                                kv_chunk=CHUNK)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["ce"]), float(m_j["ce"]),
                               rtol=LOSS_RTOL)
    assert float(m["aux"]) == float(m_j["aux"]) == 0.0


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_step_matches_jax(reference, accum):
    """One AdamW step from the same carried-over state (accum 2: two
    microbatches of 2, as the reference's scan splits them): the loss, the
    gradient norm, every updated parameter and both moments."""
    ref = reference
    new_j, m_j = ref["steps"][accum]
    model, state = _port_state(ref["tcfg"], ref["state"])
    step = make_train_step(model, OptimizerConfig(lr=LR), CPU, accum=accum,
                           q_chunk=CHUNK, kv_chunk=CHUNK)
    state, m = step(state, _torch(ref["batches"][0]))
    assert state["step"] == 1
    np.testing.assert_allclose(float(m["loss"]), m_j["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), m_j["grad_norm"],
                               rtol=STATE_RTOL)
    _, want = _port_state(ref["tcfg"], new_j)      # the reference's, unstacked
    assert want["step"] == 1
    for k, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want["params"][k].detach().numpy(),
                                   rtol=STATE_RTOL, atol=0.05 * LR,
                                   err_msg=k)
        for slot in ("m", "v"):
            assert _rel_l2(state["opt"][slot][k], want["opt"][slot][k]) \
                < MOMENT_RTOL[slot], (slot, k)


def test_bf16_step_matches_jax():
    """The published bf16 smoke Qwen: one AdamW step, loss and updated
    parameters at the bf16 bar."""
    jcfg, tcfg = _configs("qwen1.5-4b", "bfloat16")
    jm = JLM(jcfg)
    state = _jax_state(jm)
    batch = _batches(jcfg.vocab, 1)[0]
    new_j, m_j = _reference_step(jm, state, batch, 1)
    model, tstate = _port_state(tcfg, jax.tree.map(np.asarray, state))
    assert model.head.dtype == torch.bfloat16
    tstate, m = make_train_step(model, OptimizerConfig(lr=LR), CPU,
                                q_chunk=CHUNK, kv_chunk=CHUNK)(tstate,
                                                               _torch(batch))
    np.testing.assert_allclose(float(m["loss"]), m_j["loss"], **BF16_TOL)
    _, want = _port_state(tcfg, new_j)
    for k, p in tstate["params"].items():
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   want["params"][k].detach().float().numpy(),
                                   err_msg=k, **BF16_TOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_token_source_bit_for_bit(seed):
    """The same int32 tokens as the reference's bigram stream, 3 steps."""
    kw = dict(seq_len=17, vocab=97, seed=seed)
    ours = make_source(DataConfig("lm", 3, **kw))
    theirs = JTokenSource(JDataConfig("lm", 3, **kw))
    assert isinstance(ours, TokenSource)
    for step in range(3):
        a, b = ours.batch_at(step)["tokens"], theirs.batch_at(step)["tokens"]
        assert a.dtype == b.dtype == np.int32 and a.shape == (3, 17)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_runs_an_lm_on_the_cpu(arch):
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--seq", "32", "--steps", "2", "--batch", "2"])
    assert out["device"] == "cpu" and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))


def test_lm_refusals_name_their_items(monkeypatch):
    """An SSM LM's prompt pass or decode step across ranks names item 6
    (its cache across ranks; an attention LM's runs there, under the
    serving layouts: tests/test_torch_serve_parallel.py), an MTP model
    item 10; an LM pipeline without a mesh to stage it on raises; the
    trainer without CUDA raises."""
    cfg = get_config("qwen1.5-4b")

    class _Mesh:
        size, device = 4, torch.device("cpu")
    lm = build_model(cfg, CPU, smoke=True)
    ssm = build_model(get_config("mamba2-780m"), CPU, smoke=True)
    across = ShardingCtx("cpu", mesh=_Mesh())
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        ssm.prefill(tokens, None, across)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        ssm.decode_step(tokens[:, :1], None, 8, across)
    with pytest.raises(ValueError, match="a mesh with a 'model' axis"):
        make_pipeline_train_step(lm, OptimizerConfig(), CPU)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        TransformerLM(dataclasses.replace(cfg.smoke_model, mtp_heads=1),
                      device=torch.device("meta"), generator=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "1"])
