"""The port's ``checkpoint.Checkpointer`` and the trainer's
``--ckpt-dir``/``--ckpt-every``, on the CPU.

The directory layout is the reference's: its ``Checkpointer`` lists the
port's completed steps the same way, a torn step (no ``.complete``) is
skipped by both, ``keep`` collects the oldest, and a ``config_tag``
mismatch refuses to restore. An async save holds the state as it was when
``save`` returned, whatever the optimizer does to the tensors after; bf16
leaves round-trip bit for bit. The trainer resumed from a checkpoint gives
the straight run's losses bit for bit (the smoke ResNet-50 at batch 2 and
the smoke Qwen1.5-4B), and says "no new steps" when the checkpoint is
already at ``--steps``. On 4 gloo ranks under df_zero1 ((2, 2): the
parameters split on "model", the AdamW moments also on "data"), the
trainer resumed across the ranks gives the straight run's losses bit for
bit, a restore onto the same mesh gives every rank its blocks back bit for
bit, and a restore into one process gives the whole state the ranks
hold."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer, config_hash
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.build import build_model
from repro_torch.launch.spawn import run_ranks
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.sharded import Sharded
from repro_torch.parallel.strategies import make_rules
from repro_torch.training.steps import train_state

# One torch thread a test process. The suite runs 6 xdist workers on 8
# cores, and every worker imports this file when it collects: at torch's
# default of a thread per core the workers stall each other and the JAX
# package's multi-device subprocesses (a spawned rank sets the same,
# launch/spawn.py).
torch.set_num_threads(1)

QWEN = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu", "--batch",
        "8", "--seq", "32"]
RESNET = ["--arch", "resnet50", "--smoke", "--device", "cpu", "--batch",
          "2"]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "h": torch.randn(5, generator=g).to(torch.bfloat16)},
            "opt": {"m": {"w": torch.randn(4, 3, generator=g),
                          "h": torch.zeros(5)}},
            "step": 7}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_the_reference_reads_the_ports_directory(tmp_path):
    from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
    ck = Checkpointer(tmp_path, keep=10, config_tag="t")
    for s in (2, 4, 6):
        ck.save(_state(), s)
    torn = tmp_path / "step_00000008"        # a write cut before its commit
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    ref = JCheckpointer(tmp_path, keep=10)
    assert ck.completed_steps() == ref.completed_steps() == [2, 4, 6]
    assert ck.latest_step() == ref.latest_step() == 6
    manifest = json.loads((tmp_path / "step_00000006" /
                           "manifest.json").read_text())
    assert manifest["step"] == 6 and manifest["config_tag"] == "t"
    assert manifest["leaves"]["/params/h"] == {"shape": [5],
                                               "dtype": "bfloat16"}
    assert sorted(os.listdir(tmp_path / "step_00000006")) == [
        ".complete", "arrays.npz", "manifest.json"]
    state, step = ck.restore(_state(1))
    assert step == 6 and _equal(state, _state())


def test_keep_collects_the_oldest_and_the_tag_guards_restore(tmp_path):
    ck = Checkpointer(tmp_path, keep=3, config_tag=config_hash(("a", True)))
    for s in range(1, 7):
        ck.save(_state(), s, blocking=s % 2 == 0)
    ck.wait()
    assert ck.completed_steps() == [4, 5, 6]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005", "step_00000006"]
    other = Checkpointer(tmp_path, config_tag=config_hash(("b", True)))
    with pytest.raises(ValueError, match="config_tag"):
        other.restore(_state())
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(_state())


def test_an_async_save_keeps_the_state_of_its_call(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state()
    want = {k: v.clone() for k, v in state["params"].items()}
    ck.save(state, 1, blocking=False)
    with torch.no_grad():                    # the optimizer, in place
        for t in state["params"].values():
            t.add_(1.0)
    ck.wait()
    got, _ = ck.restore(_state(3), step=1)
    assert _equal(got["params"], want)
    assert ck.saves[0]["blocking"] is False and ck.saves[0]["bytes"] > 0


def test_bf16_round_trips_bit_for_bit(tmp_path):
    x = torch.randn(64, 33).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("inf"), -0.0, 1e-40, float("nan")])
    ck = Checkpointer(tmp_path)
    ck.save({"x": x}, 1)
    y = torch.empty_like(x)
    ck.restore({"x": y})
    assert torch.equal(x.view(torch.int16), y.view(torch.int16))


@pytest.mark.parametrize("argv", [RESNET, QWEN], ids=["resnet50", "qwen"])
def test_the_trainer_resumes_bit_for_bit(tmp_path, argv, capsys):
    straight = train.main(argv + ["--steps", "3"])["losses"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    first = train.main(argv + ["--steps", "2"] + ckpt)
    assert first["losses"] == straight[:2]
    # every step saved async; the last one is not saved again at the end
    assert [(s["step"], s["blocking"]) for s in first["ckpt_saves"]] == \
        [(1, False), (2, False)]
    rest = train.main(argv + ["--steps", "3"] + ckpt)
    assert rest["start_step"] == 2 and rest["losses"] == straight[2:]
    assert "resumed from step 2" in capsys.readouterr().out
    again = train.main(argv + ["--steps", "3"] + ckpt)
    assert again["start_step"] == 3 and again["losses"] == []
    assert again["ckpt_saves"] == []
    assert "no new steps" in capsys.readouterr().out


def _whole(t, mesh):
    place = getattr(t, "place", None)
    if place is None or not any(place):
        return t.detach().clone()
    return Sharded(t.detach(), t.global_shape, place, mesh).full().clone()


def _ranks(mesh, ckpt_dir):
    """One rank of the df_zero1 runs: the trainer straight and resumed,
    then a state saved, restored onto this mesh, and gathered whole."""
    out = {"straight": train.main(QWEN + ["--steps", "4", "--strategy",
                                          "df_zero1"])["losses"]}
    ckpt = ["--ckpt-dir", f"{ckpt_dir}/trainer", "--strategy", "df_zero1"]
    out["first"] = train.main(QWEN + ["--steps", "2"] + ckpt)["losses"]
    out["rest"] = train.main(QWEN + ["--steps", "4"] + ckpt)["losses"]
    cfg = get_config("qwen1.5-4b")
    ctx = ShardingCtx("cpu", mesh=mesh, rules=make_rules("df_zero1"))
    opt = OptimizerConfig(zero1=True)
    model = build_model(cfg, ctx, smoke=True, seed=0)
    state = train_state(model, opt, ctx)
    with torch.no_grad():                # distinct values in every slot
        for i, slot in enumerate(state["opt"].values()):
            for t in slot.values():
                t.normal_(generator=torch.Generator().manual_seed(i))
    state["step"] = 3
    mine = {k: {n: t.clone() for n, t in v.items()}
            for k, v in (("params", state["params"]),
                         *state["opt"].items())}
    ck = Checkpointer(f"{ckpt_dir}/state", mesh=mesh)
    ck.save(state, 3)
    fresh = train_state(build_model(cfg, ctx, smoke=True, seed=1), opt, ctx)
    fresh, step = ck.restore(fresh)
    back = {k: {n: t for n, t in v.items()}
            for k, v in (("params", fresh["params"]), *fresh["opt"].items())}
    out["same_mesh"] = step == 3 and fresh["step"] == 3 and all(
        torch.equal(back[k][n], mine[k][n]) for k in mine for n in mine[k])
    out["split"] = any("data" in axes for t in state["opt"]["m"].values()
                       for axes in getattr(t, "place", ()))
    whole = {k: {n: _whole(t, mesh) for n, t in v.items()}
             for k, v in (("params", state["params"]),
                          *state["opt"].items())}
    out["whole"] = whole if mesh.rank == 0 else None
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    return tmp, run_ranks(_ranks, 4, str(tmp), backend="gloo", device="cpu",
                          model=2, timeout_s=180)


def test_the_trainer_resumes_bit_for_bit_on_4_ranks(ranks):
    _, res = ranks
    for out in res:
        assert len(out["straight"]) == 4
        assert out["first"] == out["straight"][:2]
        assert out["rest"] == out["straight"][2:]


def test_zero1_state_restores_on_the_mesh_and_in_one_process(ranks):
    tmp, res = ranks
    assert all(out["same_mesh"] for out in res)
    assert res[0]["split"]                 # ZeRO-1's moments are blocks
    whole = res[0]["whole"]
    model = build_model(get_config("qwen1.5-4b"), ShardingCtx("cpu"),
                        smoke=True, seed=1)
    state = train_state(model, OptimizerConfig(zero1=True))
    state, step = Checkpointer(tmp / "state").restore(state)
    assert step == 3 and state["step"] == 3
    got = {"params": state["params"], **state["opt"]}
    for k in whole:
        for n, t in whole[k].items():
            assert torch.equal(got[k][n], t), (k, n)
    np.testing.assert_array_equal(sorted(whole), ["m", "params", "v"])
