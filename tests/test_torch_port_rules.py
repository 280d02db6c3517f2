"""Rules the PyTorch port keeps: it imports neither jax nor the JAX package,
its parameters map one-to-one onto the JAX trees, and its entry points run
on CUDA unless asked for the CPU, with no fallback."""
import ast
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import RESNET50 as J_RESNET50
from repro.models.cnn import RESNET152 as J_RESNET152
from repro.models.cnn import ResNet as JResNet
from repro.nn.module import tree_abstract
from repro_torch.bridge import flatten, load_jax_params
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.build import build_model
from repro_torch.nn.module import ShardingCtx

ROOT = Path(__file__).resolve().parents[1]


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    mods = out.stdout.split()
    assert "repro_torch.kernels.conv2d_gemm.conv2d_gemm" in mods
    assert "repro_torch.launch.train" in mods
    assert not [m for m in mods if _forbidden(m)]


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if _forbidden(m)]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_without_the_repo(where, tmp_path):
    """Without CUDA, or copied out of the repo, the script exits non-zero
    and prints no result line."""
    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("this box has a card")
        script = ROOT / "chip_smoke.py"
    else:
        script = Path(shutil.copy(ROOT / "chip_smoke.py", tmp_path))
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("arch,jcfg,n_params", [
    ("resnet50", J_RESNET50, 25_557_032),
    ("resnet152", J_RESNET152, 60_192_808)])
def test_full_param_trees_map_one_to_one(arch, jcfg, n_params):
    """Every leaf of the full JAX tree has a port parameter of its shape,
    and no port parameter is left over (load_jax_params raises otherwise)."""
    abstract = tree_abstract(JResNet(jcfg).params_spec())
    leaves = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                          abstract)
    model = build_model(get_config(arch), ShardingCtx("cpu"))
    named = dict(model.named_parameters())
    assert {k: tuple(p.shape) for k, p in named.items()} == \
        {k: v.shape for k, v in flatten(leaves).items()}
    load_jax_params(model, leaves)
    assert model.num_params() == n_params
    assert all(float(p.detach().abs().max()) == 0.0 for p in named.values())


def test_bridge_rejects_a_mismatched_tree():
    model = build_model(get_config("resnet50"), ShardingCtx("cpu"), smoke=True)
    tree = {k: np.zeros(p.shape, np.float32)
            for k, p in model.named_parameters()}
    tree["head.w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="wrong shape"):
        load_jax_params(model, tree)
    del tree["head.w"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, tree)


def test_unported_arch_names_the_known_ones():
    with pytest.raises(KeyError, match="resnet152"):
        get_config("qwen3-32b")


def test_train_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "resnet50", "--smoke", "--steps", "1",
                    "--batch", "2"])


def test_train_on_cpu_gives_a_finite_loss():
    out = train.main(["--arch", "resnet50", "--device", "cpu", "--smoke",
                      "--steps", "2", "--batch", "4"])
    assert out["device"] == "cpu"
    assert len(out["losses"]) == 2
    assert all(math.isfinite(v) for v in out["losses"])
