"""Builds the CUDA kernels from ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries go into
``kernels/_build/`` (git-ignored), named by a hash of the source, the
``csrc/`` headers it includes (``#include "x.cuh"``, followed through
headers) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once, and waits.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found on PATH or in {home}/bin: the "
                           f"CUDA kernels cannot be built")
    return str(nvcc)


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every file it includes with quotes, transitively."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for inc in _INCLUDE.findall(text):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in _sources(CSRC / f"{name}.cu", {}).items():
        digest.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every source not built yet, in parallel. Returns, per kernel
    library, ``"cached"`` or ptxas's report of spills, registers and shared
    memory, and its warnings that it serialized wgmma instructions.
    Raises with nvcc's output when a compile fails."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, jobs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)       # atomic: a concurrent build sees all or none
        report[name] = " ".join(line.split(":", 1)[-1].strip()
                                for line in log.splitlines()
                                if "Used" in line or "spill" in line
                                or "wgmma" in line)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
