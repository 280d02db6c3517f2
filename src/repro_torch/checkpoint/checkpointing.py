"""Checkpointing: a train state's save and restore with a manifest and an
atomic commit (counterpart of ``repro.checkpoint.checkpointing``).

Layout, the reference's:  <dir>/step_<n>/
    manifest.json   (step, config tag, each leaf's shape and dtype)
    arrays.npz      (the leaves, whole)
    .complete       (the commit marker, written last: readers ignore a
                     step without it, so a crash mid-write never corrupts
                     a restore)

A step is written under ``.tmp_step_<n>`` and committed by a rename.
Retention (``keep``) and the readers (``completed_steps``, ``restore``)
share one ``RLock``, so an async save's collection never removes a step a
reader is loading.

The state is the port's train state (``training.steps.train_state``):
tensors, and the step count, an int. ``save`` copies every leaf to the
host before it returns, as the reference's ``device_get`` does (the
optimizer updates the tensors in place, so an async save must not read
them later); with ``blocking=False`` a thread then writes the files. A
bf16 leaf has no numpy dtype: its 16 bits are stored as uint16 and the
manifest records the torch dtype. Across ranks (``mesh``) a leaf that is
one rank's block (``t.place``, ``t.global_shape``: sharded parameters,
ZeRO-1's optimizer blocks) is gathered whole over the mesh, and only rank
0 copies it to the host and writes, as the reference's ``device_get``
yields whole arrays: the other ranks join each gather and drop the leaf,
so the host holds one copy of the state. A blocking save, and ``wait``,
end at a barrier once the step is committed, so no rank reads the
directory before it is there. ``on(mesh)`` rebinds the store to another
mesh's ranks (the survivors of a lost slice, ``runtime/elastic.py``). ``restore`` reads one whole leaf at a time
and copies into each tensor of the skeleton its block (``t.shard_index``),
in place, so a checkpoint restores onto another mesh or strategy, or onto
one process.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..parallel import collectives as C
from ..parallel.sharded import Sharded


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    elif tree is None:
        return
    else:
        yield prefix, tree


def _unflatten_into(skeleton, leaves: dict, prefix=""):
    # the skeleton's key order, not sorted: a train step sums its gradient
    # norm in the order of the state's parameters
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(skeleton[k], leaves, f"{prefix}/{k}")
                for k in skeleton}
    if isinstance(skeleton, (list, tuple)):
        out = [_unflatten_into(v, leaves, f"{prefix}/{i}")
               for i, v in enumerate(skeleton)]
        return type(skeleton)(out) if isinstance(skeleton, tuple) else out
    if skeleton is None:
        return None
    return leaves[prefix]


def config_hash(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def whole_leaf(v: torch.Tensor, mesh) -> torch.Tensor:
    """A tensor leaf whole: gathered over ``mesh`` where it is one rank's
    block (``v.place``; every rank of the mesh joins the gather), else the
    leaf itself, detached."""
    t = v.detach()                    # (a new tensor: read v's placement)
    place = getattr(v, "place", None)
    if mesh is not None and place is not None and any(place):
        t = Sharded(t, v.global_shape, place, mesh).full()
    return t


def fill_leaf(target: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``target`` overwritten, in place, by its block of the whole leaf
    (``target.shard_index``, else all of it)."""
    target.copy_(whole[getattr(target, "shard_index", ...)])
    return target


def _host(v, mesh, writes: bool) -> tuple[np.ndarray, str] | None:
    """A leaf as a host array (a copy) and the dtype the manifest records:
    whole (gathered over the mesh where it is one rank's block). A rank
    that does not write (``writes`` false) joins the gather and gets None:
    only the writer copies to the host."""
    if not isinstance(v, torch.Tensor):
        a = np.asarray(v)
        return (a, str(a.dtype)) if writes else None
    t = whole_leaf(v, mesh)
    if not writes:
        return None
    t = t.to("cpu", copy=True)
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype
    return t.numpy(), dtype


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _load_leaf(npz, manifest: dict, p: str, target, step: int):
    """Leaf ``p`` of a checkpoint: a tensor target takes its block of the
    whole leaf in place; another leaf comes back as a Python number."""
    key = p.replace("/", "|")
    if key not in npz.files:
        raise KeyError(f"checkpoint step {step} has no leaf {p}")
    a = npz[key]
    if not isinstance(target, torch.Tensor):
        return a.item()
    whole = _tensor(a, manifest["leaves"][p]["dtype"])
    want = tuple(getattr(target, "global_shape", target.shape))
    if tuple(whole.shape) != want or whole.dtype != target.dtype:
        raise ValueError(f"checkpoint leaf {p}: {tuple(whole.shape)} "
                         f"{whole.dtype}, the state's {want} {target.dtype}")
    return fill_leaf(target, whole)


class Checkpointer:
    """``directory``'s checkpoints, the last ``keep`` kept; ``config_tag``
    guards a restore against another model's state; ``mesh`` (the port's
    ``Mesh``): every rank calls ``save`` and ``restore``, rank 0 writes."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 config_tag: str = "", mesh=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.config_tag = config_tag
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._thread: threading.Thread | None = None
        # serialises the directory's mutation (commit, GC) against readers;
        # an RLock because _gc runs inside save's commit, which holds it
        self._lock = threading.RLock()
        # per save: step, blocking, host-copy seconds, write seconds, bytes
        self.saves: list[dict] = []

    def on(self, mesh) -> "Checkpointer":
        """This directory's store (its retention, tag and ``saves``) across
        ``mesh``'s ranks: after a shrink the survivors' barrier and writer
        are the new mesh's. Every rank of the old mesh calls ``wait``
        first; only the new mesh's ranks call this."""
        if self._thread is not None:
            raise RuntimeError("an async save is in flight: wait() on "
                               "every rank of the old mesh first")
        ck = Checkpointer(self.dir, self.keep, self.config_tag, mesh)
        ck.saves = self.saves
        return ck

    # -- write ------------------------------------------------------------
    def save(self, state, step: int, blocking: bool = True) -> Path:
        t0 = time.perf_counter()
        host = {p: _host(v, self.mesh, self._writes())
                for p, v in _flatten(state)}
        record = {"step": int(step), "blocking": blocking,
                  "copy_s": time.perf_counter() - t0}
        self.saves.append(record)
        path = self.dir / f"step_{step:08d}"

        def write():
            t1 = time.perf_counter()
            manifest = {
                "step": int(step),
                "config_tag": self.config_tag,
                "leaves": {p: {"shape": list(a.shape), "dtype": dtype}
                           for p, (a, dtype) in host.items()},
            }
            tmp = self.dir / f".tmp_step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz",
                     **{p.replace("/", "|"): a for p, (a, _) in host.items()})
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            (tmp / ".complete").write_text("ok")
            record["bytes"] = sum(f.stat().st_size for f in tmp.iterdir())
            with self._lock:
                if path.exists():
                    shutil.rmtree(path)
                tmp.rename(path)
                self._gc()
            record["write_s"] = time.perf_counter() - t1

        if blocking:
            if self._writes():
                write()
            self._sync()
        else:
            self.wait()
            if self._writes():
                self._thread = threading.Thread(target=write, daemon=True)
                self._thread.start()
        return path

    def wait(self):
        """Until the last save is on disk (across ranks: on every rank,
        once rank 0 has written it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._sync()

    def _writes(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _sync(self):
        """Across ranks, a barrier: no rank reads the directory before rank
        0's write is committed."""
        if self.mesh is not None:
            C.all_reduce_max(torch.zeros(1, device=self.mesh.host_device),
                             self.mesh.group(tuple(self.mesh.shape)))

    def _gc(self):
        with self._lock:
            steps = sorted(self.completed_steps())
            for s in steps[:-self.keep]:
                shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- read -------------------------------------------------------------
    def completed_steps(self) -> list[int]:
        with self._lock:
            out = []
            for p in self.dir.glob("step_*"):
                if (p / ".complete").exists():
                    out.append(int(p.name.split("_")[1]))
            return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.completed_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, skeleton, step: int | None = None):
        """The checkpoint of ``step`` (default: the latest) into the
        structure of ``skeleton``: each tensor leaf takes its block of the
        whole leaf in place (its ``shard_index``, else all of it); other
        leaves (the step count) come back as Python numbers. Returns
        (tree, step)."""
        # the lock pins the step until its leaves are read: a concurrent
        # async save's GC cannot remove it mid-read
        with self._lock:
            step = step if step is not None else self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no complete checkpoint in {self.dir}")
            path = self.dir / f"step_{step:08d}"
            manifest = json.loads((path / "manifest.json").read_text())
            if self.config_tag and manifest["config_tag"] and \
                    manifest["config_tag"] != self.config_tag:
                raise ValueError(
                    f"checkpoint config_tag {manifest['config_tag']} != "
                    f"{self.config_tag}: refusing to restore a mismatched "
                    f"model")
            with np.load(path / "arrays.npz") as npz:
                leaves = {p: _load_leaf(npz, manifest, p, target, step)
                          for p, target in _flatten(skeleton)}
        return _unflatten_into(skeleton, leaves), step
