"""Start p ranks on this host and run a function on each, over a mesh.

    from repro_torch.launch.spawn import run_ranks
    results = run_ranks(fn, 4, arg, backend="gloo", device="cpu", model=2)

``fn(mesh, *args)`` must be a module-level function (the ranks start with
``torch.multiprocessing``'s ``spawn``, never ``fork``, so they import it
anew). Each rank gets torchrun's rank variables (``launch.mesh.spawn_env``),
initialises the world through a file store in a directory of its own (no
port is picked and released first: a port freed by one spawn could be
taken by another before its store binds it), builds the (data, model) mesh
and runs ``fn``; ``run_ranks`` returns the ranks' return values in rank
order. If any rank raises, the others are terminated and ``run_ranks``
raises; if the ranks are still running after ``timeout_s``, they are
terminated and it raises ``TimeoutError``: nothing carries on past a
failed or stalled rank.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import BACKENDS, make_host_mesh, spawn_env


def _rank_main(rank, world, store, backend, device, model, timeout_s, fn,
               inbox, results):
    if torch.device(device).type == "cpu":
        # ranks on one host's CPU, each at torch's default of a thread per
        # core, stall each other
        torch.set_num_threads(1)
    args = inbox.get()
    spawn_env(rank, world)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_host_mesh(world, model, backend=backend, device=device)
        # by value: a tensor handed over through shared memory would need
        # this rank alive until the parent reads it
        results.put((rank, pickle.dumps(fn(mesh, *args))))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str, device: str,
              model: int | None = None, timeout_s: float = 600.0) -> list:
    """Runs ``fn(mesh, *args)`` on ``world`` spawned ranks; their return
    values (picklable), in rank order. ``timeout_s`` bounds the whole run
    and each collective (a rank that waits longer for its peers raises).
    Ranks on the CPU run torch on one thread each."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port takes {BACKENDS}")
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    # the arguments travel by queue: pickled into the start of each process
    # they would hold each start until the rank before had imported its
    # modules and read them
    for _ in range(world):
        inbox.put(args)
    deadline = time.monotonic() + timeout_s
    home = tempfile.mkdtemp(prefix="run_ranks_")
    try:
        procs = mp.start_processes(
            _rank_main, args=(world, os.path.join(home, "store"), backend,
                              device, model, timeout_s, fn, inbox, results),
            nprocs=world, join=False, start_method="spawn")
        got = {}
        # drain while joining: a rank blocks at exit until its result is
        # read
        while True:
            try:
                rank, value = results.get(timeout=0.1)
                got[rank] = pickle.loads(value)
            except queue_mod.Empty:
                pass
            if procs.join(timeout=0):
                break
            if time.monotonic() > deadline:
                for p in procs.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} still "
                    f"running after {timeout_s} s; ranks "
                    f"{sorted(set(range(world)) - set(got))} had not "
                    f"returned")
        while len(got) < world:
            rank, value = results.get(
                timeout=max(deadline - time.monotonic(), 1.0))
            got[rank] = pickle.loads(value)
        return [got[r] for r in range(world)]
    finally:
        shutil.rmtree(home, ignore_errors=True)
