"""Start p ranks on this host and run a function on each, over a mesh.

    from repro_torch.launch.spawn import run_ranks
    results = run_ranks(fn, 4, arg, backend="gloo", device="cpu", model=2)

``fn(mesh, *args)`` must be a module-level function (the ranks start with
``torch.multiprocessing``'s ``spawn``, never ``fork``, so they import it
anew). Each rank gets torchrun's variables (``launch.mesh.spawn_env``),
initialises the world from them (``env://``), builds the (data, model) mesh
and runs ``fn``; ``run_ranks`` returns the ranks' return values in rank
order. If any rank raises, the others are terminated and ``run_ranks``
raises: nothing carries on past a failed rank.
"""
from __future__ import annotations

import datetime
import pickle
import queue as queue_mod

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import free_port, init_from_env, make_host_mesh, spawn_env


def _rank_main(rank, world, port, backend, device, model, timeout_s, fn,
               inbox, results):
    if torch.device(device).type == "cpu":
        # ranks on one host's CPU, each at torch's default of a thread per
        # core, stall each other
        torch.set_num_threads(1)
    args = inbox.get()
    spawn_env(rank, world, port)
    init_from_env(backend, timeout=datetime.timedelta(seconds=timeout_s))
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
    values (picklable), in rank order. ``timeout_s`` bounds each collective
    (a rank that waits longer for its peers raises). Ranks on the CPU run
    torch on one thread each."""
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    # the arguments travel by queue: pickled into the start of each process
    # they would hold each start until the rank before had imported its
    # modules and read them
    for _ in range(world):
        inbox.put(args)
    procs = mp.start_processes(
        _rank_main, args=(world, free_port(), backend, device, model,
                          timeout_s, fn, inbox, results),
        nprocs=world, join=False, start_method="spawn")
    got = {}
    # drain while joining: a rank blocks at exit until its result is read
    while True:
        try:
            rank, value = results.get(timeout=0.1)
            got[rank] = pickle.loads(value)
        except queue_mod.Empty:
            pass
        if procs.join(timeout=0):
            break
    while len(got) < world:
        rank, value = results.get(timeout=timeout_s)
        got[rank] = pickle.loads(value)
    return [got[r] for r in range(world)]
