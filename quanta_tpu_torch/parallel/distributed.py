"""Joining ranks into one ``torch.distributed`` job (port of
``quanta_tpu/parallel/distributed.py:51-99``).

:func:`initialize` wraps ``torch.distributed.init_process_group``: with no
arguments it reads the environment ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), given ``coordinator_address``,
``num_processes`` and ``process_id`` it joins over ``tcp://``. With one
process it does nothing, and a second call returns the world size it
already has.

The backend is a transport choice, made once and logged on one line:
``nccl`` when every rank of this host owns a card of its own, ``gloo``
when ranks share a card (NCCL refuses two ranks on one device) or run on
the CPU. The kernels run on the card either way, and gloo takes the
collectives' CUDA tensors as they are (``sharding.Mesh``).

:func:`spawn_local` starts ranks on this host, joins them through
:func:`initialize` and collects what each returns (the tensor-parallel
checks and tests run through it).
"""

from __future__ import annotations

import os
import queue
import socket
import sys
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the ``torch.distributed`` job (or stay alone). Returns the
    world size.

    With no arguments the ``torchrun`` environment decides; without it, or
    with one process, nothing is joined. Safe to call more than once. A
    rank with a CUDA device takes card ``LOCAL_RANK % device_count``
    (``LOCAL_RANK`` defaults to the process id: every process on this
    host)."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes in (None, 1):
        return 1  # a single process: nothing to join
    if coordinator_address is None or process_id is None:
        raise ValueError(f"initialize: {num_processes} processes need a coordinator address "
                         "and this process's id")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards:
        torch.cuda.set_device(local_rank % n_cards)
    if n_cards and local_world <= n_cards:
        backend, why = "nccl", f"{local_world} local ranks on {n_cards} cards, one each"
    elif n_cards:
        backend, why = "gloo", (f"{local_world} local ranks share {n_cards} card(s): NCCL takes "
                                "one rank a device; the kernels still run on the card")
    else:
        backend, why = "gloo", "no CUDA device: ranks on the CPU"
    print(f"parallel.initialize: rank {process_id} of {num_processes} at tcp://"
          f"{coordinator_address}, backend {backend} ({why})", file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return num_processes


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, results, args):
    try:
        initialize(f"localhost:{port}", world, rank)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn: Callable, nprocs: int, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes on this host,
    joined by :func:`initialize` over a free localhost port; returns what
    each rank returned, by rank. ``fn`` and ``args`` are pickled (``fn``
    by its import path). Raises, with the rank's traceback, when a rank
    fails, and ``TimeoutError`` after ``timeout`` seconds; every process
    it started is stopped before it returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, port, results, args))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_local: {nprocs - len(out)} of {nprocs} ranks did not "
                                   f"finish in {timeout} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in
                        (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_local: rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn_local: rank {rank} failed:\n{res}")
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == nprocs else 0.1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    return [out[r] for r in range(nprocs)]
