"""Start a function on N ranks of a torch.distributed group and collect
their results.

The JAX package runs one SPMD program over the devices of one or more
processes (``jax.distributed.initialize``); the port runs one process a
rank.  :func:`run_ranks` spawns them (the spawn start method), lets them
meet through a ``FileStore`` in a temporary directory (no TCP port, so
concurrent runs never collide), initialises the group with an explicit
timeout, and calls ``fn(device, *args)`` on every rank with that rank's
device: ``cuda:{rank % device_count}`` for CUDA ranks, the CPU for CPU
ranks (one intra-op thread each, so that several rank sets can share a
machine's cores).

Backends: NCCL puts one rank on each card; gloo takes CPU ranks, or CUDA
ranks sharing cards where there are more ranks than cards.  NCCL with more
ranks than cards raises a ValueError that names gloo: nothing switches
backend by itself.

A rank that raises makes :func:`run_ranks` raise with its traceback, and
the other ranks (which may wait in a collective for it) are killed; ranks
still running after ``timeout`` seconds are killed and it raises
TimeoutError.  So a broken collective fails the caller instead of hanging
it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..utils.device import entry_device

__all__ = ["run_ranks"]

# seconds a rank that exited is given to deliver its message before it
# counts as lost
_GRACE_S = 5.0


def _rank_main(call_path: str, rank: int, world_size: int, backend: str,
               device_type: str, store_path: str, timeout: float,
               results) -> None:
    """One rank: load (fn, args), set the device, join the group, run
    ``fn``, report."""
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)     # written by run_ranks, below
        if device_type == "cuda":
            index = rank % torch.cuda.device_count()
            torch.cuda.set_device(index)
            torch.cuda.init()
            device = torch.device("cuda", index)
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, fn(device, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def _failures(results, rank: int, text: str, world_size: int) -> str:
    """The first failure's traceback and those that arrive within a second
    after it: one rank's error often makes its peers' collectives fail
    too, and the first to arrive need not be the cause."""
    out = [(rank, text)]
    end = time.monotonic() + 1.0
    while (left := end - time.monotonic()) > 0:
        try:
            rank, ok, value = results.get(timeout=left)
        except queue_mod.Empty:
            break
        if not ok:
            out.append((rank, value))
    return "\n".join(f"rank {r} of {world_size} failed:\n{t}"
                     for r, t in sorted(out))


def _check(world_size: int, backend: str, device: torch.device) -> None:
    if world_size < 1:
        raise ValueError(f"world_size {world_size} < 1")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl runs CUDA ranks: CPU ranks take "
                             "backend='gloo'")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"nccl takes one rank a card: {world_size} ranks, {cards} "
                "card(s); backend='gloo' lets ranks share a card")


def run_ranks(fn, world_size: int, backend: str,
              device: str | torch.device, args: tuple = (),
              timeout: float = 600.0) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` ranks; returns their
    results in rank order.

    ``fn`` and ``args`` are pickled (a function of an importable module)
    into a file that every rank reads once it has started: passed as the
    process's arguments, they would be read by each rank in turn, after
    its imports, and the ranks would start one after the other.  Each
    result is pickled back, so return host objects (numpy arrays, rows),
    not tensors.  On CUDA the kernels are built here first, so that the
    ranks load one build.
    """
    device = torch.device(device)
    _check(world_size, backend, device)
    if device.type == "cuda":
        from ..utils.build import kernel_library

        entry_device(device)
        kernel_library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="ft8_ranks_") as tmp:
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(call_path, rank, world_size, backend, device.type,
                  os.path.join(tmp, "store"), timeout, results))
            for rank in range(world_size)]
        try:
            for proc in procs:
                proc.start()
            deadline = time.monotonic() + timeout
            lost_since: dict[int, float] = {}
            while len(got) < world_size:
                now = time.monotonic()
                if now > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(got))} "
                        f"still running after {timeout:g} s: killed")
                try:
                    rank, ok, value = results.get(timeout=min(
                        1.0, deadline - now))
                except queue_mod.Empty:
                    for rank, proc in enumerate(procs):
                        if rank in got or proc.exitcode is None:
                            continue
                        first = lost_since.setdefault(rank, now)
                        if now - first > _GRACE_S:
                            raise RuntimeError(
                                f"rank {rank} exited with code "
                                f"{proc.exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, rank, value,
                                                 world_size))
                got[rank] = value
            for proc in procs:
                proc.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=10.0)
            results.close()
    return [got[rank] for rank in range(world_size)]
