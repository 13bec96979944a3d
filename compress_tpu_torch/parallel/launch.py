"""Start the ranks of one host: ``run_ranks(fn, size, backend, device,
*args)`` spawns ``size`` processes, joins them in a process group through
a ``file://`` rendezvous in a fresh temporary directory, calls
``fn(mesh, *args)`` on each (``mesh = engine.block_mesh(device=device)``)
and returns each rank's result, in rank order.

A spawned process imports the module of ``fn`` (and of everything in
``args``) to unpickle it, so those live in modules that import no more
than the process needs, such as this package.  ``run_calls`` runs a list
of calls in one group, so one start serves several cases."""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from compress_tpu_torch.parallel.engine import block_mesh


def _rank_main(rank, fn, size, backend, device, root, timeout, args):
    # what block_mesh reads to place a rank, as torchrun sets it
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    if backend == "gloo":     # the ranks share this host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    dist.init_process_group(
        backend, init_method=f"file://{root}/rendezvous", world_size=size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(block_mesh(device=device), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(root, f"rank{rank}.tmp"),
               os.path.join(root, f"rank{rank}.pkl"))


def run_ranks(fn, size: int, backend: str = "gloo", device=None, *args,
              timeout: float = 600.0) -> list:
    """``fn(mesh, *args)`` on ``size`` spawned ranks over ``backend``;
    returns their results in rank order.  ``device`` as for
    ``block_mesh`` ("cpu", "cuda:0" for every rank on one card, None for
    ``cuda:{rank}``).  A rank that raises, or a run longer than
    ``timeout`` seconds (also each collective's limit), raises here, and
    every rank still running is killed."""
    with tempfile.TemporaryDirectory(prefix="ct_ranks_") as root:
        ctx = mp.start_processes(
            _rank_main, args=(fn, size, backend, device, root, timeout, args),
            nprocs=size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {size} ranks still "
                                       f"running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(size):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def run_calls(mesh, calls) -> list:
    """Each of ``calls`` is (fn, args, kwargs): ``fn(*args, mesh=mesh,
    **kwargs)`` on this rank, in order.  Returns a (result, stats) pair a
    call: ``stats`` is the dict the call was given as ``stats=``, as the
    call left it (None when it was given none)."""
    out = []
    for fn, args, kwargs in calls:
        out.append((fn(*args, mesh=mesh, **kwargs), kwargs.get("stats")))
    return out
