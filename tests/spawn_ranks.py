"""Start the ranks of a gloo process group on one machine, one process
each, and collect what each returns: torch.multiprocessing.spawn with a
deadline.

    results = run_ranks(fn, world=2, workdir=d, args=(...))

Rank r runs fn(r, world, *args) in a fresh interpreter, with one intra-op
thread, after torch.distributed.init_process_group("gloo",
store=FileStore), the store a file in `workdir` (no network port); its
return value comes back through a file there.  fn must be a module-level
function.  As soon as one rank fails, spawn kills the others (they would
wait on it in a collective) and raises with its traceback; past the
deadline run_ranks kills every rank still running and raises.  Used by
tests/test_torch_sharding.py and chip_smoke.py's phase M2.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, fn, world, workdir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world,
    )
    try:
        result = fn(rank, world, *args)
        # the meshes and filters fn made hold the group: free them while
        # it is still up
        gc.collect()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(workdir, f"result{rank}.pt"))
    # the result is written: leave without the interpreter's teardown, in
    # which a collective backend's threads have aborted the process
    # (std::terminate) after a rank had finished
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(fn, world: int, workdir, args=(), timeout: float = 120.0):
    """fn's result on each rank of a `world`-rank gloo group, in rank
    order."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.spawn(_rank, args=(fn, world, workdir, tuple(args)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{fn.__name__}: ranks still running "
                                   f"after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(workdir, f"result{r}.pt"),
                       weights_only=False) for r in range(world)]
