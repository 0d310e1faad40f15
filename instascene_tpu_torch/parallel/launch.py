"""One process per rank: the launch and the collectives of camera-batch data
parallelism.

Counterpart of instascene_tpu/parallel/data_parallel.py:33-41 (`make_mesh`).
The JAX package drives a mesh of devices from one controller; here each
rank is a process of its own with its own host thread (the eager torch
around the kernels moves with the host, so one thread for N cards would
serialise it). `launch` spawns the ranks, joins them through a file store
(no TCP port, so concurrent runs cannot collide), puts rank r on `cuda:r`
or on the CPU, and returns each rank's return value.

Backends are chosen explicitly, never by falling back: NCCL on CUDA, gloo
on the CPU. gloo on CUDA (every rank on cuda:0, `shared_device=True`) is
for a check on a one-card machine, where NCCL refuses two ranks on one
GPU; gloo then reduces the CUDA tensors through the host.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import traceback
from multiprocessing.connection import wait
from typing import Callable, List, Optional

import torch
import torch.distributed as dist


def _rank_device(device: torch.device, rank: int,
                 shared_device: bool) -> torch.device:
    if device.type != "cuda":
        return device
    return torch.device("cuda", 0 if shared_device else rank)


def _check(world: int, device: torch.device, backend: str,
           shared_device: bool) -> None:
    if world < 1:
        raise ValueError(f"--dp {world}: the world needs at least one rank")
    if device.type == "cuda":
        if shared_device and backend != "gloo":
            raise ValueError("ranks sharing one GPU need the gloo backend "
                             "(NCCL refuses two ranks on one device)")
        n = torch.cuda.device_count()
        need = 1 if shared_device else world
        if n < need:
            raise ValueError(
                f"--dp {world}: {n} CUDA device{'s' if n != 1 else ''} "
                f"visible, and each rank needs its own; pass --device cpu "
                f"to run the ranks on the CPU over gloo")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r} on {device}: the CPU ranks "
                         f"run over gloo")


def _run_rank(rank: int, world: int, device: str, backend: str,
              store: str, out_dir: str, fn: Callable, args: tuple) -> None:
    """A spawned rank: join the group, run fn, write its result (or its
    traceback) to out_dir, leave the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, dev, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch(fn: Callable, world: int, *args, device=None,
           backend: Optional[str] = None, shared_device: bool = False,
           store_dir: Optional[str] = None) -> List:
    """Run fn(rank, world, device, *args) in `world` spawned processes and
    return their return values in rank order. fn must be importable at the
    top level of a module and its arguments and result picklable (keep
    tensors off the card in the result).

    device: "cuda" (the default) puts rank r on cuda:r, with NCCL; "cpu"
    runs every rank on the CPU, with gloo. backend="gloo" with
    shared_device=True runs every rank on cuda:0. A world larger than the
    visible CUDA devices raises and names their count. store_dir: the
    directory of the file store and the results (a fresh temporary
    directory inside it, removed after). If a rank fails, the others are
    stopped and a RuntimeError carries the failed rank's traceback."""
    import multiprocessing as mp
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _check(world, dev, backend, shared_device)
    work = tempfile.mkdtemp(prefix="dp_", dir=store_dir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_run_rank, args=(
        r, world, str(_rank_device(dev, r, shared_device)), backend,
        os.path.join(work, "store"), work, fn, args)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        running = list(procs)
        while running:
            wait([p.sentinel for p in running])
            for p in [p for p in running if not p.is_alive()]:
                running.remove(p)
                if p.exitcode != 0:
                    # the others would wait in a collective for it
                    for q in running:
                        q.terminate()
        for r, p in enumerate(procs):
            p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            detail = f"exit codes {[procs[r].exitcode for r in failed]}"
            for r in failed:
                err = os.path.join(work, f"rank{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        detail = f.read()
                    break
            raise RuntimeError(f"data-parallel rank(s) {failed} of {world} "
                               f"failed:\n{detail}")
        results = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            if p.pid is not None:
                p.join()
        shutil.rmtree(work, ignore_errors=True)


# ---- collectives shared by the data-parallel modules


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """The reduction of x over the group's ranks, the same bits on every
    rank (the ring's gather step copies each reduced chunk)."""
    if _via_host(x, group):
        y = x.cpu()
        dist.all_reduce(y, op=op, group=group)
        return y.to(x.device)
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along dim 0, in rank
    order."""
    y = x.cpu() if _via_host(x, group) else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


@contextlib.contextmanager
def rank0_first(group=None):
    """Rank 0 runs the body first (it writes what the body writes once);
    the other ranks run it after, when they find it written."""
    first = dist.get_rank(group) == 0
    if not first:
        dist.barrier(group=group)
    yield first
    if first:             # not reached when the body raised: the launch
        dist.barrier(group=group)     # then stops the waiting ranks
