"""Multi-process initialization: the counterpart of
`multimodal_rare_disease_tpu/parallel/distributed.py`.

A rank is one process with one `torch.device`. `maybe_initialize` sets up
the default process group from explicit arguments or from torchrun's
environment (`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`, `RANK`); a
single process is a no-op, so every entry point can call it. The backend
is always named by the caller: `nccl` for ranks on cards of their own,
`gloo` for CPU tensors or for ranks that share one card (NCCL refuses two
ranks on one device, and that refusal is not caught). The process group
waits at most `timeout` seconds in any collective.

`run_ranks` spawns a whole world on this host (torch.multiprocessing,
`spawn`), each rank with its process group, and returns what each rank's
function returned; a failure, or a rank that does not finish in time,
kills every rank and raises.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0
# how long a failed world waits for the other ranks' reports
REPORT_GRACE_S = 5.0


def maybe_initialize(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialize the default process group when running multi-process.

    Explicit arguments win; otherwise torchrun's environment
    (`MASTER_ADDR` / `MASTER_PORT` → `env://`, `WORLD_SIZE`, `RANK`).
    Without an init method and with a world of one it does nothing and
    returns False; an explicit init method with a world of one makes a
    real group of one. `backend` ('nccl' or 'gloo') must be given
    whenever a group is made. True when the group is up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR"):
        init_method = "env://"
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and world_size in (None, 1):
        return False  # single process
    if backend not in BACKENDS:
        raise ValueError(
            f"backend={backend!r}: name it, 'nccl' for ranks on cards of "
            f"their own or 'gloo' for CPU tensors and ranks that share a "
            f"card")
    if world_size is None or rank is None:
        raise ValueError("a process group needs its world size and rank")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed initialized: rank %d/%d over %s", rank,
             world_size, backend)
    return True


def is_primary() -> bool:
    """True on the process that writes checkpoints and artifacts."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def file_init_method(directory: Optional[str] = None) -> str:
    """A `file://` rendezvous in a fresh file under `directory` (a new
    temporary directory by default): one host, no port to race for."""
    d = directory or tempfile.mkdtemp(prefix="mrd_dist_")
    return "file://" + os.path.join(os.path.abspath(d),
                                    f"store_{os.getpid()}_{time.time_ns()}")


def _rank_main(fn, rank_: int, world: int, init_method: str, backend: str,
               timeout_s: float, args: Sequence[Any], results) -> None:
    try:
        maybe_initialize(init_method, world, rank_, backend, timeout_s)
        report = (rank_, True, fn(rank_, world, *args))
    except BaseException:  # noqa: BLE001 — reported to the parent
        report = (rank_, False, traceback.format_exc())
    finally:
        shutdown()
    if results is not None:
        # by value: a tensor sent through a torch queue lives in this
        # process's shared memory, which ends with it
        results.put(pickle.dumps(report))
    elif not report[1]:
        log.error("rank %d failed:\n%s", rank_, report[2])
        raise SystemExit(1)


def spawn_rank(fn: Callable, rank_: int, world: int, init_method: str,
               backend: str, args: Sequence[Any] = (), results=None,
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """Start one rank of a world in a spawned process; it puts
    (rank, ok, result or traceback) on `results` when it ends (without
    `results`, a failure is logged and exits 1)."""
    ctx = torch.multiprocessing.get_context("spawn")
    p = ctx.Process(target=_rank_main, args=(
        fn, rank_, world, init_method, backend, timeout_s, tuple(args),
        results), daemon=False)
    p.start()
    return p


def stop(procs, grace_s: float = 10.0) -> None:
    """Join every process for up to `grace_s` seconds, then kill the
    rest."""
    deadline = time.monotonic() + grace_s
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=5)


def run_ranks(fn: Callable, world: int, *, backend: str,
              args: Sequence[Any] = (), timeout_s: float = 300.0,
              init_dir: Optional[str] = None) -> List[Any]:
    """fn(rank, world, *args) on `world` spawned ranks of one process
    group (`backend`, rendezvous in a file under `init_dir`); → each
    rank's return value, by rank. `fn` must be importable (a module-level
    function). A rank that raises, or a world that has not finished
    after `timeout_s` seconds, kills every rank and raises RuntimeError
    with the tracebacks of every rank that reported a failure."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = file_init_method(init_dir)
    procs = [spawn_rank(fn, r, world, init, backend, args, results,
                        timeout_s=timeout_s)
             for r in range(world)]
    out: List[Any] = [None] * world
    errors: List[str] = []
    pending = set(range(world))
    deadline = time.monotonic() + timeout_s
    try:
        while pending and not errors:
            try:
                r, ok, val = pickle.loads(results.get(timeout=1.0))
            except queue_mod.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    # give a last report a moment to arrive
                    time.sleep(1.0)
                    if results.empty():
                        errors.append(f"rank {dead[0]} exited with code "
                                      f"{procs[dead[0]].exitcode} before "
                                      f"it reported")
                elif time.monotonic() > deadline:
                    errors.append(f"the world of {world} did not finish "
                                  f"in {timeout_s:.0f} s")
                continue
            pending.discard(r)
            if ok:
                out[r] = val
            else:
                errors.append(f"rank {r}:\n{val}")
        # one rank's failure fails its peers ("connection closed by
        # peer"), whose reports may come first: collect the rest briefly,
        # so the cause is among them
        grace = time.monotonic() + REPORT_GRACE_S
        while errors and pending and time.monotonic() < grace:
            try:
                r, ok, val = pickle.loads(results.get(timeout=0.5))
            except queue_mod.Empty:
                continue
            pending.discard(r)
            if not ok:
                errors.append(f"rank {r}:\n{val}")
    finally:
        stop(procs, grace_s=30.0 if not errors else 0.0)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out
