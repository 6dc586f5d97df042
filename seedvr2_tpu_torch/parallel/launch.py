"""Start n rank processes on this host and collect what each returns (the
counterpart of the reference's mp.spawn fan-out, one process per card).

``launch(fn, n, args, backend=...)`` spawns ``n`` fresh interpreters
(multiprocessing "spawn": safe beside CUDA and threads), joins them into one
``torch.distributed`` job through a ``FileStore`` in a temporary directory
(no port is fixed or taken), calls ``fn(rank, *args)`` in each and returns
their results in rank order. ``fn`` must be importable by name (a function
at the top level of a module, or of the ``__main__`` script) and its result
picklable.

The backend is the caller's explicit choice: "nccl" for one rank per card,
"gloo" otherwise (ranks that share a card, or the CPU); nothing switches it.
Every rank's process group gets ``timeout`` as its collective timeout, and
the whole launch a wall-clock ``deadline``: when a rank raises, dies, or the
deadline passes, every rank still running is killed and the first failure
is raised here (RuntimeError with the rank's traceback, or TimeoutError),
so a caller never hangs on a stuck rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_main(rank: int, n: int, store_path: str, backend: str, timeout_s: float, fn, args, results) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    try:
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, *args)
    except BaseException:  # reported (with its time) before this rank's connections close
        results.put((rank, False, (time.time(), traceback.format_exc())))
        raise
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _first_failure(results, rank: int, failure) -> str:
    """The message of the rank that failed first: a rank's failure makes the
    others fail in their collectives within moments, so the failures that
    arrive within 2 s are compared by the time each rank caught its own."""
    failures = [(failure[0], rank, failure[1])]
    end = time.monotonic() + 2.0
    while time.monotonic() < end:
        try:
            r, ok, value = results.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            failures.append((value[0], r, value[1]))
    _, rank, tb = min(failures)
    return f"launch: rank {rank} failed first; all ranks killed\n{tb}"


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=30)


def launch(
    fn: Callable[..., Any],
    nprocs: int,
    args: Sequence[Any] = (),
    *,
    backend: str,
    timeout: float = 300.0,
    deadline: float = 900.0,
) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks; returns the results in
    rank order. ``backend`` ("gloo" or "nccl") has no default: the caller
    chooses the transport. ``timeout`` (s): each collective's limit inside
    the ranks; ``deadline`` (s): the wall-clock limit of the whole launch."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="seedvr2_launch_")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(r, nprocs, os.path.join(tmp, "store"), backend, timeout, fn, tuple(args),
                                             results), daemon=True)
        for r in range(nprocs)
    ]
    out: List[Any] = [None] * nprocs
    done = set()
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        while len(done) < nprocs:
            if time.monotonic() > end:
                raise TimeoutError(f"launch: ranks {sorted(set(range(nprocs)) - done)} still running after "
                                   f"{deadline:.0f} s; all ranks killed")
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if dead:
                    try:  # a rank that reported just before it exited
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(f"launch: rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                           "without a result; all ranks killed") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(_first_failure(results, rank, value))
            out[rank] = value
            done.add(rank)
        for p in procs:
            p.join(timeout=60)
    finally:
        _kill(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out
