"""Start N ranks of one function, one device each (the port's launcher).

:func:`spawn` starts ``nprocs`` processes with the ``spawn`` start method
(CUDA cannot be forked), each of which binds its device, joins the default
process group through a ``file://`` store in a fresh temporary directory (no
port to pick, so parallel test workers never collide) and calls
``fn(*args)``. The parent returns the ranks' return values in rank order, or
re-raises the first failure and stops the other ranks; it also stops them
all when ``timeout`` (the whole run's deadline) passes.

Backends (:func:`choose_backend`): NCCL when every rank has a card of its
own; gloo on the CPU; gloo when ranks share one card (NCCL refuses two ranks
on one device). The choice is made before the ranks start and is never
switched after a failure.

Under an outside launcher (``torchrun``: ``WORLD_SIZE`` set) a process joins
that launcher's group instead: :func:`init_from_env`.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import set_rank_device


def choose_backend(device_type: str, nprocs: int) -> str:
    """``nccl`` for CUDA ranks with a card each, else ``gloo``."""
    if device_type == "cuda" and torch.cuda.device_count() >= nprocs:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of rank ``rank``: card ``rank`` modulo the visible cards
    (so ranks share cards round-robin when there are fewer cards), or the
    CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _init(rank: int, world: int, init_method: str, backend: str, device_type: str,
          collective_timeout: Optional[float]) -> torch.device:
    device = rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    set_rank_device(device)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    if collective_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=collective_timeout)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    return device


def _rank_main(rank: int, world: int, init_method: str, backend: str, device_type: str,
               collective_timeout: Optional[float], env: Dict[str, str], fn: Callable,
               args: Sequence, results) -> None:
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    if "OMP_NUM_THREADS" in env:
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    try:
        _init(rank, world, init_method, backend, device_type, collective_timeout)
        out = fn(*args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException as e:  # noqa: BLE001 - the parent re-raises it
        tb = traceback.format_exc()
        try:
            blob = pickle.dumps(e)
        except Exception:  # noqa: BLE001 - an exception that does not pickle
            blob = pickle.dumps(RuntimeError(repr(e)))
        results.put((rank, False, (blob, tb)))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - the rank is ending either way
                pass


class RankFailed(RuntimeError):
    """A rank raised; the message carries its traceback."""


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *, device_type: str = "cpu",
          backend: Optional[str] = None, timeout: Optional[float] = 600.0,
          collective_timeout: Optional[float] = None,
          env: Optional[Dict[str, str]] = None, store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ranks ``0..nprocs-1`` and return their results.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    ``device_type``: ``cpu`` or ``cuda``; ``backend`` defaults to
    :func:`choose_backend`. ``env`` is set in each rank before it starts
    (``OMP_NUM_THREADS`` for CPU ranks, say). ``timeout``: the whole run's
    deadline in seconds (None: none). ``collective_timeout``: each
    collective's, given to ``init_process_group`` (None: torch's default).
    ``store_dir``: where the rendezvous file lives (a fresh temporary
    directory by default, removed after)."""
    backend = backend or choose_backend(device_type, nprocs)
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="rmrt_ranks_") if own_dir else store_dir
    os.makedirs(store_dir, exist_ok=True)
    init_method = "file://" + os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, init_method, backend, device_type,
                               collective_timeout, dict(env or {}), fn, tuple(args), results))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        return _collect(procs, results, nprocs,
                        None if timeout is None else time.monotonic() + timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)


def _collect(procs, results, nprocs: int, deadline: Optional[float]) -> List[Any]:
    out: Dict[int, Any] = {}
    while len(out) < nprocs:
        left = 1.0 if deadline is None else deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(nprocs)) - set(out))
            raise TimeoutError(f"ranks {missing} did not finish in time")
        try:
            rank, ok, payload = results.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [i for i, p in enumerate(procs)
                    if i not in out and p.exitcode is not None]
            if dead:
                # a rank that died without reporting (killed, or a crash in C)
                time.sleep(1.0)  # its report may still be in the pipe
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    raise RankFailed(f"rank {dead[0]} exited with code "
                                     f"{procs[dead[0]].exitcode} and no result") from None
            else:
                continue
        if not ok:
            blob, tb = payload
            exc = pickle.loads(blob)
            raise RankFailed(f"rank {rank} failed:\n{tb}") from exc
        out[rank] = pickle.loads(payload)
    return [out[r] for r in range(nprocs)]


def init_from_env(device_type: str) -> torch.device:
    """Join the process group of an outside launcher (``torchrun`` sets
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``PORT``):
    bind ``LOCAL_RANK``'s card, or the CPU, and return the device. The
    collectives keep torch's default timeout."""
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    world = int(os.environ["WORLD_SIZE"])
    backend = choose_backend(device_type, world)
    device = rank_device(device_type, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    set_rank_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    return device
