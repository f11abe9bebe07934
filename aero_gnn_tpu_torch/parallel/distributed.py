"""Multi-process runtime initialization (counterpart of
aero_gnn_tpu.parallel.distributed, distributed.py:22-64).

One process per rank. ``initialize`` wires the ranks with
``torch.distributed``; the programs of ``parallel.data_parallel``,
``spatial``, ``halo``, ``hybrid`` and ``bsms_spatial`` then run over the
groups of a ``parallel.mesh.Mesh`` built from the world.

The backend is chosen once, from the cluster spec (``choose_backend``),
and never by catching an error:

  * ``"nccl"`` when each rank has a card of its own: CUDA is asked for and
    the ranks of one host (``LOCAL_WORLD_SIZE``, else the world size) are
    no more than the host's cards;
  * ``"gloo"`` on the CPU (``device="cpu"``) and when ranks share a card
    (more ranks on a host than cards), since NCCL refuses two ranks on one
    device. gloo takes the card's tensors for every collective the port
    runs (``parallel.collectives``); the kernels run on the card either
    way.

A rank's device (``rank_device``) is ``cuda:{local_rank % device_count}``
unless the caller passes ``device="cpu"``; a rank asked for the card that
finds none raises (``device.resolve_device``).

``spawn`` starts the ranks of one host as processes (start method spawn)
and returns what each rank's program returns; ranks of several worlds may
run side by side, and share a card.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from aero_gnn_tpu_torch.device import DeviceLike, resolve_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def choose_backend(local_world_size: int, device: DeviceLike = None) -> str:
    """``"nccl"`` when every rank of a host has its own card, else
    ``"gloo"`` (the CPU, or ranks sharing a card)."""
    if resolve_device(device).type == "cpu":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` (torchrun), else
    the global rank, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``device`` when given, else the card
    ``cuda:{local_rank % device_count}`` (RuntimeError without one)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without a card
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               initialization_timeout: Optional[int] = None, *,
               device: DeviceLike = None) -> None:
    """Idempotent ``torch.distributed`` bring-up (a no-op for one process).

    ``coordinator_address`` is ``host:port`` (TCP) or an init-method URL
    (``tcp://...``, ``file:///...``: a FileStore); with it pass
    ``num_processes`` and ``process_id``. Without a spec, torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` are read;
    without those either, nothing is wired (a single-process run). A spec
    that fails raises, as JAX's explicit spec does (distributed.py:46-55):
    a wrong address must not fall back to one process and sum over one
    rank without a word. The backend is ``choose_backend``'s;
    ``device`` is this rank's device (``rank_device``).
    ``initialization_timeout`` is in seconds."""
    if num_processes == 1 or dist.is_initialized():
        return
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None or \
                process_id is None:
            raise ValueError("an explicit cluster spec needs "
                             "coordinator_address, num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(local_world, device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def global_device_count() -> int:
    """The world size: one device per rank (ranks may share a card)."""
    return dist.get_world_size() if dist.is_initialized() else 1


Job = Tuple[Callable[[int, int, Any], Any], int, Any, Dict[str, str]]


def spawn(jobs: Sequence[Job], timeout_s: float = 600.0) -> List[List[Any]]:
    """Run each job ``(program, world, spec, env)`` as ``world`` processes,
    every job's at the same time (``torch.multiprocessing``, start method
    spawn: CUDA tensors do not cross it, so a rank builds its own inputs).
    Each process adds ``env`` to its environment, then runs
    ``program(rank, world, spec)``, which wires its own process group
    (``initialize``); ``program`` must pickle (a module-level function or
    a ``functools.partial`` of one). Returns each job's results in rank
    order. When a rank raises or exits non-zero, or the run passes
    ``timeout_s``, every rank still running is killed and this raises
    RuntimeError with each failed rank's traceback; every process is
    joined and the results' directory removed either way."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="aero_gnn_ranks_")
    runs = []
    for j, (program, world, spec, env) in enumerate(jobs):
        outs = [os.path.join(tmp, f"job{j}_rank{r}.pkl")
                for r in range(world)]
        runs.append((outs, [ctx.Process(
            target=_rank_main, args=(program, r, world, spec, env, outs[r]))
            for r in range(world)]))
    procs = [p for _, ps in runs for p in ps]
    timed_out = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results, failed = [], []
        for j, (outs, ps) in enumerate(runs):
            results.append([])
            for r, (path, p) in enumerate(zip(outs, ps)):
                ok, value = False, None
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        ok, value = pickle.load(f)
                if ok and p.exitcode == 0:
                    results[-1].append(value)
                else:
                    failed.append(f"job {j} rank {r} (exit code "
                                  f"{p.exitcode})" + (f":\n{value}" if value
                                                      else ""))
        if failed:
            raise RuntimeError(
                "ranks failed" + (f" or passed {timeout_s} s" if timed_out
                                  else "") + ": " + "\n".join(failed))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(program, rank: int, world: int, spec, env: Dict[str, str],
               out: str) -> None:
    """One spawned rank: its result, or its traceback, pickled to ``out``
    as (ok, value); a rank that raised exits 1."""
    os.environ.update(env)
    try:
        result = (True, program(rank, world, spec))
    except BaseException:  # reported by spawn, which raises
        result = (False, traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if not result[0]:
        os._exit(1)  # peers may hang in a collective: no teardown
    if dist.is_initialized():
        dist.destroy_process_group()
