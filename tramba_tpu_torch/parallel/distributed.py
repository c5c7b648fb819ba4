"""Multi-process set-up: ``initialize_from_args``.

Port of ``tramba_tpu/parallel/distributed.py:29-44``.  JAX runs one process
per host over all of its chips; torch runs one process per card, as
``torchrun --nproc_per_node=N`` starts them.  Two launch protocols set the
world up:

* torchrun's: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (and
  ``MASTER_ADDR`` / ``MASTER_PORT``, read by ``env://``);
* the JAX package's: ``TRAMBA_NUM_PROCESSES`` and ``TRAMBA_PROCESS_ID``,
  with the rendezvous address from ``--init_method`` (``tcp://host:port`` or
  ``file://path``).

The backend is NCCL for the card and gloo for the CPU; on the card each
process takes the card ``LOCAL_RANK`` (else its rank modulo the visible
cards).  With neither protocol's variables set, a single process is left
untouched.

:func:`spawn` starts such a world from one process: ``world`` fresh
processes on one host, joined through a rendezvous file, each running a
function and handing its result back (the dry run and the tests use it).
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_from_args", "spawn"]


def initialize_from_args(init_method: Optional[str] = None, device: str = "cuda") -> bool:
    """Initialize ``torch.distributed`` when a launch protocol's environment
    says the run has more than one process; returns whether it has."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        world = int(env.get("TRAMBA_NUM_PROCESSES", "1"))
        if world <= 1:
            return False
        rank = int(env["TRAMBA_PROCESS_ID"])
        local = int(env.get("LOCAL_RANK", rank))
        if not init_method:
            raise ValueError("TRAMBA_NUM_PROCESSES > 1 needs --init_method tcp://host:port")
    if world <= 1:
        return False
    _join(world, rank, local, init_method, device)
    return True


def _join(world: int, rank: int, local: int, init_method: str, device: str) -> None:
    """Join the world as ``rank``: NCCL with card ``local`` (modulo the
    visible cards) on the card, gloo on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def _spawned(rank: int, fn: Callable, world: int, device: str, init_method: str, out: str,
             args: tuple) -> None:
    if torch.device(device).type != "cuda":
        torch.set_num_threads(1)  # the processes share the host's cores
    _join(world, rank, rank, init_method, device)
    try:
        torch.save(fn(*args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device: str = "cuda", *args) -> List:
    """Run ``fn(*args)`` in ``world`` new processes joined into one
    ``torch.distributed`` world (gloo on the CPU; NCCL on the card, process
    r on card r; the card unless ``device`` is ``"cpu"``).  Returns each rank's result, in rank order; a failing rank
    raises.  ``fn`` must be importable by name (a module-level function)."""
    # a fork server that has imported torch and the port once starts each
    # process in about a second, where a fresh interpreter takes several
    multiprocessing.set_forkserver_preload(["tramba_tpu_torch.models.registry", fn.__module__])
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, world, device, f"file://{tmp}/rendezvous", tmp, args),
            nprocs=world, join=True, start_method="forkserver")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
