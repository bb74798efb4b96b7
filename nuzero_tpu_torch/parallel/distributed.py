"""Multi-process initialization (counterpart of
``nuzero_tpu/parallel/distributed.py``; ref ``Utils/Functions/ray_utils.py``
and the ``SLURM/`` scripts).

The JAX package runs one controller process per host and wires them with
``jax.distributed.initialize``.  The port runs one process per card and
wires them with ``torch.distributed``: NCCL where each rank has its own
card, gloo on the CPU or where several ranks share one card (NCCL refuses
two ranks on one device).  The backend is the caller's choice; nothing
here switches it.

``initialize_distributed`` reads the rendezvous, the world size and the
rank, in this order, from:

1. its arguments;
2. torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``
   and ``LOCAL_RANK``;
3. SLURM's ``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_LOCALID``, with
   ``JAX_COORDINATOR`` (``host:port``, exported by the SLURM templates) as
   the rendezvous.

Each rank's device is ``cuda:LOCAL_RANK % device_count`` (``local_device``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# The rank of this process among the processes of its host, set by
# ``initialize_distributed``.
_local_rank = 0


def launched_multi_process() -> bool:
    """True where the environment says this process is one of several: a
    torchrun launch of more than one rank, a SLURM job of more than one
    task, or ``JAX_COORDINATOR`` set (``slurm/launch.py``'s templates)."""
    env = os.environ
    return bool(env.get("JAX_COORDINATOR")) or any(
        int(env.get(key, "1") or 1) > 1 for key in ("WORLD_SIZE", "SLURM_NTASKS"))


def _from_environment():
    """(address, world size, rank, local rank) from torchrun's or SLURM's
    variables; None for what neither sets."""
    env = os.environ
    if all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
        return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
                int(env["RANK"]), int(env.get("LOCAL_RANK", env["RANK"])))
    if "SLURM_PROCID" in env:
        return (env.get("JAX_COORDINATOR"), int(env.get("SLURM_NTASKS", "1")),
                int(env["SLURM_PROCID"]), int(env.get("SLURM_LOCALID", "0")))
    return None, None, None, None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the job's process group.  Arguments override
    the environment (see the module's docstring); ``backend`` is "nccl" or
    "gloo" and defaults to NCCL where a card is available, gloo where not.
    Under NCCL the process's current CUDA device becomes its rank's
    (``local_device``)."""
    global _local_rank
    address, world, rank, local = _from_environment()
    address = coordinator_address or address or os.environ.get("JAX_COORDINATOR")
    world = num_processes if num_processes is not None else world
    rank = process_id if process_id is not None else rank
    if process_id is not None:
        local = process_id if local is None else local
    if address is None or world is None or rank is None:
        raise ValueError(
            "initialize_distributed: no rendezvous, world size or rank given; pass them, "
            "or launch with torchrun or SLURM (JAX_COORDINATOR=host:port)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    _local_rank = local or 0
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank)


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` on the card,
    the CPU otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", _local_rank % torch.cuda.device_count())


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multi_host() -> bool:
    """True where this process is one rank of several (the JAX package's
    name: there a process is a host)."""
    return process_count() > 1


def local_shard(global_batch: int) -> int:
    """This rank's slice of a globally-sized batch."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    return global_batch // n
