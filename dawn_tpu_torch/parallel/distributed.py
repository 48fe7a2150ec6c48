"""Multi-process start-up on ``torch.distributed``.

Port of ``dawn_tpu/parallel/distributed.py``. One process drives one card
(or, with ``device="cpu"``, one CPU worker over the ``gloo`` backend). The
same script runs in every process:

    from dawn_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from dawn_tpu_torch.parallel.mesh import make_mesh
    maybe_initialize_distributed()      # nothing to do with one process
    mesh = make_mesh(seq_parallel=2)    # over all the processes

Configuration, in order of precedence:
1. explicit arguments;
2. ``DAWN_COORDINATOR`` (``host:port`` of rank 0), ``DAWN_NUM_PROCESSES``
   and ``DAWN_PROCESS_ID``, as for the JAX package;
3. the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
   environment that ``torchrun`` sets (``LOCAL_RANK`` picks the card).

Nothing is found: one process, nothing initialized, as in JAX.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device=None) -> bool:
    """Initialize the default process group when a multi-process
    configuration is present: ``nccl`` for the card, ``gloo`` when ``device``
    is the CPU. Returns True when running multi-process, False for the plain
    single-process path. A second call returns True at once."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("DAWN_COORDINATOR")
    if num_processes is None and "DAWN_NUM_PROCESSES" in env:
        num_processes = int(env["DAWN_NUM_PROCESSES"])
    if process_id is None and "DAWN_PROCESS_ID" in env:
        process_id = int(env["DAWN_PROCESS_ID"])
    if coordinator_address is not None or num_processes is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        init_method = "env://"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if coordinator_address is None and init_method != "env://":
        raise ValueError("DAWN_NUM_PROCESSES is set but DAWN_COORDINATOR is not")
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs both the process count and this "
                         "process's id (DAWN_NUM_PROCESSES, DAWN_PROCESS_ID)")

    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' for gloo on the CPU")
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of a data-parallel global batch."""
    per = global_batch // process_count()
    assert per * process_count() == global_batch, (
        f"global batch {global_batch} not divisible by "
        f"{process_count()} processes")
    start = process_index() * per
    return slice(start, start + per)
