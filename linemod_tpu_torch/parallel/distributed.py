"""Process-group bootstrap for sharded detection (counterpart of
`linemod_tpu/parallel/distributed.py`).

One process per device, as torchrun starts them: `initialize_distributed`
joins the world (NCCL between CUDA ranks, gloo on the CPU) and returns the
rank's device; `global_detection_mesh` lays the world out as a (dp, tp)
mesh whose tp rows stay inside one node, so the per-frame collectives
(the planes' band all-gather, the candidate merge, the fine gather) run
between devices of one host and frames batch across hosts.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import make_mesh

# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str, default=None):
    value = os.environ.get(name)
    return default if value is None else int(value)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the process group and return this rank's device.

    coordinator_address ("host:port"), num_processes and process_id win
    over the environment torchrun sets: MASTER_ADDR:MASTER_PORT, WORLD_SIZE
    and RANK. The device is `cuda:LOCAL_RANK` unless `device` names
    another (`"cpu"` for CPU ranks). The backend is NCCL for a CUDA device
    and gloo on the CPU unless named. A second call leaves the group as it
    is and returns the device."""
    if device is None:
        device = torch.device("cuda", _env_int("LOCAL_RANK", 0))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", 1)
    if process_id is None:
        process_id = _env_int("RANK", 0)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError("a world of several processes needs a coordinator address (MASTER_ADDR)")
        # a world of one: an in-process store, no port to claim
        where = {"store": dist.HashStore()}
    else:
        where = {"init_method": f"tcp://{coordinator_address}"}
    dist.init_process_group(
        backend,
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        **where,
    )
    return device


def global_detection_mesh(dp: int | None = None):
    """(dp, tp) mesh over the whole world. The default dp is the number of
    nodes (WORLD_SIZE // LOCAL_WORLD_SIZE), so the template bank shards
    inside a node and frames batch across nodes; a dp that does not divide
    the world falls back to 1."""
    n = dist.get_world_size()
    if dp is None:
        dp = max(1, n // _env_int("LOCAL_WORLD_SIZE", n))
    if n % dp:
        dp = 1
    return make_mesh(n, dp=dp)
