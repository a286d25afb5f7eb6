"""Multi-process start-up (port of drt_tpu/parallel/multihost.py).

Call `init_multihost()` once at program start in every process, then
`make_ray_mesh()` spans them. Under `torchrun --nproc-per-node N` every
argument comes from the environment (env://); elsewhere give the address,
the number of processes and this process's rank yourself. The only
collectives a train step makes are its small all_reduces: the summed [V,3]
gradient, the loss and its parts, the trace counters and the largest
silhouette-edge count.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device="cuda") -> None:
    """Initialize torch.distributed: NCCL for device "cuda", gloo for
    "cpu". coordinator_address "host:port" becomes tcp://host:port; an
    address with a scheme (file://..., tcp://...) is used as it is; None
    reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (env://, as torchrun
    sets them). With "cuda" this process's card becomes the current device
    (LOCAL_RANK, or else the rank, modulo the cards), and without a card it
    raises: there is no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost(device='cuda'): torch sees no "
                               "CUDA device; pass device='cpu' for gloo on "
                               "the CPU")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_multihost: unsupported device {device!r}")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if backend == "nccl":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def shard_rays_for_host(n_rays: int) -> slice:
    """The contiguous ray range this process loads, so that each process
    holds only its own shard of the per-pixel arrays. n_rays must divide
    over the processes, as `shard_views` requires; pad the batch first
    (parallel.pad_views_to_multiple) rather than load uneven shards."""
    n_proc = dist.get_world_size()
    if n_rays % n_proc:
        raise ValueError(
            f"n_rays={n_rays} does not divide over {n_proc} processes; "
            "pad the ray batch to a multiple first "
            "(drt_tpu_torch.parallel.pad_views_to_multiple)")
    per = n_rays // n_proc
    i = dist.get_rank()
    return slice(i * per, (i + 1) * per)
