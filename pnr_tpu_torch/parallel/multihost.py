"""The multi-process runtime on torch.distributed.

Port of pnr_tpu/parallel/multihost.py. JAX's design is the redundant host
driver, and so is the port's: every process runs the same host logic on
the same host data (seed order, the first-come-first-served commit
wavefront, the graph stages), and device data crosses processes only
where the host reads it. Nothing in the sharded pipeline changes its
results for it: a mesh from `make_global_mesh` lists every process's
shards in rank order, records the rank that owns each (`Mesh.ranks`), and
a sharded volume holds this process's shards as tensors and the others'
as None. What JAX moves across processes with XLA collectives, the port
moves through `exchange`: an all-gather of each process's host payload on
the default process group, its byte counts first and then the padded
bytes. The halos, the global Jmin/Jmax, the handoff's lane states, the
per-shard seed rows, the seed scores and the stage outputs the host reads
all go through it, every process issuing the same exchanges in the same
order (a host branch on local data comes after the exchange that makes
the data the same everywhere).

The caller names the backend: "gloo" on CPU processes, "nccl" where each
process has its own card, "gloo" for processes that share one card (NCCL
refuses two ranks on one device). Gloo's collectives take host tensors,
so every payload is copied to the host explicitly before it is sent.
"""

from __future__ import annotations

import datetime
import pickle
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

#: bytes this process has received from other processes through `exchange`
RECEIVED_BYTES = 0
#: a collective that waits longer raises (a process that never joins it,
#: or joins another one, shows as this error rather than as a hang)
COLLECTIVE_TIMEOUT_S = 240


def init_multihost(coordinator_address: str, num_processes: int, process_id: int, *,
                   backend: str) -> int:
    """Join the process group at `coordinator_address` ("host:port" or
    "tcp://host:port") as rank `process_id` of `num_processes`, on the
    caller's `backend`; returns the rank. With "nccl" the process's card
    becomes cuda:(rank % cards). A failure raises; so does a collective
    that waits longer than COLLECTIVE_TIMEOUT_S."""
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dist.get_rank()


def shutdown_multihost() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _wire_device() -> torch.device:
    """Where a collective's buffers live: the process's card under NCCL,
    the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def exchange(obj) -> list:
    """All-gather a picklable host object: every process gets the list of
    all processes' objects, in rank order (its own included). Device
    tensors must be copied to the host (`.cpu()`) by the caller. One
    process alone gets [obj]. The group's members are this program's own
    processes: what they send is unpickled."""
    global RECEIVED_BYTES
    if process_count() == 1:
        return [obj]
    dev = _wire_device()
    payload = np.frombuffer(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8)
    n = torch.tensor([payload.size], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(n) for _ in range(process_count())]
    dist.all_gather(counts, n)
    counts = [int(c.item()) for c in counts]
    buf = torch.zeros(max(counts), dtype=torch.uint8)
    buf[:payload.size] = torch.from_numpy(payload.copy())
    bufs = [torch.empty(max(counts), dtype=torch.uint8, device=dev) for _ in counts]
    dist.all_gather(bufs, buf.to(dev))
    me = process_index()
    RECEIVED_BYTES += sum(c for r, c in enumerate(counts) if r != me)
    return [obj if r == me else pickle.loads(b[:c].cpu().numpy().tobytes())
            for r, (b, c) in enumerate(zip(bufs, counts))]


def make_global_mesh(axis: str = "z",
                     device: Union[None, str, torch.device, Sequence] = None):
    """A 1-D mesh over every process's shards, in rank order. `device` is
    this process's shard device, or a sequence of them (several shards a
    process, a device may repeat); by default the process's card,
    cuda:(rank % cards). The mesh records each shard's rank; every process
    must bring at least one shard. In a single process it is
    `Mesh(devices)`."""
    from pnr_tpu_torch.parallel.sharded import Mesh
    from pnr_tpu_torch.utils.runtime import require_cuda

    if device is None:
        device = torch.device("cuda", process_index() % max(1, torch.cuda.device_count()))
    local = [device] if isinstance(device, (str, torch.device)) else list(device)
    local = [require_cuda(d) for d in local]
    everyone = exchange([str(d) for d in local])
    if not all(everyone):
        raise ValueError(f"make_global_mesh: every process needs a shard, got {everyone}")
    if len(everyone) == 1:
        return Mesh(tuple(local), axis)
    devices = tuple(torch.device(d) for devs in everyone for d in devs)
    ranks = tuple(r for r, devs in enumerate(everyone) for _ in devs)
    return Mesh(devices, axis, ranks=ranks, rank=process_index())


def fetch_replicated(shards: Sequence[Optional[torch.Tensor]],
                     extent: Optional[int] = None) -> np.ndarray:
    """The shards concatenated along axis 0 on the host, trimmed to the
    first `extent` rows (the volume's before the pipeline padded it to a
    mesh multiple). A multi-process sharding (None for another process's
    shard) is gathered through `exchange` first: every process of the mesh
    must call it."""
    if any(t is None for t in shards):
        mine = {i: t.cpu().numpy() for i, t in enumerate(shards) if t is not None}
        got = {}
        for part in exchange(mine):
            got.update(part)
        parts = [got[i] for i in range(len(shards))]
    else:
        parts = [t.cpu().numpy() for t in shards]
    out = np.concatenate(parts, axis=0)
    return out if extent is None else out[:extent]


def allgather_host_rows(rows: np.ndarray) -> np.ndarray:
    """Small per-process host arrays (n_p, k) with varying n_p, concatenated
    in rank order on every process (counts first, then the padded rows,
    as `exchange` sends them): for KB-scale metadata such as per-shard
    seed lists, not volumes."""
    rows = np.ascontiguousarray(rows)
    parts: List[np.ndarray] = exchange(rows)
    return np.concatenate(parts, axis=0) if len(parts) > 1 else rows


def shard_volume_global(vol, mesh) -> list:
    """A (Z, Y, X) volume Z-sharded over a (possibly multi-process) mesh:
    this process materializes only the slabs its shards own, through
    `vol[a:b]`, so `vol` may be the whole volume on every process or any
    object that slices so (a memory-mapped stack); the others' shards are
    None."""
    from pnr_tpu_torch.parallel.sharded import shard_volume

    return shard_volume(vol, mesh)
