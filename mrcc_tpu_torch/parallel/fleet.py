"""Multi-process data parallelism (port of ``mrcc_tpu/parallel/fleet.py``):
the mesh of ``mesh.py`` over every rank of a ``torch.distributed`` process
group, one process per device, on one host or several.

Bring-up, one call per process before any collective:

    from mrcc_tpu_torch.parallel import fleet
    fleet.init_distributed()          # from torchrun's variables; no-op alone
    mesh = fleet.make_global_mesh()   # every rank of the group
    engine = InferenceEngine(cfg, mesh=mesh)
    out = engine.predict_batch_arrays(*fleet.globalize(mesh, pts, rgb, mask))
    seg = fleet.local_slice(out["segmentation"])

Each process passes its OWN rows to :func:`globalize`; the results are
global arrays (``DTensor`` sharded on the batch axis) whose rows live where
they were computed, and :func:`local_slice` reads this rank's.

Each rank on a host takes its own card (:func:`placement`): torchrun's
``LOCAL_RANK``, else the rank, modulo the host's cards.  The backend
follows: ``nccl`` where every rank of the host has a card of its own,
``gloo`` where ranks share one (NCCL refuses two ranks on one device;
gloo's collectives take card tensors) and on the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh


def placement(process_id: int, num_processes: int, device=None):
    """``(device, backend)`` of rank ``process_id`` of ``num_processes``.

    ``device``: the card unless told otherwise.  A card without an index
    becomes this rank's card on its host: ``LOCAL_RANK`` (torchrun) or
    else the rank, modulo the cards the host shows.  The backend is
    ``nccl`` when the host's ranks (``LOCAL_WORLD_SIZE``, else all of
    them) are no more than its cards, ``gloo`` when they share cards and
    on the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device, "gloo"
    cards = torch.cuda.device_count()
    env = os.environ
    if device.index is None:
        local_rank = int(env.get("LOCAL_RANK", process_id or 0))
        device = torch.device("cuda", local_rank % cards)
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    return device, ("nccl" if local_world <= cards else "gloo")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group.  Idempotent.

    ``coordinator_address`` is ``host:port`` of rank 0; the arguments fall
    back to ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
    (what ``torchrun`` sets).  Returns True once a group of two or more
    ranks is up, False for the single-process no-op (no arguments and no
    environment, or a world of 1).  ``device`` and the backend are
    :func:`placement`'s; a card is made current before the group starts.
    ``timeout_s`` bounds every collective."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "0")) or None
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return False
    device, backend = placement(process_id, num_processes, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_global_mesh(devices=None):
    """1-D ``data`` mesh over every rank of the process group, in rank
    order (consecutive batch rows on consecutive ranks)."""
    return make_mesh(None, devices)


def globalize(mesh, *local_arrays):
    """This process's rows of each batch array -> global ``[b_local x
    ranks, ...]`` arrays sharded on the batch axis (``DTensor``s, local
    rows on the mesh's device)."""
    from torch.distributed.tensor import DTensor, Shard

    dev = _mesh_device(mesh)
    return tuple(DTensor.from_local(torch.as_tensor(x, device=dev), mesh,
                                    [Shard(0)], run_check=False)
                 for x in local_arrays)


def local_slice(global_array) -> np.ndarray:
    """This process's rows of a batch-sharded global array as numpy (the
    mirror of :func:`globalize` for results); a plain tensor or array is
    taken whole."""
    x = global_array
    if hasattr(x, "to_local"):
        x = x.to_local()
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
