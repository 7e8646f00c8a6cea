"""Data-parallel mesh (port of ``mrcc_tpu/parallel/mesh.py``).

The JAX package shards the padded batch axis over a 1-D ``data`` mesh and
replicates the parameters; XLA then computes every step on the global
batch.  Here each rank of a ``torch.distributed`` process group is one
position on a 1-D ``DeviceMesh`` named ``data``, owns a contiguous block of
the batch's rows, and holds a full copy of the parameters.

Inference needs no collective: every stage is per item.  Training keeps
the JAX step's *global* semantics with a few explicit reductions, which
run only inside :func:`data_parallel` (outside it every helper here is
the identity and the single-process code path is unchanged):

- :func:`global_sum` / :func:`global_count` / :func:`global_mean` — sums
  and means over every rank's rows, differentiable (the backward pass sums
  the gradient over the ranks too): the batch norms' statistics;
- :func:`mean_share` and :func:`global_count` in the criteria: each rank's
  loss is its share of the global loss (local sum / global count), and
  :func:`reported` sums the shares for the metrics;
- :func:`sync_gradients` — the sum of those shares' gradients, all-reduced
  as one flat buffer in parameter order, so every rank steps to the same
  bits;
- :func:`global_rows` — the rows of a global draw this rank owns (dropout
  masks equal to the single-process step's);
- :func:`global_batch` — every rank's rows of a tensor, differentiable: a
  criterion that pairs items across the batch (the metric-learning miner)
  runs on the global batch, every rank computing the whole loss and
  backpropagating it into its own rows only.
"""

from __future__ import annotations

import contextlib
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
# the mesh of the data-parallel step being run (None outside one); set by
# ``data_parallel`` around a step, because the batch norms and criteria
# that read it sit deep inside the models and losses
_ACTIVE = None


def default_backend(device_type: str) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def _device_type(devices) -> str:
    if devices is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(devices).type


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: Optional[int] = None, devices=None):
    """1-D ``data`` mesh, one device per rank of the process group.

    ``devices``: the device type (``"cuda"`` or ``"cpu"``; default the card
    when there is one).  Without a process group a 1-rank one is started
    on localhost (``nccl`` on the card, ``gloo`` on the CPU).  Raises
    ``ValueError`` when the group holds fewer ranks than ``n_devices``,
    so a 1-rank run cannot pass for an n-rank one, and when it holds more:
    a rank outside the mesh would have no rows to run."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type(devices)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}): no process group, so 1 rank; "
                "start the ranks with fleet.init_distributed first")
        dist.init_process_group(default_backend(device_type),
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh({n_devices}): the process group has {world} ranks; "
            "the mesh spans every rank")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(DATA_AXIS,))


def batch_sharding(mesh, total: int) -> slice:
    """The rows of a ``total``-row batch this rank owns (contiguous, in
    rank order).  ``total`` must divide by the mesh size."""
    n = mesh.size()
    if total % n:
        raise ValueError(f"batch of {total} rows does not divide by the "
                         f"mesh size {n}; pad it (pad_batch_to)")
    per = total // n
    r = mesh.get_local_rank()
    return slice(r * per, (r + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh):
    """This rank's contiguous rows of every ``[B, ...]`` array (numpy or
    tensor) in a dict / list / tuple of them; ``B`` must divide by the
    mesh size (``ValueError`` otherwise: pad first)."""
    def take(x):
        return x[batch_sharding(mesh, x.shape[0])]

    return _tree_map(take, batch)


def _group(mesh):
    return mesh.get_group(DATA_AXIS)


def replicate(tree, mesh):
    """Broadcast from the mesh's first rank, in place: the tensors of a
    dict / list / tuple, or a module's parameters and buffers (in their
    registration order).  Returns ``tree``."""
    group = _group(mesh)
    src = dist.get_global_rank(group, 0)
    if isinstance(tree, torch.nn.Module):
        tensors = [t.data for t in tree.state_dict(keep_vars=True).values()
                   if t is not None]
    else:
        tensors = []
        _tree_map(lambda t: tensors.append(t) if torch.is_tensor(t) else None,
                  tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    return tree


def broadcast_object(obj, mesh):
    """The mesh's first rank's ``obj`` (picklable; its tensors travel on
    the CPU) on every rank."""
    group = _group(mesh)
    box = [_tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t)
                     else t, obj)]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def pad_batch_to(batch, total: int):
    """Pad the leading axis of every array in the batch dict to ``total``
    rows so it divides the mesh size.

    Pads by duplicating item 0 WHOLE (points, mask, labels, pose together):
    each padded row is then a real (item, target) pair, so pose losses and
    metrics that average over the batch axis stay valid — the objective is
    merely reweighted slightly toward item 0 on the final partial batch.
    ``others`` (per-item host objects) is left as it is."""
    def pad(x):
        x = np.asarray(x)
        b = x.shape[0]
        if b == total:
            return x
        return np.concatenate([x, np.repeat(x[:1], total - b, axis=0)],
                              axis=0)

    return {k: (v if k == "others" else pad(v)) for k, v in batch.items()}


def padded_size(b: int, mesh) -> int:
    """``b`` rounded up to a multiple of the mesh size."""
    n = mesh.size()
    return -(-b // n) * n


# ---------------------------------------------------------- the DP step


@contextlib.contextmanager
def data_parallel(mesh):
    """Run a train step's reductions over every rank of ``mesh``."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh of the running data-parallel step, or None."""
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks'
    gradients (each rank's loss share reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x):
    """``x`` (a per-rank partial sum) summed over the active mesh's ranks;
    ``x`` itself outside a data-parallel step."""
    if _ACTIVE is None:
        return x
    return _AllReduceSum.apply(x, _group(_ACTIVE))


class _GatherRows(torch.autograd.Function):
    """Every rank's rows in rank order (equal row counts); the gradient is
    this rank's rows of the cotangent.  Every rank computes the same loss
    of the gathered rows and backpropagates it whole, so each rank's
    gradient is the loss's through its own rows, and their sum over the
    ranks (:func:`sync_gradients`) is the loss's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.rows = slice(r * x.shape[0], (r + 1) * x.shape[0])
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


def global_batch(x):
    """Every rank's rows of ``x`` concatenated in rank order,
    differentiable (:class:`_GatherRows`); ``x`` itself outside a
    data-parallel step."""
    if _ACTIVE is None:
        return x
    return _GatherRows.apply(x, _group(_ACTIVE))


def global_count(n, device=None):
    """A count (a tensor, or a number placed on ``device``) summed over
    the ranks, without gradient; ``n`` itself outside a data-parallel
    step."""
    if _ACTIVE is None:
        return n
    if not torch.is_tensor(n):
        n = torch.tensor(float(n), device=device)
    with torch.no_grad():
        return global_sum(n)


def mean_share(x):
    """This rank's share of ``x.mean()`` over every rank's elements:
    ``x.sum() / global element count`` (the shares sum to the global mean;
    the loss shares' gradients are summed by :func:`sync_gradients`);
    ``x.mean()`` outside a data-parallel step."""
    if _ACTIVE is None:
        return x.mean()
    return x.sum() / global_count(x.numel(), x.device).to(x.dtype)


def global_mean(x, dim):
    """The mean of ``x`` over ``dim`` (the batch axis among them) across
    every rank's rows, differentiable; ``x.mean(dim)`` outside a
    data-parallel step."""
    if _ACTIVE is None:
        return x.mean(dim)
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return global_sum(x.sum(dim)) / global_count(n, x.device).to(x.dtype)


def global_rows(shape):
    """``(global shape, this rank's row slice)`` of a draw over the global
    batch whose local rows have ``shape``; ``(shape, all rows)`` outside a
    data-parallel step."""
    shape = tuple(shape)
    if _ACTIVE is None:
        return shape, slice(None)
    n, r = _ACTIVE.size(), _ACTIVE.get_local_rank()
    return (shape[0] * n,) + shape[1:], slice(r * shape[0],
                                              (r + 1) * shape[0])


def sync_gradients(params):
    """Sum the parameters' ``.grad`` over the active mesh's ranks, as one
    flat buffer in parameter order (every rank gets the same bits).  Every
    rank runs the same graph, so the same parameters have a gradient.
    No-op outside a data-parallel step."""
    if _ACTIVE is None:
        return
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=_group(_ACTIVE))
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p)
        off += n


def reported(x):
    """A metric's per-rank share summed over the ranks, detached."""
    with torch.no_grad():
        return global_sum(x.detach())


def gather_rows(x, mesh):
    """Every rank's rows of ``x`` concatenated in rank order (an
    all-gather)."""
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=_group(mesh))
    return torch.cat(parts, dim=0)
