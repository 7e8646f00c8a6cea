"""The port's data-parallel helpers (``mrcc_tpu_torch.parallel``) against
the JAX package's ``mrcc_tpu.parallel``:

- ``pad_batch_to`` byte for byte equal to JAX's (item 0 repeated whole,
  ``others`` untouched);
- ``batch_sharding`` / ``shard_batch``: contiguous rows in rank order, and
  ``ValueError`` where the batch does not divide by the mesh size (JAX's
  requirement);
- ``make_mesh`` raising ``ValueError`` when fewer ranks exist than asked
  (in this process: no process group; in a 2-rank run: 4 asked);
- ``init_distributed`` returning False with no arguments and no
  environment;
- ``placement``: each rank of a host on its own card (``LOCAL_RANK``, else
  the rank, modulo the cards), ``nccl`` where the host's ranks have a card
  each and ``gloo`` where they share one, with the card count and the
  environment patched; ``init_distributed`` making that card current
  before it starts the group with that backend;
- a 2-rank gloo run (``torch_dp_worker.py``): ``globalize`` /
  ``local_slice`` round trip, ``shard_batch``, ``gather_rows``,
  ``replicate`` from rank 0, and the differentiable ``global_sum`` (its
  gradient summed over the ranks), ``mean_share`` and ``global_count``.
"""

import types

import numpy as np
import pytest

from mrcc_tpu.parallel.mesh import pad_batch_to as jax_pad_batch_to
from mrcc_tpu_torch.parallel import (batch_sharding, fleet, make_mesh,
                                     pad_batch_to, shard_batch)
from torch_dp_worker import run_ranks


def _fake_mesh(size, rank):
    """The two questions the row helpers ask of a mesh."""
    return types.SimpleNamespace(size=lambda: size,
                                 get_local_rank=lambda: rank)


@pytest.mark.parametrize("b,total", [(7, 8), (8, 8), (3, 4), (1, 4)])
def test_pad_batch_to_matches_jax(b, total):
    rng = np.random.default_rng(b)
    batch = {"points": rng.normal(size=(b, 5, 3)).astype(np.float32),
             "mask": rng.random((b, 5)) > 0.5,
             "labels": rng.integers(0, 3, (b, 5)).astype(np.int32),
             "pose": rng.normal(size=(b, 7)),
             "others": [{"i": i} for i in range(b)]}
    got = pad_batch_to(batch, total)
    want = jax_pad_batch_to(batch, total)
    assert set(got) == set(want)
    assert got["others"] is batch["others"]
    for k in ("points", "mask", "labels", "pose"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
        np.testing.assert_array_equal(got[k][b:], np.repeat(
            batch[k][:1], total - b, axis=0))


@pytest.mark.parametrize("size", [1, 2, 4])
def test_shard_batch_rows(size):
    x = np.arange(8 * 2).reshape(8, 2)
    parts = []
    for rank in range(size):
        mesh = _fake_mesh(size, rank)
        rows = batch_sharding(mesh, 8)
        assert rows == slice(rank * 8 // size, (rank + 1) * 8 // size)
        got = shard_batch({"x": x, "t": (x[:, 0], x[:, 1])}, mesh)
        np.testing.assert_array_equal(got["x"], x[rows])
        np.testing.assert_array_equal(got["t"][1], x[rows, 1])
        parts.append(got["x"])
    np.testing.assert_array_equal(np.concatenate(parts), x)


def test_shard_batch_needs_a_divisible_batch():
    with pytest.raises(ValueError, match="pad"):
        shard_batch({"x": np.zeros((7, 2))}, _fake_mesh(2, 0))


def test_make_mesh_raises_on_too_few_ranks():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(2, "cpu")
    assert not dist.is_initialized()


def test_init_distributed_noop_without_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert fleet.init_distributed() is False
    # a world of one is the same no-op
    assert fleet.init_distributed("127.0.0.1:1", 1, 0) is False


_LAUNCH_ENV = ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.mark.parametrize("env,rank,world,cards,device,want", [
    # torchrun on one host of four cards: rank 3 on card 3
    ({"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4"}, 3, 4, 4, "cuda",
     ("cuda:3", "nccl")),
    # torchrun on the second of two hosts of four cards
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, 5, 8, 4, "cuda",
     ("cuda:1", "nccl")),
    # no launcher variables: the rank picks the card
    ({}, 5, 8, 8, "cuda", ("cuda:5", "nccl")),
    # two ranks on one card share it over gloo
    ({}, 1, 2, 1, "cuda", ("cuda:0", "gloo")),
    ({"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "3"}, 2, 3, 2, "cuda",
     ("cuda:0", "gloo")),
    # a card named by the caller is kept
    ({}, 1, 2, 2, "cuda:0", ("cuda:0", "nccl")),
    ({}, 1, 2, 2, "cpu", ("cpu", "gloo")),
], ids=["torchrun", "second_host", "rank", "shared", "shared_torchrun",
        "named", "cpu"])
def test_placement(monkeypatch, env, rank, world, cards, device, want):
    import torch

    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got, backend = fleet.placement(rank, world, device)
    assert (str(got), backend) == want


def test_init_distributed_sets_the_rank_card_first(monkeypatch):
    """Under torchrun on a host of four cards, local rank 2 makes card 2
    current, then starts an NCCL group from the launcher's variables."""
    import torch
    import torch.distributed as dist

    calls = []
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29400",
                 "WORLD_SIZE": "8", "RANK": "6", "LOCAL_RANK": "2",
                 "LOCAL_WORLD_SIZE": "4"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            ("init", backend, kw["init_method"],
                             kw["world_size"], kw["rank"])))
    assert fleet.init_distributed() is True
    assert calls == [("set_device", "cuda:2"),
                     ("init", "nccl", "tcp://10.0.0.1:29400", 8, 6)]


def test_two_rank_roundtrip(tmp_path):
    r0, r1 = run_ranks("roundtrip", {}, tmp_path, timeout_s=120)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for rank, r in enumerate((r0, r1)):
        assert r["rank"] == rank and r["world"] == 2
        assert r["global_shape"] == (8, 3)
        lo, hi = rank * 4, rank * 4 + 4
        np.testing.assert_array_equal(r["local_x"], x[lo:hi])
        np.testing.assert_array_equal(r["local_y"], x[lo:hi] > 10)
        assert r["rows"] == slice(lo, hi)
        np.testing.assert_array_equal(r["shard"], x[lo:hi])
        np.testing.assert_array_equal(r["gathered_y"], x > 10)
        np.testing.assert_array_equal(r["replicated"], [1.0, 1.0, 1.0])
        assert r["too_few_raised"]
        # sum over ranks of 2 * (rank + 1)^2; d/dv = 2 v summed over 2 ranks
        assert r["total"] == 2 * 1.0 + 2 * 4.0
        np.testing.assert_array_equal(r["grad"], [4.0 * (rank + 1)] * 2)
        assert r["share"] == 2 * (rank + 1) / 4
        assert r["count"] == 6.0
