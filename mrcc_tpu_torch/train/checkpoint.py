"""Checkpoint save / restore with the reference's naming and retention
(port of ``mrcc_tpu/train/checkpoint.py``, after ``utils/utils.py:62-126``).

Files are named ``{exp_name}-%09d.ckpt`` per epoch; restore picks the
latest by sorted glob; saving epoch e deletes epoch e - 1's file unless
e - 1 is a power of two or a ``save_freq`` multiple.

Format: the port's own — ``torch.save`` of ``{"model": state_dict,
"optimizer": state_dict, "epoch": int}``.  The read side also takes the
JAX package's checkpoints (msgpack ``TrainState`` files, also named
``.ckpt``): :func:`checkpoint_format` tells the two apart by the first
bytes, :func:`load_stage_variables` reads a JAX one.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import torch

from .msgpack_io import msgpack_restore


def is_power2(num: int) -> bool:
    return num != 0 and ((num & (num - 1)) == 0)


def is_multiple(num: int, multiple: int) -> bool:
    return num != 0 and num % multiple == 0


def _path(exp_path: str, exp_name: str, epoch: int) -> str:
    return os.path.join(exp_path, f"{exp_name}-{epoch:09d}.ckpt")


def checkpoint_save(model, optimizer, exp_path: str, exp_name: str,
                    epoch: int, save_freq: int = 16) -> str:
    """Save model and optimizer state at ``epoch``; prune the previous
    epoch's file unless it is a power of two or a save_freq multiple."""
    os.makedirs(exp_path, exist_ok=True)
    path = _path(exp_path, exp_name, epoch)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "epoch": int(epoch)},
               path)
    prev = epoch - 1
    if prev > 0 and not (is_multiple(prev, save_freq) or is_power2(prev)):
        prev_path = _path(exp_path, exp_name, prev)
        if os.path.isfile(prev_path):
            os.remove(prev_path)
    return path


def latest_checkpoint(exp_path: str, exp_name: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(exp_path, f"{exp_name}-*.ckpt")))
    return paths[-1] if paths else None


def checkpoint_restore(model, optimizer, exp_path: str, exp_name: str,
                       f: Optional[str] = None) -> int:
    """Load the latest checkpoint (or ``f``) into ``model`` and
    ``optimizer`` in place; returns its epoch, or 0 when there is none
    (start from scratch)."""
    path = f or latest_checkpoint(exp_path, exp_name)
    if path is None or not os.path.isfile(path):
        return 0
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])


def checkpoint_format(path: str) -> str:
    """``"torch"`` for a ``torch.save`` zip (the port trainer's files),
    ``"msgpack"`` for a msgpack map (the JAX package's), by the first bytes;
    anything else raises ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "msgpack"
    raise ValueError(f"{path}: neither a torch zip nor a msgpack map "
                     f"(first bytes {head!r})")


def load_stage_variables(path: str) -> dict:
    """The ``{"params", "batch_stats"}`` numpy tree of a JAX package
    ``TrainState`` checkpoint (``mrcc_tpu.train.checkpoint_save``), for
    ``interop.load_jax_variables``."""
    if checkpoint_format(path) != "msgpack":
        raise ValueError(f"{path}: not a JAX package checkpoint")
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    return {"params": raw["params"], "batch_stats": raw.get("batch_stats", {})}
