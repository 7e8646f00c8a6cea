"""Weight bridges into port modules: JAX-package variables, and the
reference's torch state dicts (``.pth``); :func:`load_weights` reads any
of the checkpoint files a stage or a frozen net may name.

Port modules carry the reference's state-dict names, the names
``mrcc_tpu/train/interop.py`` translates into flax paths.  This module keeps
its own copy of that translation (numpy and ``re`` only) and runs it the
other way: every port parameter and buffer takes the JAX leaf at its
translated path.  A reference state dict maps onto a port module by name
(:func:`import_state_dict`).

- conv kernels keep ``[K, Cin, Cout]``;
- dense ``kernel [in, out]`` becomes ``nn.Linear.weight [out, in]``;
- BN ``scale/bias`` (params) and ``mean/var`` (batch_stats) become
  ``bn.weight/bn.bias/bn.running_mean/bn.running_var``;
- the int8 calibration (``q8_stats`` collection, ``.../act_absmax``)
  becomes the convs' ``act_absmax`` buffers.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .sparse.nn import q8_convs
from .train.checkpoint import checkpoint_format, load_stage_variables

_RULES = [
    (re.compile(r"^module\."), ""),
    # blocks of a stage: MinkUNet ``block1.0``, ResNet ``layer1.0``,
    # AliveUNet ``enc0.1`` / ``dec0.1`` -> ``block1_0`` ... ``dec0_1``
    (re.compile(r"\b(block|layer|enc|dec)(\d+)\.(\d+)\."), r"\1\2_\3."),
    (re.compile(r"\bdownsample\.0\."), "downsample_conv."),
    (re.compile(r"\bdownsample\.1\."), "downsample_norm."),
    (re.compile(r"\boutput_layer\.0\."), "output_bn."),
    (re.compile(r"\bpose_regression\.0\."), "pose_fc1."),
    (re.compile(r"\bpose_regression\.2\."), "pose_fc2."),
    (re.compile(r"\bregression\.0\.linear\."), "regression_fc1.dense."),
    (re.compile(r"\bregression\.2\.linear\."), "regression_fc2.dense."),
    (re.compile(r"\blinear\."), "dense."),
]
# the backbone's modules, matched as a whole path component: a head's own
# module whose name starts like one (FeatureNet's ``final_bn``) stays at
# the top level (ROADMAP C22)
_BACKBONE = re.compile(r"conv0p1s1|bn[0-4]|conv[1-4]p\d+s2|block\d+_\d+"
                       r"|convtr[4-7]p\d+s2|bntr[4-7]|final")
_BN_FIELDS = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def translate_key(key: str, unet: bool = True) -> Tuple[str, tuple]:
    """Reference state-dict key -> (flax collection, flax path).  With
    ``unet``, backbone keys move under ``unet`` (the RobotNet* and
    FeatureNet wrappers' scope); the sparse ResNets and AliveUNet have no
    such scope, though their ``final`` / ``bn0`` match the backbone's
    names."""
    for pat, repl in _RULES:
        key = pat.sub(repl, key)
    m = re.match(r"^(.*)\.bn\.(weight|bias|running_mean|running_var)$", key)
    if m:
        coll, leaf = _BN_FIELDS[m.group(2)]
        coll_path = (coll, tuple(m.group(1).split(".")) + (leaf,))
    elif key.rsplit(".", 1)[-1] in ("kernel", "act_absmax"):
        coll = "q8_stats" if key.endswith("act_absmax") else "params"
        coll_path = (coll, tuple(key.split(".")))
    else:
        m = re.match(r"^(.*)\.(weight|bias)$", key)
        if m:
            leaf = "kernel" if m.group(2) == "weight" else "bias"
            coll_path = ("params", tuple(m.group(1).split(".")) + (leaf,))
        else:
            coll_path = ("params", tuple(key.split(".")))
    coll, path = coll_path
    if unet and _BACKBONE.fullmatch(path[0]):
        path = ("unet",) + path
    return coll, path


def jax_path(module: nn.Module, name: str) -> Tuple[str, tuple]:
    """A port tensor's ``(collection, path)`` in the JAX variables of
    ``module``: :func:`translate_key` under the module's ``jax_scope``
    (``RobotNetVote``'s ``seg``), with the ``unet`` prefix unless the
    module sets ``jax_unet = False`` (the sparse ResNets, AliveUNet)."""
    coll, path = translate_key(name, getattr(module, "jax_unet", True))
    return coll, tuple(getattr(module, "jax_scope", ())) + path


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _q8_buffers(module: nn.Module, flat) -> None:
    """Give each int8-capable conv an ``act_absmax`` buffer when the JAX
    variables hold a ``q8_stats`` collection, and none when they do not
    (the strict check below then covers the calibration too)."""
    calibrated = any(c == "q8_stats" for c, _ in flat)
    for _, conv in q8_convs(module):
        conv.act_absmax = (torch.zeros(conv.kernel.shape[1],
                                       device=conv.kernel.device)
                           if calibrated else None)


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Load a JAX stage's variables (``{"params": ..., "batch_stats": ...,
    "q8_stats": ...}`` as nested numpy dicts; ``q8_stats`` only once
    calibrated) into ``module``, strictly both ways: every port parameter
    and buffer is assigned, and every JAX leaf is used."""
    flat = {(c, p): v for c in ("params", "batch_stats", "q8_stats")
            for p, v in _flatten(dict(variables.get(c, {}))).items()}
    _q8_buffers(module, flat)
    used = set()
    errors = []
    state = module.state_dict()
    with torch.no_grad():
        for name, tensor in state.items():
            coll, path = jax_path(module, name)
            arr = flat.get((coll, path))
            if arr is None:
                errors.append(f"{name} -> {coll}:{'/'.join(path)} missing")
                continue
            arr = np.array(arr, dtype=np.float32)  # writable copy
            if arr.ndim == 2 and tensor.dim() == 2:
                arr = arr.T   # flax Dense [in, out] -> nn.Linear [out, in]
            if tuple(arr.shape) != tuple(tensor.shape):
                errors.append(f"{name}: shape {arr.shape} != "
                              f"{tuple(tensor.shape)}")
                continue
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            used.add((coll, path))
    errors += [f"JAX leaf {c}:{'/'.join(p)} unused" for c, p in flat
               if (c, p) not in used]
    if errors:
        raise KeyError("weight bridge is not one to one:\n  "
                       + "\n  ".join(errors[:20]))
    return module


def _bare_key(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def import_state_dict(module: nn.Module, state_dict, k_perm=None,
                      strict: bool = True) -> nn.Module:
    """Load a reference (MinkowskiEngine) state dict into ``module`` by
    name (the counterpart of ``mrcc_tpu/train/interop.py::
    import_state_dict``).

    - a ``module.`` prefix (DataParallel) is dropped and
      ``num_batches_tracked`` skipped;
    - ME stores k=1 conv kernels 2-D ``[Cin, Cout]``: they become
      ``[1, Cin, Cout]``;
    - ``k_perm`` ([K]) reorders the leading axis of the conv kernels of K
      taps (ME's kernel-offset order into ``K3_OFFSETS`` or
      ``K2_OFFSETS``).

    Strict by default, both ways: a key with no port tensor of its shape
    and a port tensor that no key wrote each raise ``KeyError``.
    """
    target = module.state_dict()
    perm = None if k_perm is None else torch.as_tensor(np.asarray(k_perm))
    assigned, errors = set(), []
    with torch.no_grad():
        for key, val in state_dict.items():
            name = _bare_key(str(key))
            if name.endswith("num_batches_tracked"):
                continue
            tensor = target.get(name)
            if tensor is None:
                errors.append(f"{key}: no port tensor")
                continue
            arr = torch.as_tensor(val).detach().cpu()
            if arr.dim() == 2 and tensor.dim() == 3 and tensor.shape[0] == 1:
                arr = arr[None]
            if perm is not None and arr.dim() == 3 and len(arr) == len(perm):
                arr = arr[perm]
            if tuple(arr.shape) != tuple(tensor.shape):
                errors.append(f"{key}: shape {tuple(arr.shape)} != "
                              f"{tuple(tensor.shape)}")
                continue
            tensor.copy_(arr.to(tensor.dtype))
            assigned.add(name)
    errors += [f"{n}: no key wrote it" for n in target if n not in assigned]
    if errors and strict:
        raise KeyError("state dict is not one to one with the module:\n  "
                       + "\n  ".join(errors[:20]))
    return module


def import_pth_variables(module: nn.Module, path: str, k_perm=None,
                         strict: bool = True) -> nn.Module:
    """Load a reference ``.pth`` file into ``module``: the reference's
    ``{"model_state_dict": ...}`` wrapper or a bare state dict."""
    try:
        # .pth files come from outside: the weights-only loader refuses
        # pickled code
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # legacy pickles (e.g. wrapped in custom classes) need the full
        # loader, reached only after the safe one refused the file
        blob = torch.load(path, map_location="cpu", weights_only=False)
    state = (blob.get("model_state_dict", blob) if isinstance(blob, dict)
             else blob)
    return import_state_dict(module, state, k_perm=k_perm, strict=strict)


def load_weights(module: nn.Module, path: str) -> nn.Module:
    """Trained weights into ``module``, strictly: a reference ``.pth``
    state dict by name, else by the file's first bytes a JAX package
    checkpoint (msgpack ``TrainState``) or the port trainer's ``.ckpt``."""
    if path.endswith(".pth"):
        return import_pth_variables(module, path)
    if checkpoint_format(path) == "msgpack":
        return load_jax_variables(module, load_stage_variables(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state["model"], strict=True)
    return module
