"""Weight bridge: JAX-package variables -> port modules.

Port modules carry the reference's state-dict names, the names
``mrcc_tpu/train/interop.py`` translates into flax paths.  This module keeps
its own copy of that translation (numpy and ``re`` only) and runs it the
other way: every port parameter and buffer takes the JAX leaf at its
translated path.

- conv kernels keep ``[K, Cin, Cout]``;
- dense ``kernel [in, out]`` becomes ``nn.Linear.weight [out, in]``;
- BN ``scale/bias`` (params) and ``mean/var`` (batch_stats) become
  ``bn.weight/bn.bias/bn.running_mean/bn.running_var``.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

_RULES = [
    (re.compile(r"^module\."), ""),
    (re.compile(r"\bblock(\d+)\.(\d+)\."), r"block\1_\2."),
    (re.compile(r"\bdownsample\.0\."), "downsample_conv."),
    (re.compile(r"\bdownsample\.1\."), "downsample_norm."),
    (re.compile(r"\boutput_layer\.0\."), "output_bn."),
    (re.compile(r"\bpose_regression\.0\."), "pose_fc1."),
    (re.compile(r"\bpose_regression\.2\."), "pose_fc2."),
    (re.compile(r"\bregression\.0\.linear\."), "regression_fc1.dense."),
    (re.compile(r"\bregression\.2\.linear\."), "regression_fc2.dense."),
    (re.compile(r"\blinear\."), "dense."),
]
_BACKBONE_PREFIXES = ("conv0p1s1", "bn0", "conv1p1s2", "bn1", "conv2p2s2",
                      "bn2", "conv3p4s2", "bn3", "conv4p8s2", "bn4", "block",
                      "convtr", "bntr", "final")
_BN_FIELDS = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def translate_key(key: str) -> Tuple[str, tuple]:
    """Reference state-dict key -> (flax collection, flax path).  Backbone
    keys move under ``unet`` (the RobotNet* wrappers' scope)."""
    for pat, repl in _RULES:
        key = pat.sub(repl, key)
    m = re.match(r"^(.*)\.bn\.(weight|bias|running_mean|running_var)$", key)
    if m:
        coll, leaf = _BN_FIELDS[m.group(2)]
        coll_path = (coll, tuple(m.group(1).split(".")) + (leaf,))
    elif key.endswith(".kernel"):
        coll_path = ("params", tuple(key.split(".")))
    else:
        m = re.match(r"^(.*)\.(weight|bias)$", key)
        if m:
            leaf = "kernel" if m.group(2) == "weight" else "bias"
            coll_path = ("params", tuple(m.group(1).split(".")) + (leaf,))
        else:
            coll_path = ("params", tuple(key.split(".")))
    coll, path = coll_path
    if path[0].startswith(_BACKBONE_PREFIXES):
        path = ("unet",) + path
    return coll, path


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Load a JAX stage's variables (``{"params": ..., "batch_stats": ...}``
    as nested numpy dicts) into ``module``, strictly both ways: every port
    parameter and buffer is assigned, and every JAX leaf is used."""
    flat = {(c, p): v for c in ("params", "batch_stats")
            for p, v in _flatten(dict(variables.get(c, {}))).items()}
    used = set()
    errors = []
    state = module.state_dict()
    with torch.no_grad():
        for name, tensor in state.items():
            coll, path = translate_key(name)
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
