"""ROADMAP C21's numbers: how far the port's sparse train steps sit from
the JAX steps in f32 and in float64, beside the JAX f32 step's own spread
under a 1e-7 relative move of its input colours.

For the segmentation step (self-keyed and on k3 tables) and the feature
(metric-learning) step of ``tests/test_torch_train.py`` /
``tests/test_torch_k3_train.py`` / ``tests/test_torch_featurenet.py``,
prints one JSON line each of:

- ``f64``: the port against JAX, both in float64 (the tests' setting);
- ``f32``: the port against JAX, both in f32;
- ``jax_f32_spread``: the JAX f32 step at the batch against the JAX f32
  step at its colours times ``1 + 1e-7``;

each as the largest per-tensor relative gradient gap (``grad_tensor``),
the relative gap of the whole gradient (``grad_all``) and the largest
per-tensor relative update gap where the gradient is 0 or above 1 % of
its tensor's rms (``update``), the tests' three measures.  FeatureNet's
``final.bias`` (an exact gradient of 0: it feeds a train-mode BN) is
left out of the per-tensor measures, as its test holds it by |g|.

  JAX_PLATFORMS=cpu python tests/torch_c21_spread.py
"""

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU)
from mrcc_tpu_torch.interop import jax_path  # noqa: E402
from test_torch_featurenet import feature_step_pair  # noqa: E402
from test_torch_train import segmentation_step_pair  # noqa: E402

MOVE = 1e-7
# an exact gradient of 0 (feeds a train-mode BN): noise on both sides
ZERO_GRAD = {("unet", "final", "bias")}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def jax_side(pair):
    """``{path: (gradient, update)}`` of the pair's JAX step."""
    return {k: (g, pair["jax_params"][k] - pair["jax_old"][k])
            for k, g in pair["jax_grads"].items()}


def port_side(pair):
    """``{JAX path: (gradient, update)}`` of the pair's port step."""
    port, out = pair["port"], {}
    for name, p in port.named_parameters():
        g = p.grad.numpy()
        u = (p.detach() - pair["before"][name]).numpy()
        if p.dim() == 2:
            g, u = g.T, u.T
        out[jax_path(port, name)[1]] = (g, u)
    return out


def gaps(got, want):
    """The tests' measures of ``got`` against ``want``."""
    tensor, update = 0.0, 0.0
    for k, (g_want, u_want) in want.items():
        if k in ZERO_GRAD:
            continue
        g, u = got[k]
        tensor = max(tensor, _rel(g, g_want))
        keep = (g_want == 0) | (np.abs(g_want) > 1e-2 * np.sqrt(
            np.mean(g_want ** 2)))
        update = max(update, _rel(u[keep], u_want[keep]))
    keys = sorted(want)
    return {"grad_tensor": tensor,
            "grad_all": _rel(np.concatenate([got[k][0].ravel()
                                             for k in keys]),
                             np.concatenate([want[k][0].ravel()
                                             for k in keys])),
            "update": update}


def main():
    torch.set_num_threads(4)
    steps = {
        "segmentation": lambda **kw: segmentation_step_pair(**kw),
        "segmentation_tables": lambda **kw: segmentation_step_pair(
            k3_self_keyed=False, **kw),
        "feature": feature_step_pair}
    for name, make in steps.items():
        f64 = make()
        f32 = make(float64=False)
        moved = make(float64=False, move=MOVE)
        print(json.dumps({
            "step": name,
            "f64": gaps(port_side(f64), jax_side(f64)),
            "f32": gaps(port_side(f32), jax_side(f32)),
            "jax_f32_spread": gaps(jax_side(moved), jax_side(f32)),
            "move": MOVE}), flush=True)


if __name__ == "__main__":
    main()
