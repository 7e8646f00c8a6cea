"""The segmentation stage on one scene (port of
``playground/play_segmentation.py``): a recorded pickle where a path is
given, else a synthetic scene, through ``InferenceEngine`` at its default
configuration (random weights, or ``--checkpoint`` for the seg net: a
reference ``.pth``, a JAX package checkpoint or the port trainer's
``.ckpt``), with the point capacity the scene's size rounded up to a power
of two.  Prints the per-class point counts, the EE crop size, the overflow
flag and the NN pose, and writes a snapshot PNG painted by class (needs
matplotlib).

The JAX script unpacks three of the five values ``InferenceEngine._pad``
returns and stops there (ROADMAP C37); this tool predicts on the padded
batch as the engine's own callers do.

  python -m mrcc_tpu_torch.tools.play_segmentation [cloud.pickle] \
      [--snapshot seg.png] [--checkpoint ckpt] [--device cpu]
"""

import argparse

import numpy as np

from ..app import InferenceConfig, InferenceEngine
from ..data.dataset import load_sample
from ..data.synthetic import generate_sample

CLASS_COLORS = np.array([[0.7, 0.7, 0.7],   # background
                         [0.2, 0.4, 1.0],   # arm
                         [1.0, 0.2, 0.2]])  # EE


def load_scene(path):
    """``(points, rgb)`` f32 of a pickle, or of synthetic scene 3."""
    data = load_sample(path) if path else generate_sample(seed=3)
    return (np.asarray(data["points"], np.float32),
            np.asarray(data["rgb"], np.float32))


def main(argv=None):
    """Returns ``{"segmentation": [n] labels, "engine": the engine,
    "out": predict_batch_arrays' outputs}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--snapshot", default="playground_seg.png")
    ap.add_argument("--checkpoint", default=None,
                    help="seg weights (default: random init, structure "
                         "only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    points, rgb = load_scene(args.path)
    n = len(points)
    cfg = InferenceConfig(point_capacity=1 << int(np.ceil(np.log2(n))),
                          seg_checkpoint=args.checkpoint)
    engine = InferenceEngine(cfg, device=args.device, seed=0)

    pts, cols, mask, _, _ = engine._pad(points, rgb)
    out = engine.predict_batch_arrays(pts, cols, mask)
    seg = out["segmentation"][0, :n].cpu().numpy()

    uniq, counts = np.unique(seg, return_counts=True)
    print("per-class voxel->point counts:",
          {int(u): int(c) for u, c in zip(uniq, counts)})
    print("EE crop size:", int(out["ee_count"][0]),
          "| overflow:", bool(out["seg_overflow"][0]))
    print("NN pose:", np.round(out["ee_pose"][0].cpu().numpy(), 4).tolist())

    from ..utils.visualization import save_cloud_png

    save_cloud_png(points, CLASS_COLORS[np.clip(seg, 0, 2)], args.snapshot)
    print("snapshot:", args.snapshot)
    return {"segmentation": seg, "engine": engine, "out": out}


if __name__ == "__main__":
    main()
