"""Render a sample pickle to PNG (port of ``scripts/viz_pickle.py``,
headless: ``--seg`` colours by the segmentation labels instead of RGB).
Needs matplotlib.

  python -m mrcc_tpu_torch.tools.viz_pickle sample.pickle out.png [--seg]
"""

import argparse

import numpy as np

from ..data.dataset import load_sample
from ..utils.visualization import SEG_COLORS, save_cloud_png


def main(argv=None):
    """Returns the PNG's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("pickle")
    ap.add_argument("out")
    ap.add_argument("--seg", action="store_true",
                    help="color by segmentation labels instead of RGB")
    args = ap.parse_args(argv)

    s = load_sample(args.pickle)
    if args.seg:
        colors = SEG_COLORS[np.clip(np.asarray(s["labels"]).astype(int), 0,
                                    2)]
    else:
        rgb = np.asarray(s["rgb"])
        colors = np.clip(rgb if rgb.max() <= 1.5 else rgb / 255.0, 0, 1)
    path = save_cloud_png(np.asarray(s["points"]), colors, args.out)
    print(path)
    return path


if __name__ == "__main__":
    main()
