"""Command line of the offline analysis plots (port of
``scripts/viz_analysis.py``, over ``mrcc_tpu_torch.viz``; the pictures
need matplotlib, imported where one is drawn).

  python -m mrcc_tpu_torch.tools.viz_analysis errors --results r.json \
      --splits s.json
  python -m mrcc_tpu_torch.tools.viz_analysis conf --results r.json
  python -m mrcc_tpu_torch.tools.viz_analysis embed --embeddings e.npy \
      --labels l.json
"""

import argparse
import json

import numpy as np

from ..viz import confidence_plots, embedding_export, error_histograms


def main(argv=None):
    """Returns what the subcommand's function returned."""
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("errors")
    e.add_argument("--results", required=True)
    e.add_argument("--splits", required=True)
    e.add_argument("--out", default="error_histograms.png")

    c = sub.add_parser("conf")
    c.add_argument("--results", required=True)
    c.add_argument("--out", default="confidence_plots.png")

    m = sub.add_parser("embed")
    m.add_argument("--embeddings", required=True, help=".npy [N, D]")
    m.add_argument("--labels", required=True, help="JSON list of N labels")
    m.add_argument("--log_dir", default="projector")

    args = p.parse_args(argv)
    if args.cmd == "errors":
        curves = error_histograms(args.results, args.splits, args.out)
        print(json.dumps(curves))
        return curves
    if args.cmd == "conf":
        series = confidence_plots(args.results, args.out)
        print(f"wrote {args.out} ({len(series)} pairs)")
        return series
    with open(args.labels) as f:
        labels = json.load(f)
    paths = embedding_export(np.load(args.embeddings), labels, args.log_dir)
    print("wrote", *paths)
    return paths


if __name__ == "__main__":
    main()
