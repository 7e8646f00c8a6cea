"""Error histograms, confidence plots, embedding projector export (port
of ``mrcc_tpu/viz/analysis.py``).  ``matplotlib`` is imported inside the
plotting functions (Agg backend).

Parity targets:
- visualization/error_histograms.py — per-metric means binned by
  arm_point_count from a results JSON + splits JSON.
- visualization/viz_conf.py — confidence-vs-error scatter pairs.
- visualization/embedding.py — TensorBoard-projector embedding export
  (rewritten as plain vectors.tsv + metadata.tsv, which the projector
  loads directly; no TF1 checkpoint machinery needed).
"""

from __future__ import annotations

import json
import os

import numpy as np

ERROR_BINS = (1000, 2000, 5000, 10000, 20000, 30000, 40000, 50000, 60000)
ERROR_CATEGORIES = ("dist_position", "dist_orientation", "angle_diff")
CONF_PAIRS = (
    ("position_confidence", "dist_position"),
    ("orientation_confidence", "dist_orientation"),
    ("orientation_confidence", "angle_diff"),
    ("confidence", "dist"),
)


def _agg(fig_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(fig_path) or ".", exist_ok=True)
    return plt


def error_histograms(results, splits, out_png, bins=ERROR_BINS,
                     categories=ERROR_CATEGORIES):
    """Mean error per arm-point-count bin (error_histograms.py:26-46).

    Args:
      results: {instance_key: {metric: value}} dict or path to JSON.
      splits: {split: [{filepath, position, arm_point_count, ...}]} dict or
        path to JSON (instance key = "{position}/{basename(filepath)}").
    Returns {category: [mean per bin]} and writes the figure.
    """
    if isinstance(results, str):
        with open(results) as f:
            results = json.load(f)
    if isinstance(splits, str):
        with open(splits) as f:
            splits = json.load(f)

    meta = {}
    for split in splits.values():
        meta.update({
            f"{s['position']}/{os.path.basename(s['filepath'])}": s
            for s in split})

    binned = {c: {b: [] for b in bins} for c in categories}
    for key, res in results.items():
        count = meta.get(key, {}).get("arm_point_count", 0)
        fitting = [b for b in bins if b > count]
        b = min(fitting) if fitting else bins[-1]
        for c in categories:
            if c in res:
                binned[c][b].append(res[c])

    curves = {c: [float(np.mean(v)) if v else 0.0
                  for v in binned[c].values()] for c in categories}

    plt = _agg(out_png)
    fig, axes = plt.subplots(1, len(categories), figsize=(5 * len(categories),
                                                          3.5))
    for ax, c in zip(np.atleast_1d(axes), categories):
        ax.plot(bins, curves[c], marker="o")
        ax.set_xlabel("# arm points")
        ax.set_ylabel(c)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return curves


def confidence_plots(results, out_png, pairs=CONF_PAIRS):
    """Confidence-vs-error scatter grid (viz_conf.py:35-60).

    Returns {(conf_key, err_key): (conf array, err array)} for pairs with
    data and writes the figure.
    """
    if isinstance(results, str):
        with open(results) as f:
            results = json.load(f)

    series = {}
    for conf_k, err_k in pairs:
        xs, ys = [], []
        for res in results.values():
            if conf_k in res and err_k in res:
                xs.append(res[conf_k])
                ys.append(res[err_k])
        if xs:
            series[(conf_k, err_k)] = (np.asarray(xs), np.asarray(ys))

    plt = _agg(out_png)
    n = max(len(series), 1)
    fig, axes = plt.subplots(1, n, figsize=(4.5 * n, 3.5))
    for ax, ((conf_k, err_k), (xs, ys)) in zip(np.atleast_1d(axes),
                                               series.items()):
        ax.scatter(xs, ys, s=6, alpha=0.6)
        ax.set_xlabel(conf_k)
        ax.set_ylabel(err_k)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return series


def embedding_export(embeddings, labels, log_dir, sprite=None):
    """TensorBoard-projector export (embedding.py:16-56, modernized).

    Writes ``vectors.tsv`` (one embedding per line) and ``metadata.tsv``
    (Index/Label header) — the format projector.tensorflow.org and
    TensorBoard's projector plugin load directly.
    """
    if hasattr(embeddings, "detach"):
        embeddings = embeddings.detach().cpu().numpy()
    embeddings = np.asarray(embeddings)
    labels = list(labels)
    assert len(embeddings) == len(labels)
    os.makedirs(log_dir, exist_ok=True)
    vec_path = os.path.join(log_dir, "vectors.tsv")
    meta_path = os.path.join(log_dir, "metadata.tsv")
    np.savetxt(vec_path, embeddings, delimiter="\t", fmt="%.6g")
    with open(meta_path, "w") as f:
        f.write("Index\tLabel\n")
        for i, label in enumerate(labels):
            f.write(f"{i}\t{label}\n")
    return vec_path, meta_path
