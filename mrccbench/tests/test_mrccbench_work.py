"""The benchmark's work counts against brute force on small clouds (CPU):
k3 hits and parent links counted from Python sets, operations and bytes
of a step summed by hand."""

import numpy as np
import pytest
import torch

from mrccbench.reference import minkunet, sparse
from mrccbench.work import counts, peaks

torch.set_num_threads(1)


def _levels(seed, caps):
    g = np.random.default_rng(seed)
    pts = torch.as_tensor(g.uniform(-0.08, 0.08, (2, 500, 3)).astype(
        np.float32))
    mask = torch.as_tensor(g.random((2, 500)) < 0.95)
    feats = torch.zeros((2, 500, 3))
    labels = torch.zeros((2, 500), dtype=torch.int32)
    level0, _, _ = sparse.voxelize(pts, feats, mask, labels, 0.01, caps[0])
    return sparse.hierarchy(level0, caps[1:], 2)


def _brute(levels):
    """k3 hits per level and parent links per transition from sets."""
    coords = [{(int(i),) + tuple(int(v) for v in o)
               for i, o in zip(lv.item, lv.off)} for lv in levels]
    hits = [sum(1 for c in cs for d in sparse.K3_OFFSETS
                if (c[0], c[1] + d[0], c[2] + d[1], c[3] + d[2]) in cs)
            for cs in coords]
    links = [sum(1 for c in fine
                 if (c[0],) + tuple(v // 2 for v in c[1:]) in coarse)
             for fine, coarse in zip(coords, coords[1:])]
    return [len(cs) for cs in coords], hits, links


@pytest.mark.parametrize("caps", [(4096, 4096, 2048, 1024, 512),
                                  (300, 120, 60, 30, 12)])
def test_hits_and_links_against_brute_force(caps):
    levels, octs = _levels(4, caps)
    st = counts.level_stats(levels, octs)
    rows, hits, links = _brute(levels)
    assert st.rows == rows
    assert st.k3_hits == hits
    assert st.links == links
    assert all(h >= r for h, r in zip(hits, rows))  # the identity offset


def test_step_work_against_hand_sums():
    st = counts.LevelStats(rows=[100, 40, 10], k3_hits=[900, 300, 50],
                           links=[90, 35])
    plan = [("a", "k3", 0, 3, 8), ("b", "down", 1, 8, 8),
            ("c", "k3", 1, 8, 16), ("d", "up", 0, 16, 4),
            ("e", "dense", 0, 4, 2)]
    got = counts.step_work(plan, st, "float32", training=True)
    fwd = [2 * 900 * 3 * 8, 2 * 90 * 8 * 8, 2 * 300 * 8 * 16,
           2 * 90 * 16 * 4, 2 * 100 * 4 * 2]
    byt = [4 * (100 * 3 + 27 * 3 * 8 + 100 * 8),
           4 * (90 * 8 + 8 * 8 * 8 + 40 * 8),
           4 * (40 * 8 + 27 * 8 * 16 + 40 * 16),
           4 * (40 * 16 + 8 * 16 * 4 + 100 * 4)]
    times = [2, 3, 3, 3, 3]
    assert got["model_ops"] == sum(t * f for t, f in zip(times, fwd))
    least = sum(t * max(f / peaks.FLOPS["float32"],
                        b / peaks.HBM_BYTES_PER_S)
                for t, f, b in zip(times, fwd, byt))
    assert got["conv_least_s"] == pytest.approx(least)
    inf = counts.step_work(plan, st, "bfloat16", training=False)
    assert inf["model_ops"] == sum(fwd)


def test_plan_of_the_benchmark_net():
    cfg = {"backbone": "minkunet18D", "in_channels": 3,
           "unet_out_channels": 256, "head_width": 1024, "num_classes": 3}
    plan = minkunet.layer_plan(cfg)
    kinds = [k for _, k, _, _, _ in plan]
    assert kinds.count("k3") == 1 + 8 * 2 * 2
    assert kinds.count("down") == 4 and kinds.count("up") == 4
    # every conv of the plan has a kernel in the parameter spec, and back
    spec = {n for n, _, _ in minkunet.parameter_spec(cfg)
            if n.endswith("kernel")}
    assert spec == {f"{n}.kernel" for n, k, _, _, _ in plan
                    if not n.startswith("regression")}
