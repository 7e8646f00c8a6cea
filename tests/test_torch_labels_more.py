"""The port's geometric labels vs the JAX package's (``data/labels.py``,
numpy on both sides): on EE crops of synthetic scenes and on whole scenes
from seeds, every function gives the same integers and the same floats
bit for bit.

- ``get_roi_mask`` with and without an offset;
- ``get_ee_idx`` with the default EE box, the dataset's geometric box and
  an arm-index filter;
- ``dists_to_line_np``, ``select_closest_points_to_line`` (with a count
  and without) and ``get_ee_cross_section_idx``;
- ``get_key_points`` (10 keypoints) and ``get_6_key_points``, also on a
  crop that shows only the back of the EE;
- ``collect_closest_points``;
- ``farthest_point_sample_idx`` from a seed and from a start index;
- the templates ``KEY_POINTS_10`` / ``KEY_POINTS_6`` and
  ``EE_DIM_DEFAULT``.
"""

import numpy as np
import pytest

from mrcc_tpu.data import labels as jax_labels
from mrcc_tpu_torch.data import labels
from mrcc_tpu_torch.data.synthetic import generate_sample

SEEDS = [50, 51, 53]
SAMPLE_KW = dict(n_ee=1500, n_arm=800, n_bg=800)


def _scene(seed):
    s = generate_sample(seed=seed, **SAMPLE_KW)
    pose = s["pose"].astype(np.float32)
    pose = np.concatenate([pose[:3], pose[6:7], pose[3:6]])  # -> WXYZ
    return s["points"], s["labels"], pose


def _crop(seed):
    points, lab, pose = _scene(seed)
    return points[lab == 2], pose


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_templates_match():
    _equal(labels.KEY_POINTS_10, jax_labels.KEY_POINTS_10)
    _equal(labels.KEY_POINTS_6, jax_labels.KEY_POINTS_6)
    assert labels.EE_DIM_DEFAULT == jax_labels.EE_DIM_DEFAULT


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [{}, dict(min_x=-0.2, max_x=0.3, min_z=0.8,
                                         offset=0.13)])
def test_roi_mask(seed, kw):
    points, _, _ = _scene(seed)
    got = labels.get_roi_mask(points, **kw)
    _equal(got, jax_labels.get_roi_mask(points, **kw))
    if kw:
        assert 0 < got.sum() < len(points)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["default", "geometric", "arm"])
def test_ee_idx(seed, case):
    points, lab, pose = _scene(seed)
    kw = {}
    if case != "default":
        kw["ee_dim"] = {"min_z": -0.0, "max_z": 0.13, "min_x": -0.05,
                        "max_x": 0.05, "min_y": -0.14, "max_y": 0.14}
    if case == "arm":  # a scene whose EE points are labelled arm
        kw["arm_idx"] = np.where(lab > 0)[0]
    got = labels.get_ee_idx(points, pose, **kw)
    _equal(got, jax_labels.get_ee_idx(points, pose, **kw))
    assert len(got) > 100


@pytest.mark.parametrize("seed", SEEDS)
def test_line_distances(seed):
    ee, pose = _crop(seed)
    a, b = np.array([-0.05, 0, 0.0]), np.array([0.05, 0, 0.0])
    local = (ee - pose[:3]) @ labels.quat_to_matrix_np(pose[3:7])
    _equal(labels.dists_to_line_np(local, a, b),
           jax_labels.dists_to_line_np(local, a, b))
    for kw in (dict(count=32, cutoff=0.004), dict(), dict(count=5000)):
        got = labels.select_closest_points_to_line(local, a, b, **kw)
        _equal(got, jax_labels.select_closest_points_to_line(local, a, b,
                                                             **kw))
    got = labels.get_ee_cross_section_idx(ee, pose)
    _equal(got, jax_labels.get_ee_cross_section_idx(ee, pose))
    assert 0 < len(got[1]) <= 32


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("view", ["crop", "back"])
def test_key_points(seed, view):
    ee, pose = _crop(seed)
    if view == "back":  # only the points behind the EE's front plate
        local = (ee - pose[:3]) @ labels.quat_to_matrix_np(pose[3:7])
        ee = ee[local[:, 0] < -0.005]
    got = labels.get_key_points(ee, pose)
    _equal(got, jax_labels.get_key_points(ee, pose))
    got6 = labels.get_6_key_points(ee, pose)
    _equal(got6, jax_labels.get_6_key_points(ee, pose))
    if view == "crop":
        assert (got[1] >= 0).sum() >= 4 and (got6[1] >= 0).sum() >= 2


@pytest.mark.parametrize("seed", SEEDS)
def test_collect_closest_points(seed):
    ee, pose = _crop(seed)
    _, idx = labels.get_6_key_points(ee, pose)
    idx = idx[idx > -1]
    got = labels.collect_closest_points(idx, ee)
    _equal(got, jax_labels.collect_closest_points(idx, ee))
    assert len(got[1]) > len(idx)


@pytest.mark.parametrize("kw", [dict(seed=3), dict(start_idx=17)])
def test_farthest_point_sample(kw):
    ee, _ = _crop(SEEDS[0])
    got = labels.farthest_point_sample_idx(ee, 64, **kw)
    _equal(got, jax_labels.farthest_point_sample_idx(ee, 64, **kw))
    assert len(np.unique(got)) == 64
