"""The port's ``AliveV2Dataset`` vs the JAX package's (CPU, numpy on both
sides), over the same sample dicts (each side gets its own copy: the JAX
loader writes EE labels into the sample it is given).

- One parametrised test over ``_load_item``'s branches: ``gt_seg``;
  ``ee_seg`` with EE labels and with labels derived from the pose (a
  sample whose EE points are labelled arm); voting on EE crops and on
  whole scenes; keypoints, 6 and 10; each augmentation flag at
  probability 1 from one seed; ``base_at_origin``;
  ``use_coordinates_as_features`` with and without centring;
  ``move_ee_to_origin``; ``voxelize_position``.  Points, feats, labels,
  pose and the ``other`` offsets within 1e-6, integers exact.
- The ROI crop, from split entries with a ``position`` over pickles in
  ``tmp_path`` (``load_sample``, dict and tuple pickles).
- ``merge_split_files`` / ``filter_file`` on split JSONs.
- ``collate`` and the ``batches`` order, with an item that is None.
- ``pose_item`` / ``PoseDataset`` crop the EE by the pose where a sample
  has no EE label, as the JAX loader does (3712 points on seed 50).
"""

import copy
import dataclasses
import json
import pickle

import numpy as np
import pytest

from mrcc_tpu.data.dataset import AliveV2Dataset as JaxDataset
from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu.data.dataset import filter_file as jax_filter_file
from mrcc_tpu.data.dataset import merge_split_files as jax_merge_split_files
from mrcc_tpu_torch.data.dataset import (AliveV2Dataset, DataConfig,
                                         PoseDataset, filter_file,
                                         merge_split_files, pose_item)
from mrcc_tpu_torch.data.synthetic import generate_sample

SAMPLE_KW = dict(n_ee=1500, n_arm=800, n_bg=800)
SEEDS = (50, 51)
TOL = dict(rtol=1e-6, atol=1e-6)


def _samples(arm_ee=False, no_ee=False):
    out = []
    for seed in SEEDS:
        s = generate_sample(seed=seed, **SAMPLE_KW)
        if arm_ee:  # EE points labelled arm: the loader derives them
            s["labels"][s["labels"] == 2] = 1
        out.append(s)
    if no_ee:  # a sample with no EE and no arm: an ee_seg item is None
        s = generate_sample(seed=52, **SAMPLE_KW)
        s["labels"][:] = 0
        out.insert(1, s)
    return out


def _check_item(got, want):
    if want is None:
        assert got is None
        return
    for k in ("points", "feats", "pose"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert got["labels"].dtype == want["labels"].dtype
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["other"].keys() == want["other"].keys()
    for k, v in want["other"].items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got["other"][k], v, err_msg=k, **TOL)
        else:
            assert got["other"][k] == v, k


def _pair(samples, augment=False, files=None, **kw):
    """The port's and the JAX dataset over the same sources (pickle files,
    or a copy each of the sample dicts) and config."""
    cfg = {"max_points": 4096, **kw}

    def source():
        return (dict(files=files) if files
                else dict(samples=copy.deepcopy(samples)))

    return (AliveV2Dataset(cfg=DataConfig(**cfg), augment=augment, seed=7,
                           **source()),
            JaxDataset(cfg=JaxDataConfig(**cfg), augment=augment, seed=7,
                       **source()))


BRANCHES = {
    "gt_seg": dict(data_type="gt_seg"),
    "ee_seg": dict(),
    "ee_seg_geometric": dict(arm_ee=True),
    "scene_geometric": dict(data_type=None, arm_ee=True),
    "vote_ee_seg": dict(voting_enabled=True),
    "vote_scene": dict(voting_enabled=True, data_type=None),
    "keypoints_6": dict(keypoints_enabled=True),
    "keypoints_10": dict(keypoints_enabled=True, num_of_keypoints=10),
    "base_at_origin": dict(center_at_origin=False, base_at_origin=True),
    "coords_centred": dict(use_coordinates_as_features=True),
    "coords_uncentred": dict(use_coordinates_as_features=True,
                             center_at_origin=False),
    "move_ee_to_origin": dict(move_ee_to_origin=True),
    "voxelize_position": dict(voxelize_position=True, scale=200.0),
    # elastic with an integer scale: with a float one both raise (C23)
    **{f"augment_{flag}": dict(augmentation=(flag,), augment=True,
                               augmentation_probability=1.0, scale=100)
       for flag in ("elastic", "noise", "transform", "flip", "gravity")},
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_items_match_jax(branch):
    kw = dict(BRANCHES[branch])
    arm_ee = kw.pop("arm_ee", False)
    augment = kw.pop("augment", False)
    port, jax = _pair(_samples(arm_ee=arm_ee), augment=augment, **kw)
    for i in range(len(SEEDS)):
        got, want = port[i], jax[i]
        _check_item(got, want)
    if augment:  # the draws moved the cloud: not the unaugmented item
        plain = AliveV2Dataset(samples=_samples(), cfg=DataConfig(
            max_points=4096))[0]
        assert not np.allclose(port[0]["points"], plain["points"])
    if kw.get("voting_enabled"):
        lab = port[0]["labels"]
        assert 0 < (lab == (1 if "data_type" not in kw else 3)).sum() <= 32
    if kw.get("keypoints_enabled"):
        assert (port[0]["labels"] >= 0).sum() > 0


def test_elastic_with_a_float_scale_raises_as_in_jax():
    """ROADMAP C23: the elastic grid's size is ``abs(x).max // gran + 3``
    with ``gran = 6 * scale // 50``, a float for the default ``scale=100.0``,
    and numpy takes no float shape; ported as written."""
    for ds in _pair(_samples(), augment=True, augmentation=("elastic",),
                    augmentation_probability=1.0):
        with pytest.raises(TypeError):
            ds[0]


def test_voting_and_keypoints_exclude_each_other():
    ds = AliveV2Dataset(samples=_samples(), cfg=DataConfig(
        voting_enabled=True, keypoints_enabled=True))
    with pytest.raises(AttributeError):
        ds[0]


def test_data_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(DataConfig)] == \
        [f.name for f in dataclasses.fields(JaxDataConfig)]
    port, jax = DataConfig(), JaxDataConfig()
    for f in dataclasses.fields(DataConfig):
        assert getattr(port, f.name) == getattr(jax, f.name), f.name


def _write_pickles(tmp_path, samples):
    paths = []
    for i, s in enumerate(samples):
        path = tmp_path / f"s{i}.pickle"
        if i == 0:  # an alivev1 tuple pickle
            obj = (s["points"], s["rgb"], s["labels"], s["instance_labels"],
                   s["pose"])
        else:
            obj = s
        with open(path, "wb") as f:
            pickle.dump(obj, f)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("data_type", [None, "ee_seg"])
def test_roi_from_split_entries(tmp_path, data_type):
    paths = _write_pickles(tmp_path, _samples())
    files = [{"filepath": p, "position": "p1"} for p in paths]
    roi = {"p1": dict(min_x=-0.3, max_x=0.6, min_y=-0.5, max_y=0.5,
                      min_z=0.6, max_z=1.3)}
    port, jax = _pair(None, files=files, roi=roi, data_type=data_type)
    full = AliveV2Dataset(files=paths, cfg=DataConfig(max_points=4096,
                                                      data_type=data_type))
    for i in range(len(paths)):
        _check_item(port[i], jax[i])
        assert port[i]["other"]["position"] == "p1"
        if data_type is None:
            assert len(port[i]["points"]) < len(full[i]["points"])
    assert port[0]["other"]["joint_angles"] is None
    assert port[1]["other"]["filename"] == paths[1]


def test_split_files(tmp_path):
    names = ["a/x_1.pickle", "a/x_1_semantic.pickle", "a/x_2_eemask.pickle",
             "a/dark_3.pickle", "b/y_4.pickle", "b/x_5.pickle"]
    splits = []
    for k in range(2):
        path = tmp_path / f"split{k}.json"
        path.write_text(json.dumps({
            "train": [{"filepath": n, "position": f"p{k}"}
                      for n in names[k::2]],
            "test": [{"filepath": names[0]}]}))
        splits.append(str(path))
    for paths in (",".join(splits), splits):
        for kw in (dict(), dict(prefix="x_"), dict(split="test")):
            got = merge_split_files(paths, **kw)
            assert got == jax_merge_split_files(paths, **kw)
    assert [e["filepath"] for e in merge_split_files(splits)] == \
        ["a/x_1.pickle", "b/y_4.pickle", "b/x_5.pickle"]
    for n in names:
        for prefix in ("", "x_"):
            assert filter_file(n, prefix) == jax_filter_file(n, prefix)
            assert filter_file({"filepath": n}, prefix) == \
                jax_filter_file({"filepath": n}, prefix)


def test_collate_and_batches_match_jax():
    port, jax = _pair(_samples(no_ee=True), max_points=1024)
    assert port[1] is None and jax[1] is None
    for kw in (dict(shuffle=False), dict(seed=3), dict(seed=3,
                                                       drop_last=True)):
        got = list(port.batches(2, **kw))
        want = list(jax.batches(2, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in ("points", "feats", "labels", "mask", "pose",
                      "joint_angles"):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
            assert [o["filename"] for o in g["others"]] == \
                [o["filename"] for o in w["others"]]
    # the first sample's crop is longer than 1024 rows: collate cuts it
    b = port.collate([port[0], None, port[2]])
    assert b["mask"].shape == (2, 1024) and b["mask"][0].all()


def test_pose_item_crops_the_ee_by_the_pose():
    """A sample whose EE points are labelled arm: the JAX loader crops the
    EE from the pose; so must ``pose_item`` and ``PoseDataset``."""
    sample = generate_sample(seed=50)
    sample["labels"][sample["labels"] == 2] = 1
    want = JaxDataset(samples=[copy.deepcopy(sample)],
                      cfg=JaxDataConfig())[0]
    got = pose_item(copy.deepcopy(sample), DataConfig())
    assert got is not None and len(got["points"]) == 3712
    for k in ("points", "feats", "labels", "pose"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["joint_angles"],
                                  sample["joint_angles"])
    ds = PoseDataset(DataConfig(max_points=1024), 2, seed=5, **SAMPLE_KW)
    assert len(ds) == 2 and ds.collate(ds.items)["pose"].shape == (2, 7)
