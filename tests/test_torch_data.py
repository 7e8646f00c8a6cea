"""The port's data items vs the JAX package's ``AliveV2Dataset`` (CPU).

``SceneDataset`` (segmentation scenes) and ``pose_item`` run the same
colour rescue as ``AliveV2Dataset._load_item`` (min-max into [0, 1] where a
colour is negative, then centred to [-0.5, 0.5]) and centre the points;
the items' ``feats``, ``points`` and ``labels`` are exactly equal.
"""

import numpy as np
import pytest

from mrcc_tpu.data.dataset import AliveV2Dataset
from mrcc_tpu.data.dataset import DataConfig as JaxDataConfig
from mrcc_tpu_torch.data.dataset import DataConfig, SceneDataset, pose_item
from mrcc_tpu_torch.data.synthetic import generate_sample

SAMPLE_KW = dict(n_ee=200, n_arm=250, n_bg=250)


def test_scene_items_match_alivev2():
    port = SceneDataset(DataConfig(data_type=None), 2, seed=3, **SAMPLE_KW)
    ref = AliveV2Dataset(
        samples=[generate_sample(seed=3 + i, **SAMPLE_KW) for i in range(2)],
        cfg=JaxDataConfig(data_type=None))
    for i, got in enumerate(port.items):
        want = ref[i]
        for k in ("feats", "points", "labels"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["feats"].min() >= -0.5 and got["feats"].max() <= 0.5


@pytest.mark.parametrize("data_type", [None, "ee_seg"])
def test_pose_item_colour_rescue_matches_alivev2(data_type):
    """Colours with negative values take the min-max branch first."""
    sample = generate_sample(seed=8, **SAMPLE_KW)
    sample["rgb"] = sample["rgb"] * 2.0 - 0.7
    got = pose_item(dict(sample), DataConfig(data_type=data_type))
    want = AliveV2Dataset(samples=[sample],
                          cfg=JaxDataConfig(data_type=data_type))[0]
    for k in ("feats", "points", "labels", "pose"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["feats"].min() == -0.5
