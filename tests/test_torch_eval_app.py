"""``BenchmarkApp`` of the port vs the JAX package's (CPU).

The two engines share the JAX engine's weights (``load_jax_params``) and
see the same synthetic frames (2 positions x 2 frames): the runs report
the same metric names with as many values each, the same per-position
keys, a calibration on both or neither, and a report of the same kind; the
port's segmentation metrics are finite.  Numbers are not compared: the
engines run bf16 (about 1 % of labels differ between the two packages'
bf16 arithmetic, and ICP amplifies pose differences, ROADMAP C5).
"""

import jax
import numpy as np
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxInferenceConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.app import SyntheticDataEngine as JaxSynthetic
from mrcc_tpu.eval import BenchmarkApp as JaxBenchmarkApp
from mrcc_tpu_torch.app import (InferenceConfig, InferenceEngine,
                                SyntheticDataEngine)
from mrcc_tpu_torch.data.synthetic import gt_base2cam_pose
from mrcc_tpu_torch.eval import BenchmarkApp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops (the suite's parallel
    workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE = dict(point_capacity=2048, seg_voxel_capacity=1024,
              seg_hierarchy_caps=(512, 256, 128, 128),
              ee_point_capacity=512, ee_voxel_capacity=512,
              ee_hierarchy_caps=(256, 128, 128, 128), kp_voxel_capacity=512,
              kp_hierarchy_caps=(384, 256, 128, 128),
              seg_backbone="minkunet14A", rot_backbone="minkunet14A",
              kp_backbone="minkunet14A", icp_iterations=3,
              icp_template_points=128, ee_point_counts_threshold=32,
              sanity_min_num_of_ee_points=64)


def test_benchmark_app_matches_jax(tmp_path):
    frames = dict(n_positions=2, frames_per_position=2, seed=60, n_ee=400,
                  n_arm=500, n_bg=600)
    jeng = JaxEngine(JaxInferenceConfig(**ENGINE), seed=0)
    peng = InferenceEngine(InferenceConfig(**ENGINE), device="cpu")
    peng.load_jax_params(jax.device_get(jeng.params))
    got = BenchmarkApp(peng, SyntheticDataEngine(**frames),
                       gt_base2cam_pose(), n_samples=4,
                       ignore_unconfident=False).run(
        out_path=str(tmp_path / "p" / "bench.xlsx"))
    want = JaxBenchmarkApp(jeng, JaxSynthetic(**frames), gt_base2cam_pose(),
                           n_samples=4, ignore_unconfident=False).run(
        out_path=str(tmp_path / "j" / "bench.xlsx"))
    assert got["metrics"].keys() == want["metrics"].keys()
    assert {k: len(v) for k, v in got["metrics"].items()} == \
        {k: len(v) for k, v in want["metrics"].items()}
    assert got["positions"].keys() == want["positions"].keys() == {"p1",
                                                                    "p2"}
    for p in got["positions"]:
        assert got["positions"][p].keys() == want["positions"][p].keys()
    assert (got["calibration"] is None) == (want["calibration"] is None)
    assert got["table"].keys() == want["table"].keys()
    assert got["report"].rsplit(".", 1)[1] == want["report"].rsplit(".", 1)[1]
    assert all(np.isfinite(v).all() for k, v in got["metrics"].items()
               if k.startswith("seg_"))
