"""``python -m mrcc_tpu_torch.cli <main> [--config X.yaml] [--override
A.yaml,B.yaml] [--exp_path DIR] [--log_path FILE] [--device cpu]``: the
port's counterpart of the JAX package's root scripts (``test.py``,
``test_segmentation.py``, ``train.py``, ...).  The mains run on the card
unless ``--device cpu``."""

from __future__ import annotations

import argparse
import sys

from ..config import Config
from . import test_mains, train_mains

MAINS = {
    # test / evaluation mains
    "test": test_mains.test_pose,
    "test_segmentation": test_mains.test_segmentation,
    "test_key_points": test_mains.test_key_points,
    "test_vote": test_mains.test_vote,
    "test_feature_extractor": test_mains.test_feature_extractor,
    "app_test": test_mains.test_app,
    # trainers
    "train": train_mains.train_pose,
    "train_segmentation": train_mains.train_segmentation,
    "train_vote": train_mains.train_vote,
    "train_key_points": train_mains.train_key_points,
    "train_kp_to_pose": train_mains.train_kp_to_pose,
    "train_feature_extractor": train_mains.train_feature_extractor,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="python -m mrcc_tpu_torch.cli")
    parser.add_argument("main", choices=sorted(MAINS))
    parser.add_argument("--device", default=None)
    args, rest = parser.parse_known_args(argv)
    return MAINS[args.main](Config.from_args(rest), device=args.device)


if __name__ == "__main__":
    main()
