"""The YAML ``Config`` (port of ``mrcc_tpu/config/config.py``): the
reference's command line (``--config --log_path --exp_path --override``),
the YAML schema (MODE / PARAM / GENERAL / DATA / STRUCTURE / TRAIN / TEST /
INFERENCE), the recursive override merge, attribute access, ``cfg()`` for
the raw dict, ``save()`` into the experiment directory, and the bridges to
the port's dataclass configs.

The defaults are ``config/default.py`` (the JAX package's
``default.yaml`` as a dict), so a ``Config`` with no YAML path needs no
PyYAML; ``yaml`` is imported only where a YAML file is read.  The nine
override files are the port's own copies under ``config/overrides/``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
from types import SimpleNamespace

from .default import DEFAULTS

# the name the defaults carry: exp_name_of and save() use it
DEFAULT_CONFIG = "default.yaml"
OVERRIDES_DIR = os.path.join(os.path.dirname(__file__), "overrides")


def _load_yaml(path):
    try:
        import yaml
    except ImportError as e:  # the defaults need none
        raise ImportError(f"reading {path} needs PyYAML (the 'yaml' "
                          "package)") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _to_namespace(d):
    if isinstance(d, dict):
        return SimpleNamespace(**{k: _to_namespace(v) for k, v in d.items()})
    if isinstance(d, list):
        return [_to_namespace(v) for v in d]
    return d


def _merge(base: dict, override: dict):
    """Recursive dict merge (the reference's ``update_config``)."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def _norm_backbone(name):
    """Reference backbone strings to the variant names."""
    table = {"robotnet_segmentation": "minkunet", "robotnet": "minkunet",
             "robotnet_encode": "minkunet", "pointnet2": "pointnet2"}
    return table.get(name, name)


class Config:
    """Attribute-accessible config; ``cfg()`` gives the raw dict.

    ``config_path``: a YAML file, or None / ``DEFAULT_CONFIG`` for the
    defaults; ``override_paths``: YAML files merged in order; ``overrides``:
    a dict merged last."""

    def __init__(self, config_path=None, override_paths=(), overrides=None,
                 exp_path=None, log_path=None):
        self.config_path = config_path or DEFAULT_CONFIG
        if self.config_path == DEFAULT_CONFIG:
            data = copy.deepcopy(DEFAULTS)
        else:
            data = _load_yaml(self.config_path)
        self.override_paths = list(override_paths or ())
        for p in self.override_paths:
            _merge(data, _load_yaml(p))
        if overrides:
            _merge(data, copy.deepcopy(overrides))
        if exp_path:
            data["exp_path"] = exp_path
        if log_path:
            data["log_path"] = log_path
        self._data = data
        for k, v in vars(_to_namespace(data)).items():
            setattr(self, k, v)

    def __call__(self):
        """The raw dict, like the reference's ``_config()``."""
        return self._data

    @classmethod
    def from_args(cls, argv=None, default_config=None):
        """The reference's argparse surface; unknown arguments are
        ignored."""
        parser = argparse.ArgumentParser(description="mrcc_tpu_torch")
        parser.add_argument("--config", type=str,
                            default=default_config or DEFAULT_CONFIG)
        parser.add_argument("--log_path", type=str, default=None)
        parser.add_argument("--exp_path", type=str, default=None)
        parser.add_argument("--override", type=str, default=None,
                            help="comma-separated override YAML paths")
        args, _ = parser.parse_known_args(argv)
        overrides = args.override.split(",") if args.override else ()
        return cls(args.config, override_paths=overrides,
                   exp_path=args.exp_path, log_path=args.log_path)

    @property
    def exp_path(self):
        return self._data.get("exp_path", "exp/default")

    @exp_path.setter
    def exp_path(self, v):
        self._data["exp_path"] = v

    def save(self):
        """Copy the config and its overrides into ``exp_path``; the
        defaults are written as ``default.yaml`` in JSON form (which YAML
        reads)."""
        os.makedirs(self.exp_path, exist_ok=True)
        if self.config_path == DEFAULT_CONFIG:
            with open(os.path.join(self.exp_path, DEFAULT_CONFIG), "w") as f:
                json.dump(DEFAULTS, f, indent=2)
        else:
            shutil.copy(self.config_path, self.exp_path)
        for p in self.override_paths:
            shutil.copy(p, os.path.join(self.exp_path, os.path.basename(p)))

    # ---- bridges to the port's dataclass configs -----------------------

    def data_config(self):
        from ..data.dataset import DataConfig

        d = self._data.get("DATA", {})
        return DataConfig(
            scale=d.get("scale", 100),
            max_points=min(d.get("max_npoint", 65536), 262144),
            data_type=d.get("data_type", "ee_seg"),
            ignore_label=d.get("ignore_label", -100),
            classes=d.get("classes", 3),
            ee_segmentation_enabled=d.get("ee_segmentation_enabled", True),
            center_at_origin=d.get("center_at_origin", True),
            base_at_origin=d.get("base_at_origin", False),
            move_ee_to_origin=d.get("move_ee_to_origin", False),
            voxelize_position=d.get("voxelize_position", False),
            voting_enabled=d.get("voting_enabled", False),
            keypoints_enabled=d.get("keypoints_enabled", False),
            num_of_keypoints=d.get("num_of_keypoints", 6),
            use_coordinates_as_features=d.get("use_coordinates_as_features",
                                              False),
            augmentation=tuple(d.get("augmentation", ()) or ()),
            augmentation_probability=d.get("augmentation_probability", 0.2),
        )

    def train_config(self):
        """The TRAIN keys of the port's ``TrainConfig``.  The JAX bridge
        also reads ``TRAIN.conv_impl`` (its trainers' sparse-conv impl);
        the port has one route, the kernels on the device the main runs
        on, so the key is not read."""
        from ..train.trainer import TrainConfig

        t = self._data.get("TRAIN", {})
        g = self._data.get("GENERAL", {})
        d = self._data.get("DATA", {})
        return TrainConfig(
            epochs=t.get("epochs", 1300),
            lr=t.get("lr", 1e-4),
            optim=t.get("optim", "Adam"),
            momentum=t.get("momentum", 0.8),
            weight_decay=t.get("weight_decay", 1e-4),
            multiplier=t.get("multiplier", 0.8),
            step_epoch=t.get("step_epoch", 16),
            save_freq=g.get("save_freq", 4),
            batch_size=d.get("batch_size", 2),
            seed=g.get("seed", 1),
        )

    def loss_config(self):
        from ..train.losses import LossConfig, LossType

        t = self._data.get("TRAIN", {})
        s = self._data.get("STRUCTURE", {})
        return LossConfig(
            loss_type=LossType(t.get("loss_type", "cos2")),
            reduction=t.get("loss_reduction", "mean"),
            compute_confidence=s.get("compute_confidence", False),
            disable_position=s.get("disable_position", False),
            disable_orientation=s.get("disable_orientation", False),
            position_threshold=s.get("position_threshold", 0.03),
            position_ignore_threshold=s.get("position_ignore_threshold",
                                            0.05),
            angle_diff_threshold=s.get("angle_diff_threshold", 0.24),
            angle_diff_ignore_threshold=s.get("angle_diff_ignore_threshold",
                                              0.4),
            ignore_label=self._data.get("DATA", {}).get("ignore_label",
                                                        -100),
        )

    def inference_config(self):
        from ..app.inference_engine import InferenceConfig

        inf = self._data.get("INFERENCE", {})
        seg = inf.get("SEGMENTATION", {})
        rot = inf.get("ROTATION", {})
        kp = inf.get("KEY_POINTS", {})
        return InferenceConfig(
            seg_checkpoint=seg.get("checkpoint"),
            rot_checkpoint=rot.get("checkpoint"),
            kp_checkpoint=kp.get("checkpoint"),
            seg_backbone=_norm_backbone(seg.get("backbone", "minkunet")),
            seg_scale=seg.get("scale", 200),
            seg_center_at_origin=seg.get("center_at_origin", True),
            rot_backbone=_norm_backbone(rot.get("backbone", "minkunet")),
            rot_encode_only=rot.get("encode_only", True),
            rot_scale=rot.get("scale", 200),
            rot_center_at_origin=rot.get("center_at_origin", True),
            compute_confidence=self._data.get("STRUCTURE", {}).get(
                "compute_confidence", False),
            kp_backbone=_norm_backbone(kp.get("backbone", "minkunet")),
            kp_scale=kp.get("scale", 800),
            kp_center_at_origin=kp.get("center_at_origin", True),
            kp_conf_threshold=kp.get("conf_threshold", 0.75),
            num_of_keypoints=kp.get("num_of_keypoints", 6),
            kp_error_margin=kp.get("error_margin", 0.05),
            kp_sampling_method=kp.get("pointcloud_sampling_method",
                                      "uniform"),
            kp_use_coordinates_as_features=kp.get(
                "use_coordinates_as_features", False),
            num_of_dense_input_points=inf.get("num_of_dense_input_points",
                                              2048),
            ee_point_counts_threshold=inf.get("ee_point_counts_threshold",
                                              512),
            icp_enabled=inf.get("icp_enabled", True),
            sanity_min_num_of_ee_points=inf.get("SANITY", {}).get(
                "min_num_of_ee_points", 2048),
            camera_link_transformation_pose=inf.get(
                "camera_link_transformation_pose"),
            rot_flip_disambiguation=inf.get("rot_flip_disambiguation",
                                            False),
            rot_symmetry_axis=inf.get("rot_symmetry_axis", "z"),
            translation_z_percentile=inf.get("translation_z_percentile"),
            k3_self_keyed=inf.get("k3_self_keyed", True),
        )
