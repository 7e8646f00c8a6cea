"""The port's YAML ``Config`` vs the JAX package's (CPU, no model).

- the port's defaults dict equals ``yaml.safe_load`` of the JAX package's
  ``config/default.yaml``;
- each of the nine override files is the JAX file's text, and merges to
  the same ``cfg()`` in both packages;
- ``from_args`` and ``save`` (the defaults written as ``default.yaml`` in
  JSON form, which YAML reads back to the same dict);
- each bridge (``data_config``, ``train_config``, ``loss_config``,
  ``inference_config``) carries, field by field, the JAX bridge's values
  for the defaults and every override (``TrainConfig.conv_impl`` is the JAX
  trainers' impl switch, which the port has no counterpart of).
"""

import dataclasses
import enum
import os

import pytest
import yaml

from mrcc_tpu.config import Config as JaxConfig
from mrcc_tpu.config.config import DEFAULT_CONFIG as JAX_DEFAULT
from mrcc_tpu_torch.config import OVERRIDES_DIR, Config
from mrcc_tpu_torch.config.default import DEFAULTS

JAX_OVERRIDES = os.path.join(os.path.dirname(JAX_DEFAULT), "overrides")
NAMES = sorted(os.listdir(JAX_OVERRIDES))


def test_defaults_equal_the_yaml():
    with open(JAX_DEFAULT) as f:
        assert DEFAULTS == yaml.safe_load(f)
    cfg = Config()
    assert cfg() == JaxConfig()()
    assert cfg.DATA.classes == 3 and cfg.MODE == "train"
    assert cfg() is not DEFAULTS  # a copy: merging leaves the module alone


def test_override_files_are_the_jax_files():
    assert sorted(os.listdir(OVERRIDES_DIR)) == NAMES and len(NAMES) == 9
    for name in NAMES:
        with open(os.path.join(OVERRIDES_DIR, name)) as a, \
                open(os.path.join(JAX_OVERRIDES, name)) as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("name", NAMES)
def test_override_merges_like_jax(name, tmp_path):
    cfg = Config(override_paths=[os.path.join(OVERRIDES_DIR, name)],
                 exp_path=str(tmp_path / "exp"))
    want = JaxConfig(override_paths=[os.path.join(JAX_OVERRIDES, name)],
                     exp_path=str(tmp_path / "exp"))
    assert cfg() == want()
    assert cfg.exp_path == want.exp_path


def test_from_args_and_save(tmp_path):
    extra = tmp_path / "extra.yaml"
    extra.write_text("DATA:\n  scale: 999\nTRAIN:\n  lr: 0.5\n")
    argv = ["--exp_path", str(tmp_path / "exp"), "--override",
            f"{os.path.join(OVERRIDES_DIR, 'override_vote.yaml')},{extra}",
            "--log_path", str(tmp_path / "x.log"), "--unknown", "1"]
    cfg = Config.from_args(argv)
    want = JaxConfig.from_args(argv)
    assert cfg() == want()
    assert cfg()["DATA"]["scale"] == 999 and cfg.DATA.voting_enabled
    cfg.save()
    saved = tmp_path / "exp" / "default.yaml"
    assert yaml.safe_load(saved.read_text()) == DEFAULTS
    assert (tmp_path / "exp" / "override_vote.yaml").exists()
    assert (tmp_path / "exp" / "extra.yaml").exists()
    # a saved config reloads as a YAML config
    again = Config(str(saved), override_paths=cfg.override_paths,
                   exp_path=cfg.exp_path, log_path=str(tmp_path / "x.log"))
    assert again() == cfg()


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.value if isinstance(v, enum.Enum) else v
    return out


@pytest.mark.parametrize("name", [None] + NAMES)
def test_bridges_carry_the_jax_values(name, tmp_path):
    paths = [] if name is None else [name]
    cfg = Config(override_paths=[os.path.join(OVERRIDES_DIR, p)
                                 for p in paths])
    want = JaxConfig(override_paths=[os.path.join(JAX_OVERRIDES, p)
                                     for p in paths])
    for bridge in ("data_config", "train_config", "loss_config",
                   "inference_config"):
        got = _fields(getattr(cfg, bridge)())
        ref = _fields(getattr(want, bridge)())
        if bridge == "train_config":
            assert ref.pop("conv_impl") == "auto"
        for k, v in ref.items():
            if k in got:
                assert got[k] == v, (bridge, k)
        # every JAX field the bridge sets has a port field
        missing = set(ref) - set(got)
        assert not missing, (bridge, missing)
