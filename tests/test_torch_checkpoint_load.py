"""Trained-checkpoint loading of the port (CPU): the JAX package's msgpack
``TrainState`` files, reference ``.pth`` state dicts and the port
trainer's ``.ckpt``.

- msgpack: each stage's variables of a JAX engine (minkunet14A, f32),
  saved by ``mrcc_tpu.train.checkpoint.checkpoint_save`` as a
  ``TrainState`` with an AdamW state, one leaf in bfloat16 and flax's
  chunk size cut so that large arrays go through its chunked form.
  ``load_stage_variables`` gives every leaf back ``np.array_equal`` (the
  bfloat16 leaf widened to float32); the reader agrees with
  ``flax.serialization.msgpack_restore`` on the whole file.
- ``.pth``: a port state dict saved bare, in the reference's
  ``{"model_state_dict": ...}`` wrapper and with a ``module.`` prefix, with
  ME's 2-D k=1 kernels and ``num_batches_tracked`` entries; ``k_perm``
  undoes a permuted kernel-offset order.
- ``.ckpt``: ``mrcc_tpu_torch.train.checkpoint_save``.

An engine built from the three paths alone gives ``torch.equal`` outputs
to one given the same weights through ``load_jax_params``.  Loading is
strict both ways (a missing and an extra key raise ``KeyError``); a
msgpack type the reader does not take raises ``ValueError``.
"""

import struct

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrcc_tpu.app import InferenceConfig as JaxConfig
from mrcc_tpu.app import InferenceEngine as JaxEngine
from mrcc_tpu.train.checkpoint import checkpoint_save as jax_checkpoint_save
from mrcc_tpu.train.trainer import TrainState
from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
from mrcc_tpu_torch.data.synthetic import build_batch
from mrcc_tpu_torch.interop import import_pth_variables, import_state_dict
from mrcc_tpu_torch.train import checkpoint_save
from mrcc_tpu_torch.train.checkpoint import (checkpoint_format,
                                             load_stage_variables)
from mrcc_tpu_torch.train.msgpack_io import msgpack_restore


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops: under the suite's
    parallel workers torch's default of a thread a core oversubscribes the
    CPU (one small engine call took 185 s at six-way contention on an
    8-core CPU, 1.8 s at one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(point_capacity=1024, seg_voxel_capacity=768, ee_point_capacity=512,
           ee_voxel_capacity=512, kp_voxel_capacity=512,
           seg_hierarchy_caps=(512, 256, 128, 64),
           ee_hierarchy_caps=(256, 128, 64, 64),
           kp_hierarchy_caps=(384, 256, 128, 64),
           seg_backbone="minkunet14A", rot_backbone="minkunet14A",
           kp_backbone="minkunet14A", icp_iterations=5,
           icp_template_points=256, compute_dtype="float32")
STAGES = ("segmentation", "rotation", "key_points")
FIELDS = dict(zip(STAGES, ("seg_checkpoint", "rot_checkpoint",
                           "kp_checkpoint")))
BF16_LEAF = ("params", "unet", "conv0p1s1", "kernel")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _bf16_widened(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def weights():
    """The JAX engine's variables per stage, with BF16_LEAF rounded to
    bfloat16 (as the msgpack files store it)."""
    params = jax.device_get(JaxEngine(JaxConfig(**CFG), seed=0).params)
    out = {}
    for stage in STAGES:
        v = {c: params[stage][c] for c in ("params", "batch_stats")}
        flat = _flat(v)
        flat[BF16_LEAF] = _bf16_widened(flat[BF16_LEAF])
        out[stage] = flat
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@pytest.fixture(scope="module")
def reference(weights):
    eng = InferenceEngine(InferenceConfig(**CFG), device="cpu", seed=5)
    return eng.load_jax_params({s: _unflat(w) for s, w in weights.items()})


@pytest.fixture(scope="module")
def files(weights, reference, tmp_path_factory, monkeypatch_module):
    """One checkpoint of every format per stage."""
    root = tmp_path_factory.mktemp("ckpt")
    # a small chunk size sends every array past 4 KiB through flax's
    # __msgpack_chunked_array__ form
    monkeypatch_module.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    out = {"msgpack": {}, "pth": {}, "ckpt": {}}
    wrappers = {"segmentation": "model_state_dict", "rotation": None,
                "key_points": "module"}
    for stage in STAGES:
        tree = _unflat(weights[stage])
        leaf = tree
        for k in BF16_LEAF[:-1]:
            leaf = leaf[k]
        leaf[BF16_LEAF[-1]] = jnp.asarray(leaf[BF16_LEAF[-1]], jnp.bfloat16)
        state = TrainState(params=tree["params"],
                           batch_stats=tree["batch_stats"],
                           opt_state=optax.adamw(1e-3).init(tree["params"]))
        out["msgpack"][stage] = jax_checkpoint_save(
            state, str(root / "jax"), stage, 3)

        model = reference.models()[stage]
        sd = _reference_state_dict(model)
        path = root / f"{stage}.pth"
        if wrappers[stage] == "model_state_dict":
            torch.save({"epoch": 7, "model_state_dict": sd}, path)
        elif wrappers[stage] == "module":
            torch.save({f"module.{k}": v for k, v in sd.items()}, path)
        else:
            torch.save(sd, path)
        out["pth"][stage] = str(path)

        opt = torch.optim.AdamW(model.parameters())
        out["ckpt"][stage] = checkpoint_save(model, opt, str(root / "port"),
                                             stage, 2)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _reference_state_dict(model):
    """A port state dict as MinkowskiEngine writes it: k=1 kernels 2-D and
    BN ``num_batches_tracked`` entries."""
    sd = {}
    for k, v in model.state_dict().items():
        v = v.clone()
        sd[k] = v[0] if v.dim() == 3 and v.shape[0] == 1 else v
        if k.endswith("bn.running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(12)
    assert any(v.dim() == 2 and k.endswith("kernel") for k, v in sd.items())
    return sd


@pytest.mark.parametrize("stage", STAGES)
def test_msgpack_leaf_by_leaf(files, weights, stage):
    path = files["msgpack"][stage]
    assert checkpoint_format(path) == "msgpack"
    got = _flat(load_stage_variables(path))
    assert set(got) == set(weights[stage])
    for k, want in weights[stage].items():
        assert got[k].dtype == np.float32, k
        assert np.array_equal(got[k], want), k
    with open(path, "rb") as f:
        raw = f.read()
    assert b"__msgpack_chunked_array__" in raw
    mine = _flat(msgpack_restore(raw))
    theirs = _flat(flax.serialization.msgpack_restore(raw))
    assert set(mine) == set(theirs)
    for k, want in theirs.items():
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        assert np.array_equal(np.asarray(mine[k]), want), k


@pytest.mark.parametrize("stage", STAGES)
def test_pth_leaf_by_leaf(files, reference, stage):
    model = InferenceEngine(InferenceConfig(**CFG), device="cpu",
                            seed=9).models()[stage]
    import_pth_variables(model, files["pth"][stage])
    want = reference.models()[stage].state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k].numpy()), k


def test_pth_k_perm(reference):
    """A file in another kernel-offset order comes back through k_perm."""
    model = reference.models()["rotation"]
    perm = np.random.default_rng(0).permutation(27)
    inv = torch.as_tensor(np.argsort(perm))
    sd = {k: v[inv] if v.dim() == 3 and len(v) == 27 else v
          for k, v in model.state_dict().items()}
    fresh = InferenceEngine(InferenceConfig(**CFG), device="cpu",
                            seed=9).models()["rotation"]
    import_state_dict(fresh, sd, k_perm=perm)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_ckpt_leaf_by_leaf(files, reference):
    for stage in STAGES:
        path = files["ckpt"][stage]
        assert checkpoint_format(path) == "torch"
        state = torch.load(path, weights_only=True)["model"]
        for k, v in reference.models()[stage].state_dict().items():
            assert torch.equal(state[k], v), (stage, k)


@pytest.mark.parametrize("fmt", ["msgpack", "pth", "ckpt"])
def test_engine_from_paths_alone(files, reference, fmt):
    cfg = InferenceConfig(**CFG, **{FIELDS[s]: files[fmt][s]
                                    for s in STAGES})
    engine = InferenceEngine(cfg, device="cpu", seed=11)
    pts, rgb, mask = build_batch(1, 1024, seed=3)
    want = reference.predict_batch_arrays(pts, rgb, mask)
    got = engine.predict_batch_arrays(pts, rgb, mask)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("defect", ["missing", "extra", "shape"])
def test_pth_import_is_strict(reference, tmp_path, defect):
    model = reference.models()["segmentation"]
    sd = dict(model.state_dict())
    if defect == "missing":
        sd.pop(next(k for k in sd if k.endswith("bn.weight")))
    elif defect == "extra":
        sd["block9.0.conv1.kernel"] = torch.zeros(27, 4, 4)
    else:
        k = next(k for k in sd if k.endswith("kernel"))
        sd[k] = torch.zeros(3, 3)
    path = tmp_path / "bad.pth"
    torch.save({"model_state_dict": sd}, path)
    cfg = InferenceConfig(**CFG, seg_checkpoint=str(path))
    with pytest.raises(KeyError):
        InferenceEngine(cfg, device="cpu")


@pytest.mark.parametrize("defect", ["missing", "extra"])
def test_msgpack_load_is_strict(files, tmp_path, defect):
    raw = msgpack_restore(open(files["msgpack"]["rotation"], "rb").read())
    params = raw["params"]
    if defect == "missing":
        params["unet"].pop(sorted(params["unet"])[0])
    else:
        params["unet"]["extra_conv"] = {"kernel": np.zeros((27, 2, 2),
                                                           np.float32)}
    path = tmp_path / "bad.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"params": params, "batch_stats": raw["batch_stats"]}))
    cfg = InferenceConfig(**CFG, rot_checkpoint=str(path))
    with pytest.raises(KeyError):
        InferenceEngine(cfg, device="cpu")


@pytest.mark.parametrize("blob", [
    b"\x81\xa1a\xc1",                                 # 0xc1: never used
    b"\x81\xa1a" + b"\xd4\x02\x00",                   # ext 2 (complex)
    b"\x81\xa1a\x01\x00",                             # trailing bytes
    b"\x81\xa1a\xcd\x00",                             # truncated uint16
])
def test_msgpack_reader_refuses(blob):
    with pytest.raises(ValueError):
        msgpack_restore(blob)


def test_checkpoint_format_refuses(tmp_path):
    path = tmp_path / "x.ckpt"
    path.write_bytes(struct.pack(">I", 7))
    with pytest.raises(ValueError):
        checkpoint_format(str(path))
    with pytest.raises(ValueError):
        load_stage_variables(str(path))
