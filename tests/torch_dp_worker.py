"""Rank process of the port's multi-process tests (``test_torch_parallel*``).

``run_ranks(mode, spec, tmp_path)`` pickles ``spec``, starts ``world``
processes of this file on the CPU (``gloo``), each joining a process group
on a free localhost port with a timeout on every collective, and returns
each rank's result (a pickled dict) in rank order.  A rank that fails or
hangs fails the calling test with its log; none outlives ``timeout_s``.

The ranks import torch and the port only (no JAX): the parent hands them
the JAX side's weights and batches as numpy in ``spec``.

    python tests/torch_dp_worker.py MODE RANK WORLD PORT SPEC OUT
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(mode, spec, tmp_path, world=2, timeout_s=300):
    spec_path = os.path.join(str(tmp_path), f"{mode}_spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    outs, procs = [], []
    for rank in range(world):
        out = os.path.join(str(tmp_path), f"{mode}_{rank}.pkl")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(rank),
             str(world), str(port), spec_path, out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


# ------------------------------------------------------------- the ranks


def _roundtrip(mesh, spec):
    import torch

    from mrcc_tpu_torch.parallel import fleet, make_mesh
    from mrcc_tpu_torch.parallel import mesh as mesh_lib

    rank, world = mesh.get_local_rank(), mesh.size()
    x = np.arange(world * 4 * 3, dtype=np.float32).reshape(world * 4, 3)
    y = x > 10
    lo, hi = rank * 4, rank * 4 + 4
    gx, gy = fleet.globalize(mesh, x[lo:hi], y[lo:hi])
    res = {"rank": rank, "world": world, "global_shape": tuple(gx.shape),
           "local_x": fleet.local_slice(gx), "local_y": fleet.local_slice(gy),
           "rows": mesh_lib.batch_sharding(mesh, len(x)),
           "shard": mesh_lib.shard_batch({"x": x}, mesh)["x"],
           "gathered_y": mesh_lib.gather_rows(torch.from_numpy(y[lo:hi]),
                                              mesh).numpy()}
    rep = {"w": torch.full((3,), float(rank + 1))}
    res["replicated"] = mesh_lib.replicate(rep, mesh)["w"].numpy()
    try:
        make_mesh(world + 2, "cpu")
        res["too_few_raised"] = False
    except ValueError:
        res["too_few_raised"] = True
    # the differentiable sum: its gradient is summed over the ranks
    v = torch.full((2,), float(rank + 1), requires_grad=True)
    with mesh_lib.data_parallel(mesh):
        total = mesh_lib.global_sum((v * v).sum())
        share = mesh_lib.mean_share(v)
        count = mesh_lib.global_count(3)
    total.backward()
    res.update(total=float(total), grad=v.grad.numpy(), share=float(share),
               count=float(count))
    return res


def _engine(mesh, spec):
    from mrcc_tpu_torch.app import InferenceConfig, InferenceEngine
    from mrcc_tpu_torch.parallel import fleet

    eng = InferenceEngine(InferenceConfig(**spec["cfg"]), device="cpu",
                          mesh=mesh)
    eng.load_jax_params(spec["params"])
    rank, world = mesh.get_local_rank(), mesh.size()
    res = {"rank": rank, "batches": []}
    for pts, rgb, mask in spec["batches"]:
        whole = {k: v.numpy() for k, v in
                 eng.predict_batch_arrays(pts, rgb, mask).items()}
        b = len(pts) // world
        rows = slice(rank * b, (rank + 1) * b)
        out = eng.predict_batch_arrays(*fleet.globalize(
            mesh, pts[rows], rgb[rows], mask[rows]))
        assert tuple(out["segmentation"].shape) == mask.shape
        local = {k: fleet.local_slice(v) for k, v in out.items()}
        res["batches"].append({"whole": whole, "local": local})
    return res


def _sha(tensors):
    import hashlib

    import torch

    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


def _train(mesh, spec):
    import torch

    from mrcc_tpu_torch.data.dataset import DataConfig
    from mrcc_tpu_torch.models import RobotNetSegmentation
    from mrcc_tpu_torch.train import (Trainer, TrainConfig,
                                      make_segmentation_train_step)

    rank = mesh.get_local_rank()

    def trainer_on(batch, exp, offset=0.0):
        model = RobotNetSegmentation(backbone="minkunet14A", in_channels=3,
                                     num_classes=3)
        model.load_state_dict({k: torch.from_numpy(v) + offset
                               if v.dtype.kind == "f" else torch.from_numpy(v)
                               for k, v in spec["state"].items()})
        tc = TrainConfig(lr=spec["lr"], batch_size=len(batch["points"]),
                         epochs=1)
        step, opt = make_segmentation_train_step(
            model, DataConfig(data_type=None, max_points=1024, scale=200),
            tc, voxel_capacity=spec["capacity"], device="cpu")
        return Trainer(model, None, step, opt, tc,
                       exp_path=os.path.join(spec["exp"], exp), mesh=mesh)

    res = {"rank": rank, "cases": []}
    for i, batch in enumerate(spec["batches"]):
        trainer = trainer_on(batch, f"{i}_{rank}")
        model = trainer.model
        losses, accs = [], []
        for _ in range(spec["steps"]):
            m = trainer.step(batch, spec["lr"])
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        res["cases"].append({
            "losses": losses, "accuracy": accs,
            "param_norm": float(torch.sqrt((flat.double() ** 2).sum())),
            "param_sha": _sha(model.parameters()),
            "buffer_sha": _sha(model.buffers())})
    res["resume"] = _resume(trainer_on, spec, rank)
    return res


def _resume(trainer_on, spec, rank):
    """The first case's steps less one, a checkpoint of the first rank
    only (as ``Trainer.fit`` writes one), then a new run on the same
    per-rank directories whose second rank starts from other weights and
    no checkpoint; its epoch, and its parameters after the last step."""
    from mrcc_tpu_torch.train import checkpoint as ckpt

    batch, epoch = spec["batches"][0], spec["steps"] - 1
    exp = f"resume_{rank}"
    trainer = trainer_on(batch, exp)
    for _ in range(epoch):
        trainer.step(batch, spec["lr"])
    if trainer.lead:
        ckpt.checkpoint_save(trainer.model, trainer.optimizer,
                             trainer.exp_path, trainer.exp_name, epoch)
    trainer = trainer_on(batch, exp, offset=0.01 * rank)
    out = {"epoch": trainer.epoch}
    trainer.step(batch, spec["lr"])
    return {**out, "param_sha": _sha(trainer.model.parameters()),
            "buffer_sha": _sha(trainer.model.buffers())}


def _metric(mesh, spec):
    """``spec["steps"]`` feature-extractor steps (``FeatureNet``
    minkunet14A, the mined triplet loss over the global batch) through
    ``Trainer(mesh=...).step`` on each of ``spec["batches"]``, every case
    from ``spec["state"]``; the losses, the norm of each step's summed
    gradient, the end parameters."""
    import torch

    from mrcc_tpu_torch.data.ycb import YCBDataset
    from mrcc_tpu_torch.models import FeatureNet
    from mrcc_tpu_torch.train import (Trainer, TrainConfig,
                                      make_metric_learning_train_step)

    rank = mesh.get_local_rank()
    data_cfg = YCBDataset(num_classes=1, samples_per_class=1,
                          max_points=spec["max_points"]).cfg
    res = {"rank": rank, "cases": []}
    for i, batch in enumerate(spec["batches"]):
        model = FeatureNet(backbone="minkunet14A")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in spec["state"].items()})
        tc = TrainConfig(lr=spec["lr"], batch_size=len(batch["points"]))
        step, opt = make_metric_learning_train_step(
            model, data_cfg, tc, spec["capacity"], device="cpu")
        trainer = Trainer(model, None, step, opt, tc, mesh=mesh,
                          exp_path=os.path.join(spec["exp"], f"{i}_{rank}"))
        losses, grad_norms = [], []
        for _ in range(spec["steps"]):
            losses.append(float(trainer.step(batch, spec["lr"])["loss"]))
            grads = torch.cat([p.grad.reshape(-1)
                               for p in model.parameters()])
            grad_norms.append(float(torch.sqrt((grads.double() ** 2).sum())))
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        res["cases"].append({
            "losses": losses, "grad_norms": grad_norms,
            "param_norm": float(torch.sqrt((flat.double() ** 2).sum())),
            "param_sha": _sha(model.parameters()),
            "buffer_sha": _sha(model.buffers())})
    return res


def _demo(mesh, spec):
    """``demo_checkpoints.main`` with ``--mesh`` over the ranks (each rank
    joins the group here, so the main's ``init_distributed`` finds it
    up), at ``spec["recipe"]``'s sizes: its epoch losses, and whether it
    benchmarked."""
    from mrcc_tpu_torch.cli.demo_checkpoints import Recipe, main

    out = main(spec["flags"] + ["--mesh", str(mesh.size()),
                                "--out", os.path.join(spec["exp"], "mesh")],
               device="cpu", recipe=Recipe(**spec["recipe"]))
    return {"rank": mesh.get_local_rank(),
            "losses": {k: [h["loss"] for h in v]
                       for k, v in out["history"].items()},
            "table": out.get("table")}


MODES = {"roundtrip": _roundtrip, "engine": _engine, "train": _train,
         "metric": _metric, "demo": _demo}


def main():
    mode, rank, world, port, spec_path, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from mrcc_tpu_torch.parallel import fleet

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    assert fleet.init_distributed(f"127.0.0.1:{port}", world, rank,
                                  device="cpu", timeout_s=120) is True
    mesh = fleet.make_global_mesh("cpu")
    # a tiny collective right away: gloo's context deadline trips when the
    # ranks reach their first collective far apart
    t = torch.ones(1)
    dist.all_reduce(t)
    assert float(t) == world
    res = MODES[mode](mesh, spec)
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
