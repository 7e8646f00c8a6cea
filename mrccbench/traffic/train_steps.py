"""Traffic kind ``train_steps``: one client training the segmentation net in
a closed loop, a step at a time, as ``train_segmentation`` does.

Set-up deals the mix's fixed set of ``pool * batch`` synthetic scenes
(``scene_set``) into ``pool`` batches in an order drawn from the seed, so
that every seed brings the same work in another order, draws the weights
from the seed, builds the program's step
(``make_segmentation_train_step``: model, AdamW, the step's four stages),
and drives that same object through its first ``checked_steps`` steps on
the pool's first batches; those steps warm every shape the window uses and
are the ones the reference follows.  The window then steps on through the
pool, each step ended by a device synchronise, until ``--seconds`` have
passed.  ``train_steps_per_s`` is the steps completed over the window's
wall time.

With ``--trace 1`` a few more steps run under the profiler and a few more
with a synchronised span around each stage (``prepare``, ``forward``,
``backward``, ``update``).  After the window, the program's state freed,
the plain reference (``reference/train.py``) repeats the checked steps
from the same weights on the same batches.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from mrccbench.data import scenes
from mrccbench.harness import profiling
from mrccbench.reference import minkunet, train as ref_train
from mrccbench.work import counts

STAGES = ("prepare", "forward", "backward", "update")


class Setup:
    """The program's step and everything it is fed."""

    def __init__(self, r):
        import torch
        from mrcc_tpu_torch.data.dataset import DataConfig
        from mrcc_tpu_torch.models import RobotNetSegmentation
        from mrcc_tpu_torch.train import (TrainConfig,
                                          make_segmentation_train_step)

        cfg, mix = r.config, r.mix
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        self.cfg, self.mix, self.device = cfg, mix, r.device
        b = mix["batch"]
        seeds = scenes.scene_seeds(mix["scene_set"], mix["pool"] * b)
        order = np.random.default_rng(
            np.random.SeedSequence(r.seed)).permutation(len(seeds))
        seeds = [seeds[i] for i in order]
        self.batches = [scenes.train_batch(seeds[i * b:(i + 1) * b],
                                           mix["max_points"], **mix["scene"])
                        for i in range(mix["pool"])]
        if r.fault == "half_batch":
            self.feed = [_half(batch) for batch in self.batches]
        else:
            self.feed = self.batches
        self.weights = minkunet.make_weights(cfg, r.seed, r.device)
        model = RobotNetSegmentation(
            backbone=cfg["backbone"], in_channels=cfg["in_channels"],
            num_classes=cfg["num_classes"],
            unet_out_channels=cfg["unet_out_channels"]).to(r.device)
        missing, unexpected = model.load_state_dict(self.weights,
                                                    strict=False)
        if unexpected or any(not k.endswith(("running_mean", "running_var"))
                             for k in missing):
            raise RuntimeError(f"weights do not fit the program's model: "
                               f"missing {missing}, unexpected {unexpected}")
        opt = cfg["optimizer"]
        self.lr = opt["lr"]
        self.step, self.optimizer = make_segmentation_train_step(
            model, DataConfig(data_type=None, max_points=mix["max_points"],
                              scale=1.0 / cfg["voxel_size"]),
            TrainConfig(batch_size=b, lr=opt["lr"],
                        weight_decay=opt["weight_decay"]),
            mix["voxel_capacity"], ignore_label=cfg["ignore_label"],
            device=r.device)
        if r.fault == "frozen":
            self.step.update = lambda lr: None
        self.model = model
        self.done = 0

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run_step(self):
        """One step on the pool's next batch; returns its loss (a device
        scalar)."""
        loss = self.step(self.feed[self.done % len(self.feed)],
                         self.lr)["loss"]
        self.done += 1
        return loss

    def checked_steps(self, n):
        """The first ``n`` steps: ``{"losses", "grad" (first step's
        gradient norm by leaf, from AdamW's state), "change" (each
        parameter's change over the ``n`` steps)}``."""
        import torch

        beta1 = self.cfg["optimizer"]["betas"][0]
        params = dict(self.model.named_parameters())
        losses, grad = [], None
        for _ in range(n):
            losses.append(self.run_step())
            if grad is None:
                state = self.optimizer.state
                grad = {k: torch.linalg.vector_norm(
                    state[p]["exp_avg"].double()) / (1 - beta1)
                    if p in state else torch.zeros((), device=p.device)
                    for k, p in params.items()}
        change = {k: torch.linalg.vector_norm(
            p.detach().double() - self.weights[k].double())
            for k, p in params.items()}
        self.sync()
        return {"losses": [float(x) for x in losses],
                "grad": {k: float(v) for k, v in grad.items()},
                "change": {k: float(v) for k, v in change.items()}}

    def free(self):
        import torch
        del self.step, self.optimizer, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _half(batch):
    """The batch with its second half of scenes left out (masked, their
    labels ignored): the step's mean runs over the rest."""
    out = {k: v.copy() for k, v in batch.items()}
    h = out["mask"].shape[0] // 2
    out["mask"][h:] = False
    out["labels"][h:] = scenes.IGNORE_LABEL
    return out


def reference_readings(s: Setup, precision="float32"):
    return ref_train.readings(s.cfg, s.mix, s.weights,
                              s.batches[:s.mix["checked_steps"]], precision)


def work_per_batch(s: Setup):
    """The benchmark's own count of each pool batch's step work."""
    plan = minkunet.layer_plan(s.cfg)
    out = []
    for batch in s.batches:
        levels, octs, _, _ = ref_train.prepare(s.cfg, s.mix, batch, s.device)
        out.append(counts.step_work(plan, counts.level_stats(levels, octs),
                                    s.cfg["dtype"], training=True))
        del levels, octs
    return out


def _window(s: Setup, seconds):
    import torch

    losses, ends = [], []
    first = s.done
    t0 = time.perf_counter()
    while True:
        losses.append(s.run_step())
        s.sync()
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    finite = torch.isfinite(torch.stack(losses).float())
    return {"units": len(losses), "seconds": ends[-1], "first": first,
            "failed": int((~finite).sum()),
            "unit_s": np.diff([0.0] + ends).tolist()}


def _traced(s: Setup, n):
    first = s.done
    with profiling.traced() as parsed:
        for _ in range(n):
            s.run_step()
    parsed["units"], parsed["first"] = n, first
    return parsed


def _spans(s: Setup, n):
    """Synchronised host-clock spans around the step's own stages."""
    spans = {k: [] for k in STAGES}
    step = s.step
    for _ in range(n):
        batch = s.feed[s.done % len(s.feed)]
        s.done += 1
        s.sync()
        t = time.perf_counter()
        prepared = step.prepare(batch)
        s.sync()
        spans["prepare"].append(time.perf_counter() - t)
        t = time.perf_counter()
        _, loss = step.forward(*prepared)
        s.sync()
        spans["forward"].append(time.perf_counter() - t)
        t = time.perf_counter()
        step.backward(loss)
        s.sync()
        spans["backward"].append(time.perf_counter() - t)
        t = time.perf_counter()
        step.update(s.lr)
        s.sync()
        spans["update"].append(time.perf_counter() - t)
    return spans


def run(r):
    """One run of a cell of this kind; returns the outcome the harness
    prints (``run.py``)."""
    import torch

    t_setup = time.perf_counter()
    s = Setup(r)
    t_steps = time.perf_counter()
    mix = s.mix
    program = s.checked_steps(mix["checked_steps"])
    t_end = time.perf_counter()
    setup_s = t_end - r.t0
    parts = {"imports_s": t_setup - r.t0, "inputs_weights_step_s":
             t_steps - t_setup, "checked_steps_s": t_end - t_steps}
    win = _window(s, r.seconds)
    context = {"window": win, "dtype": s.cfg["dtype"]}
    trace = None
    if r.trace:
        trace = context["trace"] = _traced(s, mix["traced_steps"])
        context["spans"] = _spans(s, mix["span_steps"])
    cuda = s.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    s.free()
    if r.trace:
        work = work_per_batch(s)
        pool = len(work)

        def total(key, first, n):
            return sum(work[(first + i) % pool][key] for i in range(n))

        win["model_ops"] = total("model_ops", win["first"], win["units"])
        trace["conv_least_s"] = total("conv_least_s", trace["first"],
                                      trace["units"])
    reference = reference_readings(s)
    gaps = ref_train.compare(program, reference)
    checks = {k: (gaps[k][0], limit, gaps[k][1])
              for k, limit in r.cell["limits"].items()}
    return {
        "setup_s": setup_s, "setup_parts": parts,
        "end_to_end": {"setup_s": setup_s,
                       "train_steps_per_s": win["units"] / win["seconds"]},
        "context": context, "trace": trace, "checks": checks,
        "attempted": win["units"], "failed": win["failed"],
        "memory_peak_bytes": peak,
    }
