"""Time variants of the rank kernel on the card.

Run from the root of a checkout on a machine with the card:

    python -m mrcc_tpu_torch.cli.rank_variants SPEC.json

SPEC maps a variant name to ``{"edits": [[old, new], ...]}``: textual edits
of ``mrcc_tpu_torch/csrc/rank.cu`` (none: the source as it is).  Each
variant is built with the flags of ``ops/build.py`` (one nvcc each, all
started together) into ``mrcc_tpu_torch/build/variants/rank-<name>/`` and
timed in turns, A B ... B A, at the k3 tables of ``chip_smoke.py`` phase
3's production levels 0 and 1 (B = 2 clouds of 131072 points): the kernel's
own device time (``chip_smoke.kernel_device_ms``, torch.profiler, 20
launches), and whether its tables equal the plain twin's (a variant that
skips work is expected to differ).  Prints one JSON line per level.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess

import torch

from ..ops import rank
from ..ops.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc, ptr, stream_ptr
from .dw_variants import _VariantLib


def build_variants(spec):
    """{name: library} built from SPEC."""
    started = []
    for name, variant in spec.items():
        src = BUILD_DIR / "variants" / f"rank-{name}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC_DIR, src)
        path = src / "rank.cu"
        text = path.read_text()
        for old, new in variant.get("edits", []):
            if old not in text:
                raise ValueError(f"{name}: rank.cu has no {old[:60]!r}")
            text = text.replace(old, new)
        path.write_text(text)
        out = src / "rank.so"
        started.append((name, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in started:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        libs[name] = _VariantLib(out, rank.LIB.functions)
    return libs


def main(argv=None):
    import chip_smoke as cs
    from ..sparse.hierarchy import K3_DELTAS

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("spec")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rank_variants: no CUDA device")
    with open(args.spec) as fh:
        spec = json.load(fh)
    device = torch.device("cuda")
    libs = build_variants(spec)
    print(json.dumps({"card": cs.smi_line()}), flush=True)
    plevels = cs.bench_levels(device, batch=2, points=cs.PROD_POINTS,
                              tables=True)[2]
    plan = rank._device_plan(K3_DELTAS, device)
    k = len(K3_DELTAS)
    for lv in plevels[:2]:
        b, n = lv.key.shape
        want = rank.rank_lookup_plain(lv.key, lv.key, K3_DELTAS, lv.kbits)
        idx = torch.empty((k, b, n), dtype=torch.int32, device=device)
        hit = torch.empty((k, b, n), dtype=torch.bool, device=device)
        row = {"shape": f"rank[{b}x{n} k3]"}
        for name in [*spec, *reversed(spec)]:  # in turns: A B ... B A
            def call(lib=libs[name]):
                lib.call("mrcc_rank_lookup", ptr(lv.key), ptr(lv.key),
                         ptr(lv.kbits), ptr(plan), ptr(idx), ptr(hit), b, n,
                         n, k, rank.RANK_ROWS, rank.RANK_WINDOW,
                         stream_ptr(lv.key))

            call()
            rec = row.setdefault(name, {"device_ms": [], "equal": bool(
                torch.equal(idx, want[0]) and torch.equal(hit, want[1]))})
            rec["device_ms"].append(cs.kernel_device_ms(call, "rank_kernel"))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
