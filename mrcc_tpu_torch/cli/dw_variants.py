"""Time variants of the weight-gradient kernels on the card.

Run from the root of a checkout on a machine with the card:

    python -m mrcc_tpu_torch.cli.dw_variants SPEC.json [--dtypes f32,bf16]

SPEC maps a variant name to ``{"edits": [[file, old, new], ...], "conv":
{name: value}}``: textual edits of the sources under
``mrcc_tpu_torch/csrc`` (none: the sources as they are) and values that
replace module constants of ``ops/conv.py`` (``_DW_WAVES``,
``_DW_MIN_ROWS``) while the variant runs.  Each variant's
``conv_dw_sk.cu`` and ``conv_dw_map.cu`` are built with the flags of
``ops/build.py`` (one nvcc each, all started together) into
``mrcc_tpu_torch/build/variants/<name>/``, and every variant is timed in
turns, A B ... B A (CUDA events, ``chip_smoke.cuda_ms``; two times each)
at the dW shapes of
``chip_smoke.py`` phase 3 on its training data, with its relative error
against the plain twin; each line also gives the host time of one launch
through ``ops.conv._dw_launch`` (the first variant, 50 calls, no
synchronisation between them).
Prints one JSON line per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import subprocess
import time

import torch

from ..ops import conv
from ..ops.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc


class _VariantLib:
    """One variant's library, called like ``KernelLibrary``."""

    def __init__(self, path, functions):
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in functions.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def call(self, fname, *args):
        err = getattr(self._lib, fname)(*args)
        if err:
            raise RuntimeError(f"{fname} failed: CUDA error {err}")


def build_variants(spec):
    """{name: {"conv_dw_sk": lib, "conv_dw_map": lib}} built from SPEC."""
    started = []
    for name, variant in spec.items():
        src = BUILD_DIR / "variants" / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC_DIR, src)
        for fname, old, new in variant.get("edits", []):
            path = src / fname
            text = path.read_text()
            if old not in text:
                raise ValueError(f"{name}: {fname} has no {old[:60]!r}")
            path.write_text(text.replace(old, new))
        for lib in (conv.DW_SK_LIB, conv.DW_MAP_LIB):
            out = src / f"{lib.name}.so"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(out),
                 str(src / f"{lib.name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            started.append((name, lib, out, proc))
    libs = {}
    for name, lib, out, proc in started:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{lib.name}:\n{log}")
        print(json.dumps({"variant": name, "library": lib.name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        libs.setdefault(name, {})[lib.name] = _VariantLib(out, lib.functions)
    return libs


def dw_cases(device):
    """``(name, kind, feats, g, maps, sizes)`` at ``chip_smoke.py`` phase
    3's dW shapes."""
    import chip_smoke as cs
    from ..sparse import neighbor_tables

    tl = cs.train_levels(cs.train_batch(), device)
    sl = cs.train_levels(cs.scene_batch(), device,
                         capacity=cs.SCENE_CAPACITY)
    lt = dataclasses.replace(tl[0], **dict(zip(("nbr_idx", "nbr_hit"),
                                               neighbor_tables(tl[0]))))
    gen = torch.Generator(device="cpu").manual_seed(7)

    def feats(lv, c):
        x = torch.randn(lv.key.shape + (c,), generator=gen).to(device)
        return torch.where(lv.valid[..., None], x, 0.0)

    cases = []
    for li, cin, cout in ((0, 3, 32), (0, 416, 384), (0, 384, 384),
                          (4, 128, 256)):
        lv = tl[li]
        b, n = lv.key.shape
        cases.append((f"dw_sk[{b}x{n} {cin}x{cout}]", "sk", feats(lv, cin),
                      feats(lv, cout), (lv.key, lv.kbits), (b, n)))
    for li, cin, cout in ((0, 32, 32), (3, 128, 128)):
        f, c = tl[li], tl[li + 1]
        b, nf = f.key.shape
        nc = c.key.shape[1]
        cases.append((f"dw_down[{b}x{nf}->{nc} {cin}x{cout}]", "down",
                      feats(f, cin), feats(c, cout),
                      (c.child_idx, c.child_hit), (b, nf, nc)))
    for li, cin, cout in ((3, 256, 384), (0, 384, 384)):
        f, c = tl[li], tl[li + 1]
        b, nf = f.key.shape
        nc = c.key.shape[1]
        cases.append((f"dw_up[{b}x{nc}->{nf} {cin}x{cout}]", "up",
                      feats(c, cin), feats(f, cout),
                      (f.parent_idx, f.row_ok, f.octant), (b, nc, nf)))
    for lv, cin, cout in ((lt, 3, 32), (lt, 416, 384), (lt, 384, 384),
                          (sl[0], 416, 384)):
        b, n = lv.key.shape
        cases.append((f"dw_k3map[{b}x{n} {cin}x{cout}]", "k3map",
                      feats(lv, cin), feats(lv, cout),
                      (lv.nbr_idx, lv.nbr_hit), (b, n)))
    return cases


def main(argv=None):
    import chip_smoke as cs

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("spec")
    parser.add_argument("--dtypes", default="f32")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(args.spec) as fh:
        spec = json.load(fh)
    device = torch.device("cuda")
    libs = build_variants(spec)
    plain = {"sk": conv.dw_sk_plain, "down": conv.dw_down_plain,
             "up": conv.dw_up_plain, "k3map": conv.dw_k3_map_plain}
    defaults = {k: getattr(conv, k) for v in spec.values()
                for k in v.get("conv", {})}
    print(json.dumps({"card": cs.smi_line()}), flush=True)
    for name, kind, f, g, maps, sizes in dw_cases(device):
        want = plain[kind](f, g, *maps)
        taps = 27 if kind in ("sk", "k3map") else 8
        row = {"shape": name}
        for dt in args.dtypes.split(","):
            fd, gd = (f, g) if dt == "f32" else (f.bfloat16(), g.bfloat16())
            for vname in [*spec, *reversed(spec)]:  # in turns: A B B A
                for k, v in {**defaults, **spec[vname].get("conv",
                                                           {})}.items():
                    setattr(conv, k, v)
                lib = libs[vname]["conv_dw_sk" if kind == "sk"
                                  else "conv_dw_map"]

                def call(lib=lib, fname=f"mrcc_dw_{kind}_{dt}"):
                    return conv._dw_launch(lib, fname, taps, fd, gd, maps,
                                           sizes)

                err = float((call() - want).norm() / want.norm())
                rec = row.setdefault(f"{vname} {dt}", {"ms": [],
                                                       "rel_err": err})
                rec["ms"].append(cs.cuda_ms(call))
                if "host_us" not in row:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(50):
                        call()
                    row["host_us"] = (time.perf_counter() - t0) / 50 * 1e6
                    torch.cuda.synchronize()
        for k, v in defaults.items():
            setattr(conv, k, v)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
