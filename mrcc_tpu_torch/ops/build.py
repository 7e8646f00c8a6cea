"""Build the CUDA sources under ``csrc/`` into shared libraries, load them.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``mrcc_tpu_torch/build/<name>-<source hash>.so`` at first use, and is
bound with ``ctypes`` through a plain C interface: pointers and the CUDA
stream travel as ``c_void_p``, sizes as ``c_int``, and every C function
returns ``cudaGetLastError()``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

from ..tracing import launch_span

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of mrcc_tpu_torch "
                       "build with the CUDA toolkit's compiler")


def _source_hash(source: Path) -> str:
    h = hashlib.sha256()
    for path in sorted([source, *CSRC_DIR.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class BuildInfo:
    """What one source's build cost and what ptxas said about it."""

    name: str
    seconds: float  # 0 when the library was already built
    log: str

    def resource_lines(self):
        """ptxas register / shared-memory / spill lines."""
        return [ln.strip() for ln in self.log.splitlines()
                if "registers" in ln or "spill" in ln]


class KernelLibrary:
    """One ``csrc/<name>.cu`` compiled at first use and loaded with ctypes.

    ``functions`` maps each exported C symbol to its argtypes; every symbol
    returns an int (a ``cudaError_t``).
    """

    def __init__(self, name: str, functions: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.functions = dict(functions)
        self._lib: Optional[ctypes.CDLL] = None
        self.build_info: Optional[BuildInfo] = None

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"{self.name}-{_source_hash(self.source)}.so"

    def _start(self):
        """Start nvcc into a temporary file (None if already built)."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish(self, started) -> BuildInfo:
        if started is None:
            self.build_info = BuildInfo(self.name, 0.0, "")
            return self.build_info
        proc, tmp, t0 = started
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{log}")
        os.replace(tmp, self.path)  # atomic: concurrent builders agree
        self.build_info = BuildInfo(self.name, seconds, log)
        return self.build_info

    def build(self) -> BuildInfo:
        return self._finish(self._start())

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            if self.build_info is None:
                self.build()
            lib = ctypes.CDLL(str(self.path))
            for fname, argtypes in self.functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fname: str, *args) -> None:
        with launch_span(f"kernel.{self.name}.{fname}"):
            err = getattr(self.lib(), fname)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fname} failed: CUDA error {err}")


def build_all(libraries: Iterable[KernelLibrary]):
    """Compile every library in parallel (one nvcc per source, all started
    together); returns their BuildInfo in order."""
    libraries = list(libraries)
    started = [lib._start() for lib in libraries]
    infos, errors = [], []
    for lib, s in zip(libraries, started):  # wait for every nvcc
        try:
            infos.append(lib._finish(s))
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return infos


def route(*tensors) -> bool:
    """True: launch the kernel (CUDA); False: plain twin (CPU); else raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs on an unsupported device {dev}")
    return True


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
