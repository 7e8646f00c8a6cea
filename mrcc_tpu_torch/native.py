"""ctypes bindings to the host runtime library (port of
``mrcc_tpu/native.py``).

``runtime/voxelizer.cpp`` holds the host input pipeline's hot loops in C++:
voxelization (hash-map dedup of the quantised coordinates, feature means,
a label per voxel that is ``ignore_label`` where its points disagree, the
point-to-voxel map), exact farthest point sampling and the ball query
(the first ``nsample`` in-radius indices in index order).

The library is built at first use with the host C++ compiler and the
runtime Makefile's flags (``-O3 -march=native -fPIC -shared -std=c++17``)
into ``mrcc_tpu_torch/build/mrcc_runtime-<source hash>.so``, through a
temporary file renamed into place; a failed build raises with the
compiler's log.  The ``*_plain`` functions are the numpy twins of the
three entry points, with the same outputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR.parent / "runtime" / "voxelizer.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_LIB = None


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler found: the host runtime "
                       "(runtime/voxelizer.cpp) builds with c++ / g++")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"mrcc_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds agree
    return path


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.mrcc_voxelize.restype = ctypes.c_int32
        lib.mrcc_voxelize.argtypes = [
            f32p, f32p, i32p, i64, i64, ctypes.c_float, i64, ctypes.c_int32,
            i32p, f32p, i32p, i32p]
        lib.mrcc_fps.restype = None
        lib.mrcc_fps.argtypes = [f32p, i64, i64, i64, i32p]
        lib.mrcc_ball_query.restype = None
        lib.mrcc_ball_query.argtypes = [f32p, i64, f32p, i64, ctypes.c_float,
                                        i64, i32p]
        _LIB = lib
    return _LIB


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _np(x, dtype):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype)


def voxelize_host(points, feats, quantization_size, capacity, labels=None,
                  ignore_label=-100):
    """Host voxelization -> ``(coords [V, 3] i32, feats [V, C] f32, labels
    [V] i32 | None, point_to_voxel [N] i32, n_voxels)``: voxels in order of
    first appearance, at most ``capacity``; a point whose voxel did not fit
    maps to ``capacity``."""
    lib = _load()
    points = _np(points, np.float32)
    feats = _np(feats, np.float32)
    n, c = feats.shape
    out_coords = np.empty((capacity, 3), np.int32)
    out_feats = np.zeros((capacity, c), np.float32)
    out_labels = np.empty(capacity, np.int32)
    pv = np.empty(n, np.int32)
    lab = _np(labels, np.int32) if labels is not None else None
    n_vox = lib.mrcc_voxelize(
        _f32p(points), _f32p(feats), _i32p(lab) if lab is not None else None,
        n, c, float(quantization_size), capacity, int(ignore_label),
        _i32p(out_coords), _f32p(out_feats), _i32p(out_labels), _i32p(pv))
    labels_out = out_labels[:n_vox] if labels is not None else None
    return out_coords[:n_vox], out_feats[:n_vox], labels_out, pv, n_vox


def voxelize_host_plain(points, feats, quantization_size, capacity,
                        labels=None, ignore_label=-100):
    """numpy twin of :func:`voxelize_host` (feature sums in float64)."""
    points = _np(points, np.float32)
    feats = _np(feats, np.float32)
    c = feats.shape[1]
    coords = np.floor(points / quantization_size).astype(np.int32)
    uniq, first_idx, inverse = np.unique(coords, axis=0, return_index=True,
                                         return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(first_idx)  # first-appearance order like the C++ map
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    inverse = rank[inverse]
    uniq = uniq[order]
    n_vox = min(len(uniq), capacity)
    keep = inverse < n_vox
    fsum = np.zeros((n_vox, c), np.float64)
    np.add.at(fsum, inverse[keep], feats[keep])
    cnt = np.bincount(inverse[keep], minlength=n_vox)[:n_vox]
    fmean = (fsum / np.maximum(cnt, 1)[:, None]).astype(np.float32)
    pv = np.where(keep, inverse, capacity).astype(np.int32)
    labels_out = None
    if labels is not None:
        labels = _np(labels, np.int64)
        lmin = np.full(n_vox, 2**31 - 1, np.int64)
        lmax = np.full(n_vox, -(2**31), np.int64)
        np.minimum.at(lmin, inverse[keep], labels[keep])
        np.maximum.at(lmax, inverse[keep], labels[keep])
        labels_out = np.where(lmin == lmax, lmin,
                              ignore_label).astype(np.int32)
    return uniq[:n_vox], fmean, labels_out, pv, n_vox


def fps_host(points, npoint, start_idx=0):
    """Host farthest point sampling from ``start_idx`` -> ``[npoint]``
    int32 indices (the first maximum wins each step)."""
    lib = _load()
    points = np.ascontiguousarray(_np(points, np.float32)[:, :3])
    out = np.empty(npoint, np.int32)
    lib.mrcc_fps(_f32p(points), len(points), npoint, int(start_idx),
                 _i32p(out))
    return out


def fps_host_plain(points, npoint, start_idx=0):
    """numpy twin of :func:`fps_host`."""
    from .data.labels import farthest_point_sample_idx

    points = _np(points, np.float32)[:, :3]
    return farthest_point_sample_idx(points, npoint,
                                     start_idx=start_idx).astype(np.int32)


def ball_query_host(points, queries, radius, nsample):
    """Host ball query -> ``[S, nsample]`` int32: the first ``nsample``
    indices in index order within ``radius`` of each query, missing slots
    filled with the first hit (0 for an empty ball)."""
    lib = _load()
    points = _np(points, np.float32)
    queries = _np(queries, np.float32)
    out = np.empty((len(queries), nsample), np.int32)
    lib.mrcc_ball_query(_f32p(points), len(points), _f32p(queries),
                        len(queries), float(radius), nsample, _i32p(out))
    return out


def ball_query_host_plain(points, queries, radius, nsample):
    """numpy twin of :func:`ball_query_host`."""
    points = _np(points, np.float32)
    queries = _np(queries, np.float32)
    d2 = ((queries[:, None, :] - points[None]) ** 2).sum(-1)
    out = np.zeros((len(queries), nsample), np.int32)
    for q in range(len(queries)):
        within = np.where(d2[q] < radius ** 2)[0][:nsample]
        if len(within):
            out[q, :len(within)] = within
            out[q, len(within):] = within[0]
    return out
