"""RGB-D to point cloud, numpy only (port of ``mrcc_tpu/data/rgbd.py``).

- :func:`filter_discontinuities`: depth edge suppression by the min / max
  of each pixel's window;
- :func:`register_depth_map`: depth camera to RGB camera, keeping the
  largest depth per target pixel;
- :func:`depth_to_cloud`: unprojection to an organised [H, W, 6] or flat
  [1, M, 6] XYZRGB cloud;
- :func:`write_ply`: ascii PLY; :func:`read_pcd`: PCD v0.7, ascii and
  binary, x / y / z and an optional packed ``rgb``, non-finite points
  dropped.
"""

from __future__ import annotations

import numpy as np


def _window_extrema(depth, size):
    """Per pixel, the min and max over its ``size`` x ``size`` window, the
    border replicated (``scipy.ndimage`` ``mode="nearest"``)."""
    r = size // 2
    pad = np.pad(depth, r, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pad, (size, size))
    return win.min(axis=(-2, -1)), win.max(axis=(-2, -1))


def filter_discontinuities(depth, filt_size: int = 7, thresh: float = 1000):
    """Zero the depth pixels whose window min or max differs from them by
    more than ``thresh``; only pixels whose whole window lies inside the
    image are marked."""
    assert filt_size % 2 == 1, "Can only use odd filter sizes."
    depth = np.asarray(depth, np.float64)
    mins, maxes = _window_extrema(depth, filt_size)
    discont = np.maximum(np.abs(mins - depth), np.abs(maxes - depth))
    mark = discont > thresh
    off = (filt_size - 1) // 2
    full = np.zeros_like(mark)
    full[off:depth.shape[0] - off, off:depth.shape[1] - off] = \
        mark[off:depth.shape[0] - off, off:depth.shape[1] - off]
    return np.asarray(depth * (1 - full), depth.dtype)


def register_depth_map(depth, rgb_shape, depth_k, rgb_k, h_rgb_from_depth):
    """A depth map reprojected into the RGB camera's pixel grid [H_rgb,
    W_rgb], the largest depth kept per target pixel."""
    depth = np.asarray(depth, np.float64)
    h, w = depth.shape
    rh, rw = rgb_shape[:2]
    v, u = np.mgrid[0:h, 0:w]
    good = depth > 0
    z = depth[good]
    x = (u[good] - depth_k[0, 2]) * z / depth_k[0, 0]
    y = (v[good] - depth_k[1, 2]) * z / depth_k[1, 1]
    pts = np.stack([x, y, z, np.ones_like(z)], axis=0)
    xyz = h_rgb_from_depth[:3] @ pts
    zr = xyz[2]
    ok = zr > 0
    ur = np.floor(rgb_k[0, 0] * xyz[0, ok] / zr[ok] + rgb_k[0, 2] + 0.5
                  ).astype(np.int64)
    vr = np.floor(rgb_k[1, 1] * xyz[1, ok] / zr[ok] + rgb_k[1, 2] + 0.5
                  ).astype(np.int64)
    zr = zr[ok]
    inb = (ur >= 0) & (ur < rw) & (vr >= 0) & (vr < rh)
    out = np.zeros((rh, rw), np.float64)
    np.maximum.at(out, (vr[inb], ur[inb]), zr[inb])
    return out


def depth_to_cloud(depth, rgb, rgb_k, organized: bool = True, mask=None):
    """``organized``: [H, W, 6] with NaN xyz (and zero colour) at holes;
    else [1, M, 6] of the valid points (depth > 0, outside ``mask``)."""
    depth = np.asarray(depth, np.float64)
    rgb = np.asarray(rgb)
    h, w = depth.shape
    v, u = np.mgrid[0:h, 0:w]
    x = (u - rgb_k[0, 2]) * depth / rgb_k[0, 0]
    y = (v - rgb_k[1, 2]) * depth / rgb_k[1, 1]
    cloud = np.empty((h, w, 6), np.float64)
    cloud[..., 0], cloud[..., 1], cloud[..., 2] = x, y, depth
    cloud[..., 3:] = rgb[..., :3]
    bad = depth <= 0
    if mask is not None:
        bad = bad | (np.asarray(mask) > 0)
    if organized:
        cloud[..., :3][depth <= 0] = np.nan
        cloud[..., 3:][depth <= 0] = 0
        return cloud
    return cloud[~bad][None]


def write_ply(path, cloud):
    """ASCII PLY of an [H, W, C] or [1, M, C] cloud (C = 6: uchar
    colours)."""
    cloud = np.asarray(cloud)
    assert cloud.ndim == 3, f"expected [H, W, C] or [1, M, C], got {cloud.shape}"
    color = cloud.shape[2] == 6
    pts = cloud.reshape(-1, cloud.shape[2])
    header = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
              "property float x", "property float y", "property float z"]
    if color:
        header += ["property uchar diffuse_red", "property uchar diffuse_green",
                   "property uchar diffuse_blue"]
    header += ["end_header"]
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        for p in pts:
            if color:
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g} "
                        f"{int(p[3])} {int(p[4])} {int(p[5])}\n")
            else:
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
    return path


def read_pcd(path):
    """``(points [N, 3] f32, rgb [N, 3] f32 in [0, 1])`` of a PCD v0.7 file
    (ascii or binary; zero colours without an ``rgb`` field)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        fmt = header["DATA"]
        offs, off = {}, 0
        for name, size, count in zip(fields, sizes, counts):
            offs[name] = off
            off += size * count
        step = off
        if fmt == "ascii":
            rows = np.atleast_2d(np.loadtxt(f, dtype=np.float64, max_rows=n))
            cols = {name: rows[:, i] for i, name in enumerate(fields)}
            pts = np.stack([cols["x"], cols["y"], cols["z"]],
                           axis=1).astype(np.float32)
            rgb_col = cols.get("rgb")
            packed = (None if rgb_col is None
                      else rgb_col.astype(np.float32).view(np.uint32))
        elif fmt == "binary":
            raw = np.frombuffer(f.read(n * step), np.uint8).reshape(n, step)

            def f32(name):
                o = offs[name]
                return raw[:, o:o + 4].copy().view(np.float32)[:, 0]

            pts = np.stack([f32("x"), f32("y"), f32("z")], axis=1)
            packed = (raw[:, offs["rgb"]:offs["rgb"] + 4].copy().view(
                np.uint32)[:, 0] if "rgb" in offs else None)
        else:
            raise ValueError(f"unsupported PCD DATA format: {fmt}")
    if packed is None:
        rgb = np.zeros_like(pts)
    else:
        rgb = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                        packed & 0xFF], axis=1).astype(np.float32) / 255.0
    ok = np.isfinite(pts).all(axis=1)
    return pts[ok].astype(np.float32), rgb[ok].astype(np.float32)
