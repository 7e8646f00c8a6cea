"""ROS ``PointCloud2`` <-> numpy (port of ``mrcc_tpu/utils/ros_utils.py``,
after the reference's vendored ``ros_numpy``).  Works on the raw message
fields, so nothing here imports ROS."""

from __future__ import annotations

import numpy as np


def pointcloud2_to_arrays(msg, skip_nans=True):
    """PointCloud2 -> ``(points [N, 3] float32, rgb [N, 3] float32 in
    [0, 1])``.  Expects x / y / z float32 fields and a packed ``rgb``
    float32 field (the Kinect registered-cloud layout); without ``rgb`` the
    colours are zeros.  ``skip_nans`` drops points with a non-finite
    coordinate."""
    offsets = {f.name: f.offset for f in msg.fields}
    step = msg.point_step
    n = msg.width * msg.height
    raw = np.frombuffer(bytes(msg.data), dtype=np.uint8).reshape(n, step)

    def field_f32(name):
        off = offsets[name]
        return raw[:, off:off + 4].copy().view(np.float32)[:, 0]

    points = np.stack([field_f32("x"), field_f32("y"), field_f32("z")],
                      axis=1)
    if "rgb" in offsets:
        off = offsets["rgb"]
        packed = raw[:, off:off + 4].copy().view(np.uint32)[:, 0]
        rgb = np.stack([((packed >> s) & 0xFF).astype(np.float32) / 255.0
                        for s in (16, 8, 0)], axis=1)
    else:
        rgb = np.zeros_like(points)
    if skip_nans:
        ok = np.isfinite(points).all(axis=1)
        points, rgb = points[ok], rgb[ok]
    return points.astype(np.float32), rgb


def arrays_to_pointcloud2_data(points, rgb):
    """The inverse packing (for tests and publishing): ``(data bytes,
    point_step, fields)`` with fields as ``(name, offset, datatype)``
    tuples (datatype 7: FLOAT32)."""
    n = len(points)
    step = 16
    raw = np.zeros((n, step), np.uint8)
    raw[:, 0:12] = np.asarray(points, np.float32).view(np.uint8).reshape(
        n, 12)
    c = [np.clip(rgb[:, i] * 255, 0, 255).astype(np.uint32) for i in range(3)]
    packed = (c[0] << 16) | (c[1] << 8) | c[2]
    raw[:, 12:16] = packed.view(np.uint32)[:, None].view(np.uint8).reshape(
        n, 4)
    fields = (("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("rgb", 12, 7))
    return raw.tobytes(), step, fields
