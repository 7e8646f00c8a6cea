"""Quaternion algebra (port of ``mrcc_tpu/geometry/quaternion.py``: the
functions the pose criteria use).  WXYZ, scalar first; every function
broadcasts over leading dims."""

from __future__ import annotations

import torch

from .transform import qnormalize

__all__ = ["qconj", "qeuler", "qmul", "qnormalize"]


def qconj(q):
    """Quaternion conjugate."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qmul(q, r):
    """Hamilton product ``q * r``."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack([qw * rw - qx * rx - qy * ry - qz * rz,
                        qw * rx + qx * rw + qy * rz - qz * ry,
                        qw * ry - qx * rz + qy * rw + qz * rx,
                        qw * rz + qx * ry - qy * rx + qz * rw], dim=-1)


def qeuler(q, order="zyx", epsilon=0.0):
    """Quaternion to Euler angles ``[x, y, z]`` for the six axis orders
    (the reference's QuaterNet formulas); the arcsin argument is clipped
    to ``[-1 + epsilon, 1 - epsilon]``."""
    q0, q1, q2, q3 = q.unbind(-1)

    def asin_c(x):
        return torch.asin(torch.clamp(x, -1.0 + epsilon, 1.0 - epsilon))

    if order == "xyz":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin_c(2 * (q1 * q3 + q0 * q2))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == "yzx":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin_c(2 * (q1 * q2 + q0 * q3))
    elif order == "zxy":
        x = asin_c(2 * (q0 * q1 + q2 * q3))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "xzy":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin_c(2 * (q0 * q3 - q1 * q2))
    elif order == "yxz":
        x = asin_c(2 * (q0 * q1 - q2 * q3))
        y = torch.atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "zyx":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin_c(2 * (q0 * q2 - q1 * q3))
        z = torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise ValueError(f"unknown euler order: {order}")
    return torch.stack([x, y, z], dim=-1)
