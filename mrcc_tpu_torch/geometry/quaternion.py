"""Quaternion algebra (port of ``mrcc_tpu/geometry/quaternion.py``).  WXYZ,
scalar first; every function broadcasts over leading dims."""

from __future__ import annotations

import torch

from .transform import qnormalize

__all__ = ["euler_to_quat", "expmap_to_quat", "qangle", "qconj", "qeuler",
           "qfix", "qmul", "qnormalize", "qrot", "switch_pose_w",
           "wxyz_to_xyzw", "xyzw_to_wxyz"]


def xyzw_to_wxyz(q):
    """Reorder XYZW quaternions to WXYZ."""
    return torch.cat([q[..., 3:4], q[..., :3]], dim=-1)


def wxyz_to_xyzw(q):
    """Reorder WXYZ quaternions to XYZW."""
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def switch_pose_w(pose):
    """``[x, y, z, qx, qy, qz, qw]`` -> ``[x, y, z, qw, qx, qy, qz]``."""
    return torch.cat([pose[..., :3], xyzw_to_wxyz(pose[..., 3:7])], dim=-1)


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


def qrot(q, v):
    """Rotate vectors ``v`` by unit quaternions ``q`` (QuaterNet form;
    broadcasting)."""
    shape = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    q = q.expand(shape + (4,))
    v = v.expand(shape + (3,))
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


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


def qfix(q):
    """Sign continuity along the leading (time) axis: each quaternion's sign
    follows its predecessor's (input (L, J, 4))."""
    dots = (q[1:] * q[:-1]).sum(-1)
    flip = torch.cumsum((dots < 0).to(torch.int64), dim=0) % 2
    sign = torch.where(flip.bool(), -1.0, 1.0).to(q.dtype)[..., None]
    return torch.cat([q[:1], q[1:] * sign], dim=0)


def expmap_to_quat(e):
    """Axis-angle (exponential map) to WXYZ quaternion, stable sinc form."""
    theta = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / torch.pi) * e
    return torch.cat([w, xyz], dim=-1)


def euler_to_quat(e, order="xyz"):
    """Euler angles to WXYZ quaternion, with the reference's antipodal sign
    flip for the orders ``xyz``, ``yzx`` and ``zxy``."""
    x, y, z = e.unbind(-1)
    zeros = torch.zeros_like(x)
    table = {
        "x": torch.stack([torch.cos(x / 2), torch.sin(x / 2), zeros, zeros],
                         dim=-1),
        "y": torch.stack([torch.cos(y / 2), zeros, torch.sin(y / 2), zeros],
                         dim=-1),
        "z": torch.stack([torch.cos(z / 2), zeros, zeros, torch.sin(z / 2)],
                         dim=-1),
    }
    result = None
    for axis in order:
        r = table[axis]
        result = r if result is None else qmul(result, r)
    if order in ("xyz", "yzx", "zxy"):
        result = -result
    return result


def qangle(q1, q2):
    """Absolute angle (rad) between two WXYZ quaternions; sign-invariant
    (atan2 form of ``acos(2 <q1, q2>^2 - 1)``)."""
    qd = qmul(qnormalize(q1), qconj(qnormalize(q2)))
    return 2.0 * torch.atan2(torch.linalg.vector_norm(qd[..., 1:], dim=-1),
                             qd[..., 0].abs())
