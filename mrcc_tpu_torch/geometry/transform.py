"""SE(3) pose utilities (port of ``mrcc_tpu/geometry/transform.py``).

Poses are ``[x, y, z, qw, qx, qy, qz]`` (WXYZ).  Functions broadcast over
leading batch dims.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def qnormalize(q, eps=EPS):
    """Normalise to a unit quaternion."""
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                        keepdim=True), eps)


def quat_to_matrix(q, normalize=True):
    """WXYZ quaternion(s) -> rotation matrices (..., 3, 3)."""
    if normalize:
        q = qnormalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def matrix_to_quat(m):
    """Rotation matrices -> WXYZ quaternions; branchless Shepperd.

    Of the four candidates ``4 q_i * q`` the one with the largest pivot is
    taken and normalised; the sign follows that pivot (consumers are
    sign-invariant)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                    dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                    dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                    dim=-1),
    ], dim=-2)                                            # (..., 4, 4)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return qnormalize(cands.gather(-2, idx)[..., 0, :])


def rot6d_to_matrix(r6):
    """Continuous 6D rotation -> rotation matrix (..., 3, 3): Gram-Schmidt
    on the two predicted columns, ``[b1 b2 b1 x b2]``."""
    eps = 1e-8
    a1, a2 = r6[..., :3], r6[..., 3:6]
    b1 = a1 / torch.clamp_min(torch.linalg.vector_norm(a1, dim=-1,
                                                       keepdim=True), eps)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.clamp_min(torch.linalg.vector_norm(a2p, dim=-1,
                                                        keepdim=True), eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rot6d_to_quat(r6):
    """6D rotation -> WXYZ quaternion (via :func:`rot6d_to_matrix`)."""
    return matrix_to_quat(rot6d_to_matrix(r6))


def pose_to_matrix(pose):
    """Pose [x, y, z, qw, qx, qy, qz] -> 4x4 homogeneous transform."""
    rot = quat_to_matrix(pose[..., 3:7])
    top = torch.cat([rot, pose[..., :3, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(mat):
    """4x4 transform -> pose [x, y, z, qw, qx, qy, qz]."""
    return torch.cat([mat[..., :3, 3], matrix_to_quat(mat[..., :3, :3])],
                     dim=-1)
