"""Minimal rotation utilities for source aiming: quaternions in 3D and a
plane rotation in 2D.

Counterpart of ``tensorflowraytrace_tpu/utils/quaternion.py``.  Quaternions
are ``(..., 4)`` tensors in (w, x, y, z) order.
"""

from __future__ import annotations

import math

import torch


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = torch.movedim(q1, -1, 0)
    w2, x2, y2, z2 = torch.movedim(q2, -1, 0)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_from_axis_angle(axis, angle):
    """The quaternion rotating by ``angle`` (radians) about ``axis``
    (normalised here); ``angle`` has the leading shape of ``axis``."""
    axis = torch.as_tensor(axis)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device) / 2.0
    w = torch.cos(half)[..., None]
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat([w, xyz], dim=-1)


def quat_from_u_to_v(u, v, eps=1e-12):
    """The rotation quaternion taking direction u to direction v.
    Antiparallel inputs rotate pi about a perpendicular axis."""
    v = v.to(u.dtype)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=eps)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)
    dot = torch.sum(u * v, dim=-1)
    cross = torch.linalg.cross(u, v)

    # general case: q = (1 + dot, cross), then normalize
    w = (1.0 + dot)[..., None]
    q = torch.cat([w, cross], dim=-1)

    # antiparallel: pick a perpendicular axis deterministically
    def axis(k):
        e = torch.zeros(3, dtype=u.dtype, device=u.device)
        e[k] = 1.0
        return torch.linalg.cross(u, e.expand_as(u))

    perp = axis(0)
    perp_bad = torch.linalg.vector_norm(perp, dim=-1, keepdim=True) < 1e-6
    perp = torch.where(perp_bad, axis(1), perp)
    q_anti = torch.cat([torch.zeros_like(w), perp], dim=-1)

    anti = (dot < -1.0 + 1e-10)[..., None]
    return quat_normalize(torch.where(anti, q_anti, q))


def rotate_vector(q, v):
    """Rotate ``(..., 3)`` vectors by quaternion(s) ``q`` (broadcastable)."""
    w = q[..., :1]
    xyz = q[..., 1:]
    xyz, v = torch.broadcast_tensors(xyz, v)
    # v' = v + 2 w (xyz x v) + 2 xyz x (xyz x v)
    t = 2.0 * torch.linalg.cross(xyz, v)
    return v + w * t + torch.linalg.cross(xyz, t)


def rotate_2d(points, angle):
    """Rotate ``(..., 2)`` points about the origin by ``angle`` (radians; a
    tensor, or a number whose cosine and sine enter as Python scalars so
    that nothing is copied to the device)."""
    if isinstance(angle, torch.Tensor):
        c, s = torch.cos(angle), torch.sin(angle)
    else:
        c, s = math.cos(angle), math.sin(angle)
    x = points[..., 0]
    y = points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)
