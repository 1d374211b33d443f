"""3D geometry: the Cramer line/triangle solve and vector Snell's law.

Counterpart of the 3D half of ``tensorflowraytrace_tpu/ops/geometry.py``.
The "safe divide" discipline is kept exactly: the denominator is masked
BEFORE dividing, so neither the forward value nor the backward pass ever
sees a divide by zero on an invalid intersection.
"""

from __future__ import annotations

import torch

from tensorflowraytrace_tpu_torch.config import default_epsilon


def raw_line_triangle_intersect(
    rx1, ry1, rz1, rx2, ry2, rz2, xp, yp, zp, x1, y1, z1, x2, y2, z2, epsilon=None
):
    """Cramer's-rule line/triangle solve on co-broadcastable tensors.

    Returns ``(x, y, z, valid, ray_u, trig_u, trig_v)``; ``valid`` is False
    where the ray is parallel to the triangle's plane.  Barycentric pruning is
    the caller's job.
    """
    args = (rx1, ry1, rz1, rx2, ry2, rz2, xp, yp, zp, x1, y1, z1, x2, y2, z2)
    dt = args[0].dtype
    for a in args[1:]:
        dt = torch.promote_types(dt, a.dtype)
    (rx1, ry1, rz1, rx2, ry2, rz2, xp, yp, zp, x1, y1, z1, x2, y2, z2) = (
        a.to(dt) for a in torch.broadcast_tensors(*args))
    if epsilon is None:
        epsilon = default_epsilon(dt)

    a = rx1 - rx2
    b = x1 - xp
    c = x2 - xp
    d = ry1 - ry2
    f = y1 - yp
    g = y2 - yp
    h = rz1 - rz2
    k = z1 - zp
    l = z2 - zp  # noqa: E741 -- the reference's names

    q = rx1 - xp
    r = ry1 - yp
    s = rz1 - zp

    denominator = a * g * k + b * d * l + c * f * h - a * f * l - b * g * h - c * d * k
    ray_u_num = b * l * r + c * f * s + g * k * q - b * g * s - c * k * r - f * l * q
    trig_u_num = a * g * s + c * h * r + d * l * q - a * l * r - c * d * s - g * h * q
    trig_v_num = a * k * r + b * d * s + f * h * q - a * f * s - b * h * r - d * k * q

    valid = torch.abs(denominator) >= epsilon
    inv_den = 1.0 / torch.where(valid, denominator, torch.ones_like(denominator))
    ray_u = ray_u_num * inv_den
    trig_u = trig_u_num * inv_den
    trig_v = trig_v_num * inv_den

    # minus because a/d/h are (start - end)
    x = rx1 - ray_u * a
    y = ry1 - ray_u * d
    z = rz1 - ray_u * h
    return x, y, z, valid, ray_u, trig_u, trig_v


def _safe_unit(v, dim=-1):
    """Normalize ``v`` with the squared magnitude clamped at eps**2, so the
    rsqrt's value and partials stay finite for degenerate (masked-out) slots.
    Exact for any real ray: the clamp engages only below |v| ~ eps."""
    eps = torch.finfo(v.dtype).eps
    mag2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(mag2, min=eps * eps))


def select_eta(n_in, n_out, internal_mask):
    """``eta = n_in/n_out`` on internal hits, ``n_out/n_in`` on external
    ones; the 0 mirror sentinel propagates as ``eta == 0`` through safe
    divides.  Inputs must already broadcast to a common shape."""
    one = torch.ones_like(n_in)
    zero = torch.zeros_like(n_in)
    n_in_is_safe = n_in != 0.0
    n_in_safe = torch.where(n_in_is_safe, n_in, one)
    n_out_is_safe = n_out != 0.0
    n_out_safe = torch.where(n_out_is_safe, n_out, one)
    eta_internal = torch.where(n_out_is_safe, n_in_safe / n_out_safe, zero)
    eta_external = torch.where(n_in_is_safe, n_out_safe / n_in_safe, zero)
    return torch.where(internal_mask, eta_internal, eta_external)


def snell_3d_vec(p0, p1, norm, n_in, n_out, new_ray_length):
    """Vector Snell's law on (N, 3) endpoints: refract, reflect on a mirror
    (``n_in == 0``) or on total internal reflection.  Returns the child ray
    ``(p1, p1 + new_ray_length * direction)``."""
    u = _safe_unit(p1 - p0)
    n = _safe_unit(norm)
    nu = torch.sum(n * u, dim=-1, keepdim=True)

    internal_mask = nu > 0
    eta = select_eta(n_in[..., None], n_out[..., None], internal_mask)
    nu_eta = eta * nu

    radicand = 1 - eta * eta + nu_eta * nu_eta
    do_tir = radicand < 0
    safe_radicand = torch.where(do_tir, torch.ones_like(radicand), radicand)
    # clamp away from 0: d/dx sqrt(x) is infinite at exactly-critical
    # incidence (radicand == 0 escapes the < 0 TIR test); eps**2 leaves the
    # forward value unchanged at the dtype's resolution
    safe_radicand = torch.clamp(safe_radicand,
                                min=torch.finfo(radicand.dtype).eps ** 2)
    refract = (torch.sign(nu) * torch.sqrt(safe_radicand) - nu_eta) * n + eta * u
    reflect = -2 * nu * n + u

    do_reflect = do_tir | (n_in == 0)[..., None]
    direction = torch.where(do_reflect, reflect, refract)
    return p1, p1 + new_ray_length * direction
