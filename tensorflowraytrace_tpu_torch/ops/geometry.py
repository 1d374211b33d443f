"""Geometry: intersections and Snell's law in 2D and 3D.

Counterpart of ``tensorflowraytrace_tpu/ops/geometry.py``: the 2D
line/line and line/circle solves, the angle form of Snell's law and the
angular-window test; the 3D Cramer line/triangle solve and vector Snell's
law; and the N x M wrappers of the three solves (``line_intersect``,
``line_circle_intersect``, ``line_triangle_intersect``), whose output is
(M, N), the second set on axis 0.  The "safe divide" discipline is kept exactly: the denominator is
masked BEFORE dividing, so neither the forward value nor the backward pass
ever sees a divide by zero on an invalid intersection.
"""

from __future__ import annotations

import math

import torch

from tensorflowraytrace_tpu_torch.config import default_epsilon

PI = math.pi


def _common(*args):
    """Broadcast the tensors to one shape and promote them to one dtype
    before any arithmetic (a float32 operand would otherwise keep float32
    subexpressions in a float64 solve)."""
    dt = args[0].dtype
    for a in args[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return [a.to(dt) for a in torch.broadcast_tensors(*args)]


# ======================================================================
# 2D
# ======================================================================

def raw_line_intersect(x1s, y1s, x1e, y1e, x2s, y2s, x2e, y2e, epsilon=None):
    """Infinite line/line intersection on co-broadcastable tensors.

    Returns ``(x, y, valid, u, v)``: the intersection point, validity (False
    where the lines are parallel) and the parameters along line 1 and 2."""
    x1s, y1s, x1e, y1e, x2s, y2s, x2e, y2e = _common(
        x1s, y1s, x1e, y1e, x2s, y2s, x2e, y2e)
    if epsilon is None:
        epsilon = default_epsilon(x1s.dtype)

    x1 = x1e - x1s
    y1 = y1e - y1s
    x2 = x2e - x2s
    y2 = y2e - y2s
    denominator = x1 * y2 - y1 * x2

    valid = torch.abs(denominator) >= epsilon
    safe_value = torch.ones_like(denominator)
    inv_den = 1.0 / torch.where(valid, denominator, safe_value)

    u = torch.where(valid, (x2 * (y1s - y2s) - y2 * (x1s - x2s)) * inv_den,
                    safe_value)
    v = torch.where(valid, (y1 * (x2s - x1s) - x1 * (y2s - y1s)) * inv_den,
                    safe_value)
    x = x1s + u * x1
    y = y1s + u * y1
    return x, y, valid, u, v


def _first(a):
    """The first set of an N x M wrapper as a (1, N) row."""
    return torch.as_tensor(a)[None, :]


def _second(a):
    """The second set of an N x M wrapper as an (M, 1) column."""
    return torch.as_tensor(a)[:, None]


def line_intersect(x1s, y1s, x1e, y1e, x2s, y2s, x2e, y2e, epsilon=None):
    """Every intersection of N lines (set 1) with M lines (set 2) by
    :func:`raw_line_intersect`; each output is (M, N), set 2 on axis 0."""
    return raw_line_intersect(
        _first(x1s), _first(y1s), _first(x1e), _first(y1e),
        _second(x2s), _second(y2s), _second(x2e), _second(y2e), epsilon)


def raw_line_circle_intersect(xs, ys, xe, ye, xc, yc, r, epsilon=None):
    """Infinite line/circle intersection on co-broadcastable tensors.

    Returns ``(plus, minus)``, one dict per quadratic branch with keys
    ``x, y, valid, u, v`` (``v`` the polar angle of the hit about the
    centre).  A tiny discriminant (|rad| < epsilon) snaps to 0 so both
    branches meet at the tangent point; a degenerate line (a ~ 0) is
    invalid.  Everything is promoted to one dtype first: a float32 ``1 / r``
    in a float64 solve would put a ray that starts on the circle off it."""
    xs, ys, xe, ye, xc, yc, r = _common(xs, ys, xe, ye, xc, yc, r)
    if epsilon is None:
        epsilon = default_epsilon(xs.dtype)

    inverse_r = 1.0 / r
    xr = (xs - xc) * inverse_r
    yr = (ys - yc) * inverse_r
    xd = (xe - xs) * inverse_r
    yd = (ye - ys) * inverse_r

    a = xd * xd + yd * yd
    b = 2.0 * xr * xd + 2.0 * yr * yd
    # b^2 - 4 a (|x_r|^2 - 1) as 4 (a - (x_r x d_r)^2), the same quantity
    # without its cancellation: b^2 and 4 a c are ~(|o - c| |d| / r^2)^2
    # each, so a ray starting D radii from the centre would lose ~2 log10(D)
    # digits (float32 noise at the light guide's lenslets, D ~ 13000).  The
    # CUDA arc searches use the same form.
    cross = xr * yd - yr * xd
    rad = 4.0 * (a - cross * cross)

    # tangent: snap a tiny radicand to exactly zero
    rad = torch.where(torch.abs(rad) < epsilon, torch.zeros_like(rad), rad)

    # no intersection: rad < 0
    safe_value = torch.ones_like(a)
    rad_neg = rad < 0
    branch_valid = ~rad_neg
    safe_rad = torch.sqrt(torch.where(rad_neg, safe_value, rad))
    uminus = torch.where(rad_neg, safe_value, -b - safe_rad)
    uplus = torch.where(rad_neg, safe_value, -b + safe_rad)

    # degenerate line: a ~ 0 (start == end)
    azero = torch.abs(a) < epsilon
    inv_den = 1.0 / torch.where(azero, safe_value, 2.0 * a)
    valid = branch_valid & ~azero
    uminus = torch.where(azero, safe_value, uminus * inv_den)
    uplus = torch.where(azero, safe_value, uplus * inv_den)

    xminus = xs + (xe - xs) * uminus
    xplus = xs + (xe - xs) * uplus
    yminus = ys + (ye - ys) * uminus
    yplus = ys + (ye - ys) * uplus
    vminus = torch.atan2(yminus - yc, xminus - xc)
    vplus = torch.atan2(yplus - yc, xplus - xc)
    return (
        {"x": xplus, "y": yplus, "valid": valid, "u": uplus, "v": vplus},
        {"x": xminus, "y": yminus, "valid": valid, "u": uminus, "v": vminus},
    )


def line_circle_intersect(xs, ys, xe, ye, xc, yc, r, epsilon=None):
    """Every intersection of N lines with M circles by
    :func:`raw_line_circle_intersect`; each output is (M, N), the circles
    on axis 0.

    The radicand is the port's 4 (a - (x_r x d_r)^2), not the JAX
    package's b^2 - 4ac: the same quantity without the cancellation that
    costs ~2 log10(D) digits for a line D radii from the centre.  The two
    agree to rounding only for lines a few radii from the circle; far from
    it the port's value is the accurate one."""
    return raw_line_circle_intersect(
        _first(xs), _first(ys), _first(xe), _first(ye),
        _second(xc), _second(yc), _second(r), epsilon)


def _safe_direction_2d(dx, dy):
    """(1, 0) in place of a degenerate direction, so atan2's partials stay
    finite.  Every slot runs through the reaction and is masked afterwards,
    and d/dx atan2(0, 0) is NaN: a masked slot would poison the gradient of
    the whole batch (``where`` blocks a cotangent, not the NaN the unused
    branch's backward makes)."""
    eps = torch.finfo(dx.dtype).eps
    degenerate = (dx * dx + dy * dy) < eps * eps
    return (torch.where(degenerate, torch.ones_like(dx), dx),
            torch.where(degenerate, torch.zeros_like(dy), dy))


def snells_law_2D(x_start, y_start, x_end, y_end, norm, n_in, n_out,
                  new_ray_length):
    """2D optical reaction (refract, reflect on a mirror or by total
    internal reflection), angle form.  Each ray ends on the surface;
    ``norm`` is the absolute angle of the surface normal and ``n_in == 0``
    marks a mirror.  Returns the child ray's endpoints."""
    norm = torch.remainder(norm, 2 * PI)
    dx, dy = _safe_direction_2d(x_start - x_end, y_start - y_end)
    ray_angle = torch.remainder(torch.atan2(dy, dx), 2 * PI)
    theta1 = norm - ray_angle
    theta1 = torch.where(theta1 > PI, theta1 - 2 * PI, theta1)
    theta1 = torch.where(theta1 < -PI, theta1 + 2 * PI, theta1)

    internal_mask = torch.abs(theta1) >= PI / 2

    zero = torch.zeros_like(theta1)
    n_in = torch.as_tensor(n_in, dtype=theta1.dtype,
                           device=theta1.device).expand_as(theta1)
    n_out = torch.as_tensor(n_out, dtype=theta1.dtype,
                            device=theta1.device).expand_as(theta1)
    n = select_eta(n_in, n_out, internal_mask)

    norm = torch.where(internal_mask, norm, norm + PI)
    theta1 = torch.where(internal_mask, theta1 + PI, theta1)

    theta2 = n * torch.sin(theta1)
    # refract when |sin(theta2)| <= 1 and not a mirror, else reflect; the
    # double where keeps the unused arcsin branch's gradient finite
    refracts = (torch.abs(theta2) <= 1.0) & (n != 0.0)
    safe_theta2 = torch.where(refracts, theta2, zero)
    # d/dx arcsin(x) is infinite at |x| == 1 (exactly critical incidence
    # passes the <= 1 test); a clamp by one eps bounds it
    lim = 1.0 - torch.finfo(theta2.dtype).eps
    safe_theta2 = torch.clamp(safe_theta2, -lim, lim)
    new_angle = torch.where(refracts, norm - torch.arcsin(safe_theta2),
                            norm + theta1 + PI)

    x_end_new = x_end + new_ray_length * torch.cos(new_angle)
    y_end_new = y_end + new_ray_length * torch.sin(new_angle)
    return x_end, y_end, x_end_new, y_end_new


def angle_in_interval(angle, start, end):
    """True where ``angle`` lies in the closed counter-clockwise interval
    ``[start, end]``; safe across the wrap for inputs in [-pi, pi]."""
    reduced_angle = angle - start
    reduced_angle = torch.where(reduced_angle < 0.0, reduced_angle + 2 * PI,
                                reduced_angle)
    reduced_end = end - start
    reduced_end = torch.where(reduced_end < 0.0, reduced_end + 2 * PI,
                              reduced_end)
    return reduced_angle <= reduced_end


# ======================================================================
# 3D
# ======================================================================


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


def line_triangle_intersect(
    rx1, ry1, rz1, rx2, ry2, rz2, xp, yp, zp, x1, y1, z1, x2, y2, z2, epsilon=None
):
    """Every intersection of N lines with M triangles by
    :func:`raw_line_triangle_intersect`; each output is (M, N), the
    triangles on axis 0."""
    f, s = _first, _second
    return raw_line_triangle_intersect(
        f(rx1), f(ry1), f(rz1), f(rx2), f(ry2), f(rz2),
        s(xp), s(yp), s(zp), s(x1), s(y1), s(z1), s(x2), s(y2), s(z2), epsilon)


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


def snells_law_3D(x_start, y_start, z_start, x_end, y_end, z_end, norm,
                  n_in, n_out, new_ray_length):
    """3D optical reaction, vector formulation, on per-coordinate (N,)
    tensors: refract, reflect on a mirror (``n_in == 0``) or on total
    internal reflection.  ``norm`` is an (N, 3) normal (need not be unit).
    Returns the six child-ray coordinates; :func:`snell_3d_vec` is the same
    math on (N, 3) endpoints."""
    p0 = torch.stack([x_start, y_start, z_start], dim=1)
    p1 = torch.stack([x_end, y_end, z_end], dim=1)
    n_in = torch.as_tensor(n_in, dtype=p0.dtype, device=p0.device)
    n_out = torch.as_tensor(n_out, dtype=p0.dtype, device=p0.device)
    _, new_end = snell_3d_vec(p0, p1, norm, n_in.reshape(-1),
                              n_out.reshape(-1), new_ray_length)
    return (x_end, y_end, z_end, new_end[:, 0], new_end[:, 1],
            new_end[:, 2])


def transverse_basis(u):
    """Orthonormal frame ``(t1, t2)`` transverse to unit directions ``u``
    (N, 3): ``t1 = normalize(u x e_k)`` with ``e_k`` the coordinate axis
    least aligned with each ``u`` (the first such axis on a tie),
    ``t2 = u x t1``.  Shared by polarization basis seeding and rough-surface
    scattering."""
    tiny = torch.finfo(u.dtype).tiny
    axis = torch.nn.functional.one_hot(torch.argmin(torch.abs(u), dim=-1),
                                       3).to(u.dtype)
    t1 = torch.linalg.cross(u, axis, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                          min=tiny)
    t2 = torch.linalg.cross(u, t1, dim=-1)
    return t1, t2


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
