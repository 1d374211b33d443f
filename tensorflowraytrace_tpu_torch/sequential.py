"""Sequential analytic ray tracing: exact asphere intersections, no meshes.

Counterpart of ``tensorflowraytrace_tpu/sequential.py``.  Classical lens
design traces a known ordered stack of rotationally symmetric aspheres on
one axis, surface by surface and analytically (Spencer & Murty, JOSA 52,
1962): no search, no tessellation, hits to machine precision.

* The conic part has a closed-form quadratic intersection, solved with the
  sign-stable root pair; the even-asphere polynomial tail is refined by
  ``NEWTON_ITERS`` Newton steps on the sag implicit
  ``g(t) = z(t) - sag(r^2(t))``, a fixed unrolled count.
* The surface normal is the analytic gradient of the implicit.

The sag is ``ops.asphere.sag`` and ``sag_du``, the same as the tessellated
``models.boundaries.ParametricAsphereBoundary``'s::

    sag(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) + a4 r^4 + a6 r^6 + ...

The trace is a Python loop over the K surfaces of element-wise tensor
operations over the N rays.  It is written functionally (no in-place
operation on an input, nothing read back to the host, no branch on data),
so ``torch.autograd`` and ``torch.func.jacfwd`` both go through it, in
every stack field, the rays and ``image_z``.  Every division that a branch
may not take is guarded on both sides of its ``torch.where``: the untaken
branch still runs in the backward pass, and a NaN there would poison the
gradient.

Conventions: the optical axis is +z; a surface is ``z = vertex_z +
sag(r)``; rays travel toward +z (a mirror reverses them); each surface must
be hit at a parameter ``t > t_min`` or the ray dies (vignetting, a missed
surface, TIR): dead rays are frozen and reported by ``alive``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tensorflowraytrace_tpu_torch.config import resolve_device, resolve_dtype
from tensorflowraytrace_tpu_torch.ops.asphere import sag as _sag
from tensorflowraytrace_tpu_torch.ops.asphere import sag_du as _sag_du
from tensorflowraytrace_tpu_torch.ops.materials import material_index_lookup

NEWTON_ITERS = 8
GOLDEN_ANGLE = 2.399963229728653


def _device_of(device, *xs):
    """``device`` if given, else the device of the first tensor among
    ``xs``, else the default device."""
    if device is None:
        for x in xs:
            if isinstance(x, torch.Tensor):
                return x.device
    return resolve_device(device)


@dataclass
class AsphereStack:
    """K rotationally symmetric even-asphere surfaces on the z axis, each
    field with leading axis K.  Built from tensors that require grad, every
    prescription entry is differentiable."""

    vertex_z: torch.Tensor   # (K,) axis crossing of each vertex
    c: torch.Tensor          # (K,) curvature (1/R; 0 = plane)
    k: torch.Tensor          # (K,) conic constant
    coeffs: torch.Tensor     # (K, A) even coefficients a4, a6, ... (A >= 0)
    aperture: torch.Tensor   # (K,) semi-diameter; r > aperture vignettes
    mat_after: torch.Tensor  # (K,) int32 material index AFTER the surface
    mirror: torch.Tensor     # (K,) bool: reflect instead of refract

    @staticmethod
    def make(vertex_z, c, k=None, coeffs=None, aperture=None, mat_after=None,
             mirror=None, dtype=None, device=None):
        """A stack from per-surface values (scalars broadcast to K);
        ``device`` defaults to that of a tensor argument, else the
        default device."""
        dtype = resolve_dtype(dtype)
        device = _device_of(device, vertex_z, c, k, coeffs, aperture)
        vertex_z = torch.atleast_1d(
            torch.as_tensor(vertex_z, dtype=dtype, device=device))
        n = vertex_z.shape[0]

        def arr(x, default):
            if x is None:
                return torch.full((n,), default, dtype=dtype, device=device)
            return torch.broadcast_to(
                torch.as_tensor(x, dtype=dtype, device=device), (n,))

        if coeffs is None:
            coeffs = torch.zeros((n, 0), dtype=dtype, device=device)
        else:
            coeffs = torch.as_tensor(coeffs, dtype=dtype, device=device)
            if coeffs.ndim == 1:
                coeffs = torch.broadcast_to(coeffs[None, :],
                                            (n, coeffs.shape[0]))
        if mat_after is None:
            mat_after = torch.zeros((n,), dtype=torch.int32, device=device)
        else:
            mat_after = torch.broadcast_to(torch.as_tensor(
                mat_after, dtype=torch.int32, device=device), (n,))
        if mirror is None:
            mirror = torch.zeros((n,), dtype=torch.bool, device=device)
        else:
            mirror = torch.broadcast_to(torch.as_tensor(
                mirror, dtype=torch.bool, device=device), (n,))
        return AsphereStack(
            vertex_z=vertex_z, c=arr(c, 0.0), k=arr(k, 0.0), coeffs=coeffs,
            aperture=arr(aperture, float("inf")), mat_after=mat_after,
            mirror=mirror)

    @property
    def n_surfaces(self) -> int:
        return self.vertex_z.shape[0]


@dataclass
class SequentialResult:
    """Ray state after the stack (and the image-plane transfer if one was
    asked for)."""

    p: torch.Tensor      # (N, 3) final position
    d: torch.Tensor      # (N, 3) final unit direction
    opl: torch.Tensor    # (N,) accumulated optical path length
    n: torch.Tensor      # (N,) refractive index of the final medium
    alive: torch.Tensor  # (N,) bool: survived every surface

    @property
    def landing(self):
        """Transverse (x, y) at the final position."""
        return self.p[:, :2]


# ----------------------------------------------------------------------
# the intersection of one surface with all rays
# ----------------------------------------------------------------------

def _intersect_asphere(p, d, c, k, coeffs, t_min):
    """Exact intersection of rays ``p + t d`` (surface frame: the vertex at
    the origin) with ``z = sag(x^2 + y^2)``.

    Conic seed: the conic sheet through the vertex satisfies the quadric
    ``F = c r^2 + c (1+k) z^2 - 2 z = 0``, so ``A t^2 + B t + C = 0``,
    solved with the sign-stable root pair, which keeps the plane limit
    ``c -> 0`` (A -> 0) and grazing rays exact.  The vertex sheet is the
    root with ``1 - c (1+k) z >= 0``.  Newton then refines the polynomial
    tail on ``g(t) = z(t) - sag(r^2(t))``.

    Returns ``(t, ok)``; ``ok`` is False for a miss (no real root on the
    vertex sheet ahead of ``t_min``, or no converged hit)."""
    dtype = p.dtype
    eps = torch.finfo(dtype).tiny * 1e8
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    ck = c * (1.0 + k)
    a_ = c * (dx * dx + dy * dy) + ck * dz * dz
    b_ = 2.0 * (c * (px * dx + py * dy) + ck * pz * dz - dz)
    c_ = c * (px * px + py * py) + ck * pz * pz - 2.0 * pz

    disc = b_ * b_ - 4.0 * a_ * c_
    real = disc >= 0
    sq = torch.sqrt(torch.where(real, disc, 0.0))
    # sign-stable root pair; sign(0) := 1 so B = 0 still splits the roots
    sgn = torch.where(b_ >= 0, 1.0, -1.0).to(dtype)
    q = -0.5 * (b_ + sgn * sq)
    a_ok = torch.abs(a_) > eps
    q_ok = torch.abs(q) > eps
    safe_a = torch.where(a_ok, a_, 1.0)
    safe_q = torch.where(q_ok, q, 1.0)
    t1 = torch.where(a_ok, q / safe_a, float("inf"))
    t2 = torch.where(q_ok, c_ / safe_q, float("inf"))

    def score(t):
        z = pz + t * dz
        on_sheet = 1.0 - ck * z >= -1e-9
        ok = real & on_sheet & (t > t_min) & torch.isfinite(t)
        return torch.where(ok, t, float("inf"))

    t0 = torch.minimum(score(t1), score(t2))
    seed_ok = torch.isfinite(t0)
    t = torch.where(seed_ok, t0, 0.0)

    # Newton refinement (exact already for a pure conic; converges the
    # polynomial tail), unrolled
    for _ in range(NEWTON_ITERS):
        x = px + t * dx
        y = py + t * dy
        u = x * x + y * y
        g = pz + t * dz - _sag(u, c, k, coeffs)
        gp = dz - _sag_du(u, c, k, coeffs) * 2.0 * (x * dx + y * dy)
        gp_ok = torch.abs(gp) > eps
        safe_gp = torch.where(gp_ok, gp, 1.0)
        t = t - torch.where(gp_ok, g / safe_gp, 0.0)

    # the converged-hit audit: the residual small against the travel, the
    # hit still ahead of t_min
    x = px + t * dx
    y = py + t * dy
    u = x * x + y * y
    g = pz + t * dz - _sag(u, c, k, coeffs)
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    scale = 1.0 + torch.abs(t)
    ok = seed_ok & (t > t_min) & (torch.abs(g) < tol * scale)
    # inside the conic's natural aperture (the clamped radicand region is
    # not a real surface point)
    ok = ok & (1.0 - (1.0 + k) * (c * c) * u >= 0.0)
    return t, ok


def _surface_normal(x, y, u, c, k, coeffs):
    """Unit normal of ``z - sag(x^2 + y^2) = 0`` (+z-ish orientation)."""
    m = _sag_du(u, c, k, coeffs)
    nx = -2.0 * x * m
    ny = -2.0 * y * m
    nz = torch.ones_like(u)
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


# ----------------------------------------------------------------------
# the sequential trace
# ----------------------------------------------------------------------

def trace_sequential(p, d, wavelength, stack: AsphereStack, materials,
                     image_z=None, start_mat=0, t_min=1e-9,
                     decenter=None, tilt=None, dn=None):
    """Trace N rays through the K surfaces of ``stack`` in order.

    ``p``/``d``: (N, 3) origins and directions (``d`` is normalised here);
    ``wavelength``: (N,) or a scalar, nm; ``materials``: the list of
    n(wavelength) callables (``ops.materials``); ``start_mat``: the
    material index before the first surface; ``image_z``: an optional plane
    to transfer to after the last surface.

    ``decenter``, ``tilt`` and ``dn`` (surface decentres, tilts and index
    offsets) raise ``NotImplementedError``: the JAX package's
    ``trace_sequential`` accepts them and ignores them, and the port does
    not accept them silently.

    Returns a :class:`SequentialResult`.  Rays that miss a surface,
    vignette (``r > aperture``) or meet TIR at a refraction are marked dead
    and frozen.  Differentiable in every stack field, the rays and
    ``image_z``.
    """
    for name, value in (("decenter", decenter), ("tilt", tilt), ("dn", dn)):
        if value is not None:
            raise NotImplementedError(
                f"trace_sequential: {name}= is not implemented (the JAX "
                "package's trace_sequential ignores it)")
    dtype, device = p.dtype, p.device
    n_rays = p.shape[0]
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    wavelength = torch.broadcast_to(
        torch.as_tensor(wavelength, dtype=dtype, device=device), (n_rays,))
    n_cur = material_index_lookup(
        materials, wavelength,
        torch.full((n_rays,), start_mat, dtype=torch.int32, device=device))
    opl = torch.zeros((n_rays,), dtype=dtype, device=device)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=device)
    t_min = torch.as_tensor(t_min, dtype=dtype, device=device)
    floor = torch.as_tensor(torch.finfo(dtype).eps ** 2, dtype=dtype,
                            device=device)

    for i in range(stack.n_surfaces):
        vz, c, k = stack.vertex_z[i], stack.c[i], stack.k[i]
        coeffs, ap = stack.coeffs[i], stack.aperture[i]
        mirror = stack.mirror[i]
        shift = torch.stack([torch.zeros_like(vz), torch.zeros_like(vz), vz])

        local = p - shift
        t, ok = _intersect_asphere(local, d, c, k, coeffs, t_min)
        t = torch.where(ok, t, 0.0)
        hit_local = local + t[:, None] * d
        x, y = hit_local[:, 0], hit_local[:, 1]
        u = x * x + y * y
        ok = ok & (u <= ap * ap)

        nx, ny, nz = _surface_normal(x, y, u, c, k, coeffs)
        # orient the normal against the incoming ray: cos(theta_i) >= 0
        ndotd = nx * d[:, 0] + ny * d[:, 1] + nz * d[:, 2]
        flip = torch.where(ndotd > 0, -1.0, 1.0).to(dtype)
        nx, ny, nz = nx * flip, ny * flip, nz * flip
        cos_i = -(nx * d[:, 0] + ny * d[:, 1] + nz * d[:, 2])

        n2 = material_index_lookup(
            materials, wavelength,
            torch.broadcast_to(stack.mat_after[i], (n_rays,)))
        # the refraction branch must never divide by the n = 0 reflective
        # sentinel (mirror rows do not consult mat_after) or by a NaN
        # out-of-range lookup: sanitise the divisor first and kill
        # bad-index refractions below
        n2_ok = torch.isfinite(n2) & (n2 != 0)
        n2_safe = torch.where(n2_ok, n2, n_cur)
        eta = n_cur / n2_safe
        rad = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
        tir = rad < 0
        safe_rad = torch.maximum(torch.where(tir, 1.0, rad), floor)
        cos_t = torch.sqrt(safe_rad)
        coef = eta * cos_i - cos_t
        d_refr = torch.stack([eta * d[:, 0] + coef * nx,
                              eta * d[:, 1] + coef * ny,
                              eta * d[:, 2] + coef * nz], dim=1)
        two_nd = 2.0 * cos_i
        d_refl = torch.stack([d[:, 0] + two_nd * nx,
                              d[:, 1] + two_nd * ny,
                              d[:, 2] + two_nd * nz], dim=1)

        d_new = torch.where(mirror, d_refl, d_refr)
        n_new = torch.where(mirror, n_cur, n2_safe)
        ok = ok & (mirror | (~tir & n2_ok))

        step_alive = alive & ok
        hit = hit_local + shift
        sa = step_alive[:, None]
        p = torch.where(sa, hit, p)
        d = torch.where(sa, d_new, d)
        opl = torch.where(step_alive, opl + n_cur * t, opl)
        n_cur = torch.where(step_alive, n_new, n_cur)
        alive = step_alive

    if image_z is not None:
        image_z = torch.as_tensor(image_z, dtype=dtype, device=device)
        dz = d[:, 2]
        dz_ok = torch.abs(dz) > torch.finfo(dtype).tiny * 1e4
        safe_dz = torch.where(dz_ok, dz, 1.0)
        t_img = (image_z - p[:, 2]) / safe_dz
        go = alive & dz_ok
        p = torch.where(go[:, None], p + t_img[:, None] * d, p)
        opl = torch.where(go, opl + n_cur * t_img, opl)
        alive = go

    return SequentialResult(p=p, d=d, opl=opl, n=n_cur, alive=alive)


def collimated_bundle(n_rays, half_aperture, z_start=-1.0, field_angle=0.0,
                      azimuth=0.0, grid="line", dtype=None, device=None):
    """A collimated bundle of ``n_rays`` at ``field_angle`` radians off
    axis (rotated about the ``azimuth`` direction in the pupil), starting
    at ``z = z_start``.  ``grid="line"`` spans the meridional section;
    ``grid="hex"`` fills the pupil disk with a golden spiral.  Returns
    ``(p, d)``, each (N, 3)."""
    dtype = resolve_dtype(dtype)
    device = _device_of(device, field_angle, azimuth, half_aperture)
    if grid == "line":
        ys = torch.linspace(-half_aperture, half_aperture, n_rays,
                            dtype=dtype, device=device)
        xs = torch.zeros_like(ys)
    else:
        i = torch.arange(n_rays, dtype=dtype, device=device)
        r = half_aperture * torch.sqrt((i + 0.5) / n_rays)
        th = i * GOLDEN_ANGLE
        xs, ys = r * torch.cos(th), r * torch.sin(th)
    field_angle = torch.as_tensor(field_angle, dtype=dtype, device=device)
    azimuth = torch.as_tensor(azimuth, dtype=dtype, device=device)
    sf, cf = torch.sin(field_angle), torch.cos(field_angle)
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    d = torch.stack([torch.broadcast_to(-sf * sa, xs.shape),
                     torch.broadcast_to(sf * ca, xs.shape),
                     torch.broadcast_to(cf, xs.shape)], dim=1)
    p = torch.stack([xs, ys, torch.full_like(xs, z_start)], dim=1)
    return p, d
