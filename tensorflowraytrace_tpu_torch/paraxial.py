"""Paraxial (first-order) and third-order analysis of sequential asphere
stacks.

Counterpart of ``tensorflowraytrace_tpu/paraxial.py``: y-nu (ABCD) tracing
gives focal lengths, cardinal points, image conjugates, the Petzval sum,
the Seidel sums, stop and pupil solves, colour, Gaussian beams, and (with
real rays from :func:`sequential.trace_sequential`) field curves, all from
the :class:`~tensorflowraytrace_tpu_torch.sequential.AsphereStack` the real
tracer takes, all differentiable in every prescription entry.

Formulation: the state vector is ``(y, omega)`` with ``omega = n u`` the
reduced angle, so a transfer by axial distance ``t`` in index ``n`` is
``[[1, t/n], [0, 1]]`` and a refraction of power ``phi = (n' - n) c`` is
``[[1, 0], [-phi, 1]]``.  Mirrors use signed indices (``n' = -n``).  The
JAX package's ``lax.scan`` over surfaces is a Python loop of 2 x 2
products over K here, and its ``vmap`` over wavelengths a loop over them.

Sign conventions are :mod:`sequential`'s: the axis is +z, a surface is
``z = vertex_z + sag(r)``, ``c = 1/R`` is positive when the centre of
curvature lies toward +z.  Cardinal points are absolute z coordinates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tensorflowraytrace_tpu_torch.ops.materials import material_index_lookup
from tensorflowraytrace_tpu_torch.sequential import (
    AsphereStack, trace_sequential,
)


def _scalar(x, like):
    """``x`` as a tensor of ``like``'s dtype on its device (a tensor that
    already is one is returned as it is, its graph kept)."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _signed_indices(stack: AsphereStack, materials, wavelength, start_mat):
    """Signed refractive index before and after each surface: ``(n_in,
    n_out)``, each (K,).  The sign is the mirror parity: after each
    reflective surface the index flips sign, so the reduced transfer
    ``t / n`` of a backward-travelling segment is positive again."""
    vz = stack.vertex_z
    dtype, device = vz.dtype, vz.device
    n = stack.n_surfaces
    wl = torch.broadcast_to(_scalar(wavelength, vz), (n,))
    n_after_raw = material_index_lookup(materials, wl, stack.mat_after)
    n_start = material_index_lookup(
        materials, wl[:1],
        torch.full((1,), start_mat, dtype=torch.int32, device=device))[0]

    # sign AFTER surface i = (-1)^(number of mirrors among surfaces 0..i)
    flip = torch.where(stack.mirror, -1.0, 1.0).to(dtype)
    sign_after = torch.cumprod(flip, dim=0)
    sign_before = torch.cat([torch.ones((1,), dtype=dtype, device=device),
                             sign_after[:-1]])

    # unsigned index after surface i: mirror rows keep the incoming medium
    # (they must not consult mat_after, which may be the n = 0 reflective
    # sentinel); refractive rows take the lookup
    carry, unsigned = n_start, []
    for i in range(n):
        carry = torch.where(stack.mirror[i], carry, n_after_raw[i])
        unsigned.append(carry)
    n_unsigned = torch.stack(unsigned)
    n_unsigned_before = torch.cat([n_start[None], n_unsigned[:-1]])
    return sign_before * n_unsigned_before, sign_after * n_unsigned


@dataclass
class ParaxialSystem:
    """First-order description of a stack: the vertex-to-vertex ABCD matrix
    acting on ``(y, n u)``, the bracketing (signed) indices and the vertex
    coordinates that turn it into cardinal points.  All 0-d tensors; every
    property is differentiable."""

    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    D: torch.Tensor
    n_obj: torch.Tensor    # signed index of object space
    n_img: torch.Tensor    # signed index of image space (negative after an
                           # odd number of mirrors)
    z_front: torch.Tensor  # first vertex z
    z_back: torch.Tensor   # last vertex z

    @property
    def power(self):
        """System power ``phi = -C``; EFL = 1/phi."""
        return -self.C

    @property
    def efl(self):
        """Effective focal length 1/power."""
        return 1.0 / self.power

    @property
    def back_focal_point(self):
        """z of the rear focal point F' (where an axis-parallel input ray
        crosses the axis)."""
        return self.z_back - self.n_img * self.A / self.C

    @property
    def front_focal_point(self):
        """z of the front focal point F (rays from it exit axis-parallel)."""
        return self.z_front + self.n_obj * self.D / self.C

    @property
    def back_principal_plane(self):
        """z of the rear principal plane P' (F' minus ``n_img / power``)."""
        return self.back_focal_point - self.n_img / self.power

    @property
    def front_principal_plane(self):
        """z of the front principal plane P (F plus ``n_obj / power``)."""
        return self.front_focal_point + self.n_obj / self.power

    @property
    def back_nodal_point(self):
        """z of N' (unit angular magnification)."""
        return self.back_focal_point - self.n_obj / self.power

    @property
    def front_nodal_point(self):
        return self.front_focal_point + self.n_img / self.power

    def image_distance(self, z_obj):
        """z of the paraxial image of an axial object point at ``z_obj``:
        the conjugate plane where the object-to-image B element vanishes."""
        z_obj = _scalar(z_obj, self.A)
        t1 = (self.z_front - z_obj) / self.n_obj
        denom = self.C * t1 + self.D
        t2 = -(self.A * t1 + self.B) / denom
        return self.z_back + t2 * self.n_img

    def magnification(self, z_obj):
        """Transverse magnification at the conjugate of ``z_obj``: the A
        element of the object-to-image matrix."""
        z_img = self.image_distance(z_obj)
        t2 = (z_img - self.z_back) / self.n_img
        return self.A + t2 * self.C


def paraxial_system(stack: AsphereStack, materials, wavelength,
                    start_mat=0) -> ParaxialSystem:
    """The vertex-to-vertex ABCD matrix of the stack at one wavelength."""
    vz = stack.vertex_z
    n_in, n_out = _signed_indices(stack, materials, wavelength, start_mat)
    phi = (n_out - n_in) * stack.c
    # the transfer BEFORE surface i (0 for the first surface)
    tau = torch.diff(vz, prepend=vz[:1]) / n_in
    a = torch.ones((), dtype=vz.dtype, device=vz.device)
    b = torch.zeros((), dtype=vz.dtype, device=vz.device)
    c, d = b, a
    for i in range(stack.n_surfaces):
        # refraction([[1, 0], [-phi, 1]]) @ transfer([[1, tau], [0, 1]]) @ M
        a = a + tau[i] * c
        b = b + tau[i] * d
        c = c - phi[i] * a
        d = d - phi[i] * b
    return ParaxialSystem(A=a, B=b, C=c, D=d, n_obj=n_in[0], n_img=n_out[-1],
                          z_front=vz[0], z_back=vz[-1])


def paraxial_trace(y0, u0, stack: AsphereStack, materials, wavelength,
                   start_mat=0, z_start=None):
    """y-nu trace: the height at each surface and the real (unreduced) ray
    angle after it.

    ``y0``/``u0``: scalar or (N,) height and angle at ``z_start`` (default:
    the first vertex plane).  Returns ``(y, u)``, each (K, N), or (K,) for
    scalar input."""
    vz = stack.vertex_z
    y0, u0 = _scalar(y0, vz), _scalar(u0, vz)
    scalar = y0.ndim == 0 and u0.ndim == 0
    y0, u0 = torch.broadcast_tensors(torch.atleast_1d(y0),
                                     torch.atleast_1d(u0))

    n_in, n_out = _signed_indices(stack, materials, wavelength, start_mat)
    phi = (n_out - n_in) * stack.c
    start = vz[0] if z_start is None else _scalar(z_start, vz)
    tau = torch.diff(vz, prepend=start.reshape(1)) / n_in

    y, w = y0, n_in[0] * u0
    ys, us = [], []
    for i in range(stack.n_surfaces):
        y = y + tau[i] * w
        w = w - phi[i] * y
        ys.append(y)
        us.append(w / n_out[i])
    ys, us = torch.stack(ys), torch.stack(us)
    if scalar:
        return ys[:, 0], us[:, 0]
    return ys, us


def petzval_sum(stack: AsphereStack, materials, wavelength, start_mat=0):
    """The Petzval sum ``sum_i c_i (n_i' - n_i) / (n_i' n_i)`` (signed
    indices).  The paraxial image surface curvature in the absence of
    astigmatism is ``-n_img * petzval_sum``."""
    n_in, n_out = _signed_indices(stack, materials, wavelength, start_mat)
    return torch.sum(stack.c * (n_out - n_in) / (n_out * n_in))


@dataclass
class SeidelSums:
    """Third-order (Seidel) wavefront aberration sums in Welford's
    convention (*Aberrations of Optical Systems*, 1986, ch. 8): ``S1``
    spherical, ``S2`` coma, ``S3`` astigmatism, ``S4`` Petzval, ``S5``
    distortion; ``C1``/``C2`` axial/lateral colour (zeros without a
    wavelength pair); ``H`` the Lagrange invariant.  ``per_surface`` is the
    (K, 7) table of contributions (columns S1..S5, C1, C2).

    Their relations to real ray errors at the paraxial image plane are
    those of the JAX package's ``SeidelSums`` (``n'``/``u'`` the signed
    image-space index and marginal slope, ``rho`` the relative pupil
    height): ``eps_y = S1 rho^3 / (2 n' u')`` on axis; sagittal and
    tangential focus shifts ``-(S3 + S4)/(2 n' u'^2)`` and ``-(3 S3 +
    S4)/(2 n' u'^2)``; the short-to-long focus shift ``-C1 / (n' u'^2)``."""

    S1: torch.Tensor
    S2: torch.Tensor
    S3: torch.Tensor
    S4: torch.Tensor
    S5: torch.Tensor
    C1: torch.Tensor
    C2: torch.Tensor
    H: torch.Tensor
    per_surface: torch.Tensor


def seidel_sums(stack: AsphereStack, materials, wavelength, marginal, chief,
                z_start, start_mat=0, chromatic=None) -> SeidelSums:
    """The Seidel sums of a stack from its two defining paraxial rays.

    ``marginal``/``chief``: ``(y0, u0)`` of the paraxial marginal and chief
    rays at the plane ``z_start`` (in the ``start_mat`` medium);
    ``chromatic``: an optional ``(wl_short, wl_long)`` pair for the colour
    sums C1/C2 about the base ``wavelength``.

    Per-surface refraction invariants ``A = n (u + y c)`` give Welford's
    sums; the even asphere's fourth-order figure deviation ``G = k c^3 / 8
    + a4`` adds the aspheric terms ``8 G y^(4-m) ybar^m (n' - n)``."""
    vz = stack.vertex_z
    dtype = vz.dtype
    n_in, n_out = _signed_indices(stack, materials, wavelength, start_mat)
    if chromatic is not None:
        wl_s, wl_l = chromatic
        ns_in, ns_out = _signed_indices(stack, materials, wl_s, start_mat)
        nl_in, nl_out = _signed_indices(stack, materials, wl_l, start_mat)
        dn_in, dn_out = ns_in - nl_in, ns_out - nl_out
    else:
        dn_in = dn_out = torch.zeros_like(n_in)

    z_start = _scalar(z_start, vz)
    tau = torch.diff(vz, prepend=z_start.reshape(1)) / n_in
    phi = (n_out - n_in) * stack.c
    # fourth-order figure deviation from the osculating sphere
    a4 = (stack.coeffs[:, 0] if stack.coeffs.shape[1] > 0
          else torch.zeros_like(vz))
    g4 = stack.k * stack.c ** 3 / 8.0 + a4

    y, u0 = (_scalar(v, vz) for v in marginal)
    yb, ub0 = (_scalar(v, vz) for v in chief)
    w = n_in[0] * u0
    wb = n_in[0] * ub0
    h = w * yb - wb * y   # Welford's H
    tiny = torch.finfo(dtype).tiny * 1e4

    rows = []
    for i in range(stack.n_surfaces):
        c_i, n1, n2 = stack.c[i], n_in[i], n_out[i]
        # transfer to the surface
        y = y + tau[i] * w
        yb = yb + tau[i] * wb
        # refraction invariants A = n u + n y c = w + n y c
        a_ = w + n1 * y * c_i
        ab = wb + n1 * yb * c_i
        w2 = w - phi[i] * y
        wb2 = wb - phi[i] * yb
        d_un = w2 / (n2 * n2) - w / (n1 * n1)
        d_inv = 1.0 / n2 - 1.0 / n1
        dn_term = dn_out[i] / n2 - dn_in[i] / n1

        s1 = -(a_ * a_) * y * d_un
        s2 = -(a_ * ab) * y * d_un
        s3 = -(ab * ab) * y * d_un
        s4 = -(h * h) * c_i * d_inv
        a_ok = torch.abs(a_) > tiny
        safe_a = torch.where(a_ok, a_, 1.0)
        ratio = torch.where(a_ok, ab / safe_a, 0.0)
        s5 = ratio * (s3 + s4)
        # the aspheric fourth-order figure terms
        asph = 8.0 * g4[i] * (n2 - n1)
        s1 = s1 + asph * y ** 4
        s2 = s2 + asph * y ** 3 * yb
        s3 = s3 + asph * y ** 2 * yb ** 2
        s5 = s5 + asph * y * yb ** 3
        # chromatic (Welford 8.29): C1 = sum A y Delta(dn/n), likewise C2
        c1 = a_ * y * dn_term
        c2 = ab * y * dn_term
        rows.append(torch.stack([s1, s2, s3, s4, s5, c1, c2]))
        w, wb = w2, wb2
    rows = torch.stack(rows)
    tot = torch.sum(rows, dim=0)
    return SeidelSums(S1=tot[0], S2=tot[1], S3=tot[2], S4=tot[3], S5=tot[4],
                      C1=tot[5], C2=tot[6], H=h, per_surface=rows)


@dataclass
class StopSolve:
    """The two defining paraxial rays and the pupil positions for a chosen
    aperture stop (see :func:`solve_stop`)."""

    marginal: tuple              # (y0, u0) at z_start
    chief: tuple                 # (y0, u0) at z_start
    entrance_pupil: torch.Tensor  # z of the stop's image in object space
    exit_pupil: torch.Tensor      # z of the stop's image in image space


def solve_stop(stack: AsphereStack, materials, wavelength, stop_index,
               aperture, field_angle=0.0, z_start=None, start_mat=0):
    """The classical stop problem: given which surface (``stop_index``, a
    Python int) is the aperture stop, the marginal and chief rays (ready
    for :func:`seidel_sums`) and the entrance and exit pupil positions.

    ``aperture``: the marginal ray height at the stop; ``field_angle``: the
    object-space chief slope (object at infinity); ``z_start``: the plane
    of the returned ray states (default: the first vertex minus 1).

    Heights at the stop are affine in the launch height, so two probe
    traces solve each ray.  A pupil of a telecentric space is at inf."""
    vz = stack.vertex_z
    dtype = vz.dtype
    z_start = vz[0] - 1.0 if z_start is None else _scalar(z_start, vz)
    field_angle = _scalar(field_angle, vz)
    aperture = _scalar(aperture, vz)

    def height_at_stop(y0, u0):
        ys, _ = paraxial_trace(y0, u0, stack, materials, wavelength,
                               start_mat=start_mat, z_start=z_start)
        return ys[stop_index]

    one = torch.ones((), dtype=dtype, device=vz.device)
    zero = torch.zeros((), dtype=dtype, device=vz.device)
    # marginal: collimated from the axial object point at infinity;
    # y_stop is linear in y0, so one probe scales
    h1 = height_at_stop(one, zero)
    y0_marg = aperture / h1
    # chief: slope fixed at the field angle; y_stop affine in y0
    b = height_at_stop(zero, field_angle)
    y0_chief = -b / h1

    # pupils from the chief line: its object-space crossing at z_start,
    # its image-space crossing from the exit state
    eps = torch.finfo(dtype).tiny * 1e8
    fa_ok = torch.abs(field_angle) > eps
    safe_u0 = torch.where(fa_ok, field_angle, 1.0)
    z_ep = torch.where(fa_ok, z_start - y0_chief / safe_u0, float("inf"))
    ys_c, us_c = paraxial_trace(y0_chief, field_angle, stack, materials,
                                wavelength, start_mat=start_mat,
                                z_start=z_start)
    y_exit, u_exit = ys_c[-1], us_c[-1]
    ue_ok = torch.abs(u_exit) > eps
    safe_ue = torch.where(ue_ok, u_exit, 1.0)
    z_xp = torch.where(ue_ok, vz[-1] - y_exit / safe_ue, float("inf"))
    return StopSolve(marginal=(y0_marg, zero), chief=(y0_chief, field_angle),
                     entrance_pupil=z_ep, exit_pupil=z_xp)


def _per_wavelength(fn, wavelengths, like):
    """``fn(wl)`` for each entry of ``wavelengths``, stacked."""
    wavelengths = torch.atleast_1d(_scalar(wavelengths, like))
    return torch.stack([fn(wl) for wl in wavelengths.unbind(0)])


def axial_color(stack: AsphereStack, materials, wavelengths, start_mat=0):
    """The back-focal-point z at each wavelength: the axial (longitudinal)
    chromatic aberration curve."""
    return _per_wavelength(
        lambda wl: paraxial_system(stack, materials, wl,
                                   start_mat=start_mat).back_focal_point,
        wavelengths, stack.vertex_z)


def lateral_color(stack: AsphereStack, materials, wavelengths, chief,
                  z_start, z_image, start_mat=0):
    """The chief-ray image height at each wavelength: the lateral
    chromatic aberration curve.  ``chief``: ``(y0, u0)`` of the chief ray
    at ``z_start`` (e.g. from :func:`solve_stop`); ``z_image``: the image
    plane, fixed across wavelengths."""
    vz = stack.vertex_z
    y0, u0 = _scalar(chief[0], vz), _scalar(chief[1], vz)
    z_image = _scalar(z_image, vz)

    def height(wl):
        ys, us = paraxial_trace(y0, u0, stack, materials, wl,
                                start_mat=start_mat, z_start=z_start)
        return ys[-1] + us[-1] * (z_image - vz[-1])

    return _per_wavelength(height, wavelengths, vz)


@dataclass
class GaussianBeamResult:
    """The image-space TEM00 beam from :func:`gaussian_beam`: waist radius,
    absolute waist z, (in-medium) Rayleigh range, far-field half-angle
    divergence, and the signed image-space index."""

    waist: torch.Tensor
    z_waist: torch.Tensor
    rayleigh: torch.Tensor
    divergence: torch.Tensor
    n_img: torch.Tensor

    def width(self, z):
        """1/e^2 beam radius at plane ``z`` in image space:
        ``w(z) = w0 sqrt(1 + ((z - z_waist)/zR)^2)``."""
        dz = _scalar(z, self.waist) - self.z_waist
        return self.waist * torch.sqrt(1.0 + (dz / self.rayleigh) ** 2)


def gaussian_beam(stack: AsphereStack, materials, wavelength, waist, z_waist,
                  unit_scale=1e-6, start_mat=0) -> GaussianBeamResult:
    """Propagate a TEM00 Gaussian beam through the stack by the complex
    beam parameter (Siegman ch. 20).

    ``waist``/``z_waist``: the 1/e^2 waist radius and its absolute z in
    object space; ``wavelength`` in nm, ``unit_scale`` converting nm to the
    stack's length units (1e-6: mm).  The reduced parameter ``q^ = q / n``
    transforms under this module's ABCD as rays do:
    ``q^' = (A q^ + B) / (C q^ + D)``.  Differentiable in every
    prescription entry and in the input beam (autograd through the complex
    ``q``)."""
    vz = stack.vertex_z
    lam0 = _scalar(wavelength, vz) * unit_scale
    w0 = _scalar(waist, vz)
    z_w = _scalar(z_waist, vz)
    ps = paraxial_system(stack, materials, wavelength, start_mat=start_mat)

    # the reduced q at the front vertex
    q_re = (ps.z_front - z_w) / ps.n_obj
    q_im = math.pi * w0 ** 2 / lam0
    q = torch.complex(q_re, q_im)
    q2 = (ps.A * q + ps.B) / (ps.C * q + ps.D)

    # the image-space beam: transfer q^ -> q^ + (z - z_back)/n'
    z_waist_out = ps.z_back - ps.n_img * q2.real
    im = q2.imag          # = pi w0'^2 / lambda0, positive
    w0_out = torch.sqrt(lam0 * im / math.pi)
    zr_out = torch.abs(ps.n_img) * im
    div_out = lam0 / (math.pi * w0_out * torch.abs(ps.n_img))
    return GaussianBeamResult(waist=w0_out, z_waist=z_waist_out,
                              rayleigh=zr_out, divergence=div_out,
                              n_img=ps.n_img)


@dataclass
class FieldCurves:
    """Real-ray field curves from :func:`field_curves`: the tangential and
    sagittal focus z per field and the distortion curve, each (F,)."""

    field_angles: torch.Tensor
    z_image: torch.Tensor          # the paraxial image plane (baseline)
    tangential: torch.Tensor       # z of the tangential (meridional) focus
    sagittal: torch.Tensor         # z of the sagittal (skew) focus
    chief_height: torch.Tensor     # REAL chief-ray height at z_image
    paraxial_height: torch.Tensor  # first-order chief height at z_image
    distortion: torch.Tensor       # (real - paraxial) / paraxial


def field_curves(stack: AsphereStack, materials, wavelength, stop_index,
                 aperture, field_angles, z_start=None, rho=0.1,
                 start_mat=0) -> FieldCurves:
    """The classical field-curve analysis (real tangential and sagittal
    foci and distortion against field angle) in one sequential trace.

    For each field angle (object at infinity): the chief ray through the
    centre of the stop surface ``stop_index`` (the paraxial linear solve of
    :func:`solve_stop`); a meridional pair at pupil heights
    ``+-rho * aperture`` whose crossing is the tangential focus; a skew ray
    offset in x whose return to the meridional plane is the sagittal
    focus.  Four rays a field: the JAX package traces a fifth, the mirror
    image of the skew ray, and reads none of it; every output is the same.
    Distortion compares the real chief-ray height at the paraxial image
    plane with the first-order height.  Differentiable in every
    prescription entry and in ``field_angles``."""
    vz = stack.vertex_z
    dtype = vz.dtype
    z_start = vz[0] - 1.0 if z_start is None else _scalar(z_start, vz)
    thetas = torch.atleast_1d(_scalar(field_angles, vz))
    f_count = thetas.shape[0]

    z_img = paraxial_system(stack, materials, wavelength,
                            start_mat=start_mat).back_focal_point

    # the paraxial linear map to the stop: y_stop = a * y0 + b(theta)
    one = torch.ones((), dtype=dtype, device=vz.device)
    ys_a, _ = paraxial_trace(one, torch.zeros_like(one), stack, materials,
                             wavelength, start_mat=start_mat,
                             z_start=z_start)
    a = ys_a[stop_index]
    ys_b, _ = paraxial_trace(torch.zeros_like(thetas), thetas, stack,
                             materials, wavelength, start_mat=start_mat,
                             z_start=z_start)
    b = ys_b[stop_index]                                        # (F,)
    y0_chief = -b / a                                           # (F,)
    h = rho * _scalar(aperture, vz)
    y0_tan = (torch.stack([h, -h])[None, :] - b[:, None]) / a   # (F, 2)
    x0_sag = h / a

    # 4 rays a field: chief, tangential +-, sagittal (one flat trace)
    nr = torch.sqrt(1.0 + thetas ** 2)
    d_one = torch.stack([torch.zeros_like(thetas), thetas / nr, 1.0 / nr],
                        dim=1)                                  # (F, 3)
    zeros = torch.zeros_like(thetas)
    px = torch.stack([zeros, zeros, zeros,
                      torch.broadcast_to(x0_sag, thetas.shape)], dim=1)
    py = torch.stack([y0_chief, y0_tan[:, 0], y0_tan[:, 1], y0_chief],
                     dim=1)
    p = torch.stack([px, py, torch.broadcast_to(z_start, px.shape)],
                    dim=2)                                      # (F, 4, 3)
    d = torch.broadcast_to(d_one[:, None, :], (f_count, 4, 3))
    res = trace_sequential(p.reshape(-1, 3), d.reshape(-1, 3), wavelength,
                           stack, materials, start_mat=start_mat)
    pf = res.p.reshape(f_count, 4, 3)
    df = res.d.reshape(f_count, 4, 3)

    tiny = torch.finfo(dtype).tiny * 1e8

    def safe_div(num, den):
        ok = torch.abs(den) > tiny
        return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)

    # the chief height at the image plane
    s_chief = safe_div(df[:, 0, 1], df[:, 0, 2])
    y_real = pf[:, 0, 1] + (z_img - pf[:, 0, 2]) * s_chief
    ys_c, us_c = paraxial_trace(y0_chief, thetas, stack, materials,
                                wavelength, start_mat=start_mat,
                                z_start=z_start)
    y_par = ys_c[-1] + us_c[-1] * (z_img - vz[-1])
    distortion = safe_div(y_real - y_par, y_par)

    # tangential focus: the meridional crossing of the +-rho pair
    s1 = safe_div(df[:, 1, 1], df[:, 1, 2])
    s2 = safe_div(df[:, 2, 1], df[:, 2, 2])
    z_tan = safe_div(
        pf[:, 2, 1] - pf[:, 1, 1] - pf[:, 2, 2] * s2 + pf[:, 1, 2] * s1,
        s1 - s2)
    # sagittal focus: the skew ray re-crosses x = 0
    sx = safe_div(df[:, 3, 0], df[:, 3, 2])
    z_sag = pf[:, 3, 2] - safe_div(pf[:, 3, 0], sx)

    return FieldCurves(field_angles=thetas, z_image=z_img, tangential=z_tan,
                       sagittal=z_sag, chief_height=y_real,
                       paraxial_height=y_par, distortion=distortion)
