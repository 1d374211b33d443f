"""Thin-film multilayer coatings: the characteristic-matrix method.

Counterpart of ``tensorflowraytrace_tpu/ops/thinfilm.py``.  Each optical
surface may carry a dielectric coating stack (anti-reflection,
high-reflection, beam-splitting) whose complex amplitude coefficients come
from the characteristic-matrix (Abeles) formalism [Macleod, "Thin-Film
Optical Filters", ch. 2]:

    per layer j:  delta_j = 2 pi n_j d_j cos(theta_j) / lambda
                  eta_j   = n_j cos(theta_j)        (s polarization)
                          = n_j / cos(theta_j)      (p polarization)
                  M_j = [[cos d_j,            i sin d_j / eta_j],
                         [i eta_j sin d_j,    cos d_j          ]]

    [B; C] = M_1 M_2 ... M_L [1; eta_sub]
    r = (eta_0 B - C) / (eta_0 B + C),     R = |r|^2,   T = 1 - R

(lossless real-index stacks, so T = 1 - R exactly; total internal
reflection comes out of the complex square roots: the substrate admittance
turns imaginary and |r| == 1).

Everything is elementwise over rays and differentiable through torch's
complex autograd, so coating thicknesses and layer indices can be
co-optimized with the lens geometry.  float64 works in complex128, float32
in complex64.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def _complex_dtype(real_dtype):
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def _real(x, like):
    """``x`` (a number or tensor) as a real tensor of ``like``'s dtype and
    device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def layer_cosine(n0, cos0, n_layer):
    """Complex propagation cosine in a layer from Snell's law:
    ``cos(theta_j) = sqrt(1 - (n0 sin(theta0) / n_j)^2)``.  The principal
    complex sqrt puts evanescent (TIR) waves on the +i branch (decaying
    into the stack)."""
    cos0 = torch.as_tensor(cos0)
    cdt = _complex_dtype(cos0.dtype)
    sin2 = (1.0 - cos0 * cos0) * (n0 / n_layer) ** 2
    # keep the argument off the branch point: sqrt'(0) is infinite, and
    # exactly critical incidence lands there.  A +i eps^2 shift bounds the
    # derivative and stays on the decaying-wave branch; the forward value
    # moves by at most eps.
    guard = 1j * torch.finfo(cos0.dtype).eps ** 2
    return torch.sqrt((1.0 - sin2).to(cdt) + guard)


def stack_rt(n0, n_sub, cos0, wavelength, layer_n, layer_d,
             layer_valid=None, pec_substrate=None):
    """Complex reflection AND transmission amplitudes of a multilayer stack.

    Returns ``(rs, rp, ts, tp)``.  The transmission amplitudes are
    POWER-NORMALIZED: ``t_norm = t sqrt(Re(eta_sub) / eta_0)`` with
    ``t = 2 eta_0 / (eta_0 B + C)``, so ``|t_norm|^2`` is the power
    transmittance and ``|r|^2 + |t_norm|^2 = 1`` for these lossless stacks.

    Limits: the empty stack gives the bare-Fresnel r and a real positive
    ``t_norm = sqrt(1 - r^2)``; under TIR ``Re(eta_sub) = 0`` so
    ``t_norm = 0`` and ``|r| = 1``.

    ``pec_substrate``: optional (N,) bool selecting rows whose substrate is
    a perfect electric conductor (the engine's n == 0 mirror sentinel).
    Those rows take the exact ``eta_sub -> inf`` limit,
    ``r = (eta_0 m12 - m22) / (eta_0 m12 + m22)``: the bare PEC gives
    ``r = -1`` for both polarizations and a coating adds its round-trip
    phase; ``t = 0``.  Without the flag, n_sub == 0 rows take admittance 0
    (bare ``r = +1``), which power-only callers use.  Other parameters are
    those of :func:`stack_r`.
    """
    return _stack_amplitudes(n0, n_sub, cos0, wavelength, layer_n, layer_d,
                             layer_valid, pec_substrate)


def stack_r(n0, n_sub, cos0, wavelength, layer_n, layer_d, layer_valid=None):
    """Complex reflection amplitudes (rs, rp) of a multilayer stack.

    Parameters
    ----------
    n0, n_sub : (N,) real
        Incident-side and substrate refractive indices.
    cos0 : (N,) real
        Incidence cosine (|cos theta_0|).
    wavelength : (N,) real
        Vacuum wavelength, same length unit as the thicknesses.
    layer_n, layer_d : (L, N) real
        Refractive index and physical thickness of each layer, ordered from
        the INCIDENT side toward the substrate.
    layer_valid : (L, N) bool, optional
        Mask of real layers; invalid slots behave as zero-thickness vacuum
        (identity matrices), which pads ragged per-surface stacks to one L.

    Returns ``(rs, rp)``, (N,) complex; ``R = |r|^2`` and ``T = 1 - R``.
    An empty stack (L == 0 or all-invalid) is the bare Fresnel interface
    n0 -> n_sub.
    """
    rs, rp, _, _ = _stack_amplitudes(n0, n_sub, cos0, wavelength, layer_n,
                                     layer_d, layer_valid)
    return rs, rp


def _stack_amplitudes(n0, n_sub, cos0, wavelength, layer_n, layer_d,
                      layer_valid=None, pec_substrate=None):
    cos0 = torch.as_tensor(cos0)
    dtype = cos0.dtype
    cdt = _complex_dtype(dtype)
    n0, n_sub = _real(n0, cos0), _real(n_sub, cos0)
    wavelength = _real(wavelength, cos0)
    one = torch.ones_like(cos0, dtype=cdt)

    def admittances(n, cos_c):
        n = n.to(cdt)
        return n * cos_c, n / cos_c  # (eta_s, eta_p)

    eta0_s, eta0_p = admittances(n0, cos0.to(cdt))
    # n == 0 mirror sentinel as the substrate: a raw layer_cosine would
    # compute (n0/0)^2 = inf -> NaN admittance; eta_sub = 0 gives B = m11,
    # C = m21 and for the bare stack r = 1 -> R = 1, the ideal mirror
    sub_mirror = n_sub == 0
    n_sub_safe = torch.where(sub_mirror, torch.ones_like(n_sub), n_sub)
    cos_sub = layer_cosine(n0, cos0, n_sub_safe)
    etas_s, etas_p = admittances(n_sub_safe, cos_sub)
    zero_c = torch.zeros_like(one)
    etas_s = torch.where(sub_mirror, zero_c, etas_s)
    etas_p = torch.where(sub_mirror, zero_c, etas_p)

    # characteristic matrix product, four (N,) complex entries per
    # polarization; L is small (unrolled)
    m11_s = m22_s = m11_p = m22_p = one
    m12_s = m21_s = m12_p = m21_p = zero_c
    L = int(layer_n.shape[0]) if layer_n.dim() else 0
    for j in range(L):
        nj = _real(layer_n[j], cos0)
        dj = _real(layer_d[j], cos0)
        cos_j = layer_cosine(n0, cos0, nj)
        delta = (TWO_PI * nj * dj / wavelength).to(cdt) * cos_j
        if layer_valid is not None:
            delta = torch.where(layer_valid[j], delta, torch.zeros_like(delta))
        c = torch.cos(delta)
        s = torch.sin(delta)
        e_s, e_p = admittances(nj, cos_j)
        # guard the 1/eta of padded slots (delta == 0 makes s == 0, so the
        # value is irrelevant, but 0/0 would still poison gradients)
        e_s = torch.where(torch.abs(e_s) > 0, e_s, one)
        e_p = torch.where(torch.abs(e_p) > 0, e_p, one)
        # layer matrix [[c, i s/eta], [i eta s, c]] multiplied on the right
        js_12 = 1j * s / e_s
        js_21 = 1j * e_s * s
        n11 = m11_s * c + m12_s * js_21
        n12 = m11_s * js_12 + m12_s * c
        n21 = m21_s * c + m22_s * js_21
        n22 = m21_s * js_12 + m22_s * c
        m11_s, m12_s, m21_s, m22_s = n11, n12, n21, n22
        jp_12 = 1j * s / e_p
        jp_21 = 1j * e_p * s
        n11 = m11_p * c + m12_p * jp_21
        n12 = m11_p * jp_12 + m12_p * c
        n21 = m21_p * c + m22_p * jp_21
        n22 = m21_p * jp_12 + m22_p * c
        m11_p, m12_p, m21_p, m22_p = n11, n12, n21, n22

    eps = torch.finfo(dtype).eps

    def coefs(m11, m12, m21, m22, eta0, etas):
        b = m11 + m12 * etas
        c = m21 + m22 * etas
        if pec_substrate is not None:
            # exact eta_sub -> inf limit: [B; C] ~ etas [m12; m22], and the
            # common etas cancels in r.  t is untouched: etas was forced to
            # 0 on these rows above, so the Re(etas) > 0 gate zeroes it
            b = torch.where(pec_substrate, m12, b)
            c = torch.where(pec_substrate, m22, c)
        den = eta0 * b + c
        den = torch.where(torch.abs(den) > 0, den, one)
        r = (eta0 * b - c) / den
        # power-normalized transmission: T = 4 eta0 Re(etas) / |den|^2
        # (Macleod 2.115; eta0 is real), so t_norm = t sqrt(Re(etas)/eta0).
        # Double-where the sqrt: under TIR / mirror substrates Re(etas) == 0
        # and sqrt'(0) = inf would NaN the zeroed cotangent of the untaken
        # branch; the eps^2 clamp bounds the derivative at near-critical
        # incidence on the taken branch
        t = 2.0 * eta0 / den
        re_s = torch.real(etas)
        pos = re_s > 0
        eta0_re = torch.clamp(torch.real(eta0), min=eps)
        scale = torch.sqrt(torch.where(pos, torch.clamp(re_s, min=eps * eps),
                                       torch.ones_like(re_s)) / eta0_re)
        t_norm = torch.where(pos, t * scale.to(t.dtype), torch.zeros_like(t))
        return r, t_norm

    rs, ts = coefs(m11_s, m12_s, m21_s, m22_s, eta0_s, etas_s)
    rp, tp = coefs(m11_p, m12_p, m21_p, m22_p, eta0_p, etas_p)
    return rs, rp, ts, tp


def stack_R_unpolarized(n0, n_sub, cos0, wavelength, layer_n, layer_d,
                        layer_valid=None):
    """Unpolarized power reflectance ``(|rs|^2 + |rp|^2) / 2`` of a stack
    (real-valued, the quantity coating-design losses minimize)."""
    rs, rp = stack_r(n0, n_sub, cos0, wavelength, layer_n, layer_d,
                     layer_valid)
    R = 0.5 * (torch.abs(rs) ** 2 + torch.abs(rp) ** 2)
    return R.to(torch.as_tensor(cos0).dtype)


def quarter_wave_thickness(n_layer, wavelength):
    """Physical thickness of a quarter-wave layer at normal incidence:
    ``d = lambda / (4 n)``, the classic AR/HR building block."""
    return wavelength / (4.0 * n_layer)
