"""The even-asphere sag model, shared by every surface that uses it.

Counterpart of ``tensorflowraytrace_tpu/ops/asphere.py``: the
rotationally symmetric even-asphere sag

    sag(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) + a4 r^4 + a6 r^6 + ...

as a function of ``u = r^2``, and its analytic derivative ``d(sag)/du``.
The conic radicand is clamped from below (1e-8), so points past the conic's
natural aperture give finite values and gradients.  ``coeffs`` carries the
even polynomial coefficients ``a4, a6, ...`` (from r^4 on; the r^2 term is
the curvature) along its last axis, possibly of length 0.
"""

from __future__ import annotations

import torch

RADICAND_FLOOR = 1e-8


def sag(u, c, k, coeffs):
    """Even-asphere sag at ``u = r^2``; broadcasts over every argument."""
    rad = torch.clamp(1.0 - (1.0 + k) * (c * c) * u, min=RADICAND_FLOOR)
    s = c * u / (1.0 + torch.sqrt(rad))
    n_a = coeffs.shape[-1]
    if n_a:
        poly = coeffs[..., n_a - 1]
        for i in range(n_a - 2, -1, -1):
            poly = poly * u + coeffs[..., i]
        s = s + poly * u * u
    return s


def sag_du(u, c, k, coeffs):
    """Analytic ``d(sag)/du``.  With ``s = sqrt(1 - (1+k) c^2 u)``::

        d/du [c u / (1+s)] = c/(1+s) + c u (1+k) c^2 / (2 s (1+s)^2)

    plus ``sum (i+2) a_i u^(i+1)`` for the polynomial tail."""
    rad = torch.clamp(1.0 - (1.0 + k) * (c * c) * u, min=RADICAND_FLOOR)
    s = torch.sqrt(rad)
    one_p_s = 1.0 + s
    d = c / one_p_s + c * u * (1.0 + k) * (c * c) / (2.0 * s * one_p_s ** 2)
    n_a = coeffs.shape[-1]
    if n_a:
        dp = (n_a + 1) * coeffs[..., n_a - 1]
        for i in range(n_a - 2, -1, -1):
            dp = dp * u + (i + 2) * coeffs[..., i]
        d = d + dp * u
    return d
