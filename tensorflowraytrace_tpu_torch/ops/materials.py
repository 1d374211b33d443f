"""Optical material dispersion models: callables wavelength[nm] -> n.

Counterpart of ``tensorflowraytrace_tpu/ops/materials.py`` (the reference's
Sellmeier / polynomial curves, same coefficients, same nm convention).
``reflective`` returns n = 0, the mirror sentinel consumed by Snell's law.
"""

from __future__ import annotations

import torch


def build_constant_material(n):
    """Material with a constant refractive index."""
    return lambda x: n * torch.ones_like(x)


def acrylic(x):
    return torch.sqrt(
        2.1778
        + 6.1209e-9 * x ** 2
        - 1.5004e-15 * x ** 4
        + 2.3678e4 * x ** -2
        - 4.2137e9 * x ** -4
        + 7.3417e14 * x ** -6
        - 4.5042e19 * x ** -8
    )


def crown_glass(x):
    return torch.sqrt(
        1
        + 1.1273555e0 * x ** 2 / (x ** 2 - 7.20341707e3)
        + 1.24412303e-1 * x ** 2 / (x ** 2 - 2.69835916e4)
        + 8.27100531e-1 * x ** 2 / (x ** 2 - 1.00384588e8)
    )


def flint_glass(x):
    return torch.sqrt(
        1
        + 1.34533359e0 * x ** 2 / (x ** 2 - 9.97743871e3)
        + 2.09073176e-1 * x ** 2 / (x ** 2 - 4.70450767e4)
        + 9.37357162e-1 * x ** 2 / (x ** 2 - 1.11886764e8)
    )


def fused_silica(x):
    return torch.sqrt(
        1
        + 6.961663e-1 * x ** 2 / (x ** 2 - 4.679148e3)
        + 4.079426e-1 * x ** 2 / (x ** 2 - 1.3512063e4)
        + 8.974794e-1 * x ** 2 / (x ** 2 - 9.7934002538e7)
    )


def polycarbonate(x):
    return torch.sqrt(1 + 1.4182e0 * x ** 2 / (x ** 2 - 2.1304e4))


def reflective(x):
    """Mirror sentinel: n = 0 selects the reflection branch in Snell's law."""
    return torch.zeros_like(x)


def soda_lime(x):
    return 1.5130e0 - 3.169e-9 * x ** 2 + 3.962e3 * x ** -2


def vacuum(x):
    return torch.ones_like(x)


def material_index_lookup(materials, wavelength, mat_idx):
    """Per-ray refractive index from a list of K material callables and
    per-ray int indices, as a select chain over the K evaluated curves.
    An out-of-range id gives NaN (the ray then dies at the engine's
    finite-child guard), never materials[0]."""
    out = materials[0](wavelength)
    for k, m in enumerate(materials[1:], start=1):
        out = torch.where(mat_idx == k, m(wavelength), out)
    in_range = (mat_idx >= 0) & (mat_idx < len(materials))
    return torch.where(in_range, out, torch.full_like(out, float("nan")))
