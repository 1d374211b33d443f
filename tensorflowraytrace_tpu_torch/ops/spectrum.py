"""Wavelength -> RGB conversion (Dan Bruton's visible-spectrum algorithm)
and the named wavelength constants the examples use.

A copy of ``tensorflowraytrace_tpu/ops/spectrum.py`` (NumPy only; the port
imports nothing of the JAX package): the 380-780 nm colormap table for
colouring rays by wavelength, and a vectorized converter.  Implemented from
the published algorithm (http://www.physics.sfasu.edu/astro/color/spectra.html);
host-side visualization support, never on the device path.
"""

from __future__ import annotations

import numpy as np

GAMMA = 0.80

# Named wavelength constants (nm).
RED = 680.0
ORANGE = 620.0
YELLOW = 575.0
GREEN = 510.0
BLUE = 450.0
PURPLE = 400.0
RAINBOW_6 = [RED, ORANGE, YELLOW, GREEN, BLUE, PURPLE]

VISIBLE_MIN = 380.0
VISIBLE_MAX = 780.0


def wavelength_to_rgb(wl):
    """Vectorized wavelength[nm] -> (..., 3) RGB in [0, 1]."""
    wl = np.asarray(wl, dtype=np.float64)

    # intensity falloff toward the ends of the visible range
    factor = np.select(
        [wl > 700.0, wl < 420.0],
        [
            0.3 + 0.7 * (780.0 - wl) / 80.0,
            0.3 + 0.7 * (wl - 380.0) / 40.0,
        ],
        default=1.0,
    )

    r = np.select(
        [wl >= 580.0, wl >= 510.0, wl >= 440.0, wl >= 380.0],
        [1.0, (wl - 510.0) / 70.0, 0.0, (wl - 440.0) / -60.0],
        default=0.0,
    )
    g = np.select(
        [wl >= 645.0, wl >= 580.0, wl >= 490.0, wl >= 440.0],
        [0.0, (wl - 645.0) / -65.0, 1.0, (wl - 440.0) / 50.0],
        default=0.0,
    )
    b = np.select(
        [wl >= 510.0, wl >= 490.0, wl >= 380.0],
        [0.0, (wl - 510.0) / -20.0, 1.0],
        default=0.0,
    )

    rgb = np.stack([r, g, b], axis=-1) * factor[..., None]
    return np.clip(rgb, 0.0, 1.0) ** GAMMA


def rgb():
    """The 401-row table for wavelengths 380..780 nm, matching the shape of
    the reference's ``spectrumRGB.rgb()`` (used as a mpl ListedColormap)."""
    return wavelength_to_rgb(np.arange(380.0, 781.0))
