"""Drawable ray data from a trace.

Counterpart of ``history_rays`` in ``tensorflowraytrace_tpu/drawing.py``:
the per-bounce history of a ``TraceResult`` flattened into one dict of
NumPy arrays, the ray segments a drawer draws and
``system.OpticalEngine.all_rays`` returns.  The matplotlib drawers are not
ported yet.
"""

from __future__ import annotations

import numpy as np


def _host(t):
    return t.detach().cpu().numpy()


def history_rays(result, bounce=None):
    """Every ray segment of ``result``'s per-bounce history as one dict
    (``x_start``, ``y_start``, ``x_end``, ``y_end``, ``wavelength``, and
    ``z_start`` / ``z_end`` in 3D), bounce by bounce, each slot only for
    the bounces it was still live in; ``bounce`` picks one bounce."""
    if result.history_p0 is None:
        raise ValueError("trace was run without keep_history=True")
    p0 = _host(result.history_p0)
    p1 = _host(result.history_p1)
    alive = _host(result.history_alive)
    wl = np.broadcast_to(_host(result.rays.wavelength), alive.shape)
    if bounce is not None:
        sel = alive[bounce]
        return _ray_dict(p0[bounce][sel], p1[bounce][sel], wl[bounce][sel])
    mask = alive.reshape(-1)
    dim = p0.shape[-1]
    return _ray_dict(p0.reshape(-1, dim)[mask], p1.reshape(-1, dim)[mask],
                     wl.reshape(-1)[mask])


def _ray_dict(p0, p1, wl):
    out = {"x_start": p0[:, 0], "y_start": p0[:, 1],
           "x_end": p1[:, 0], "y_end": p1[:, 1], "wavelength": wl}
    if p0.shape[1] == 3:
        out["z_start"] = p0[:, 2]
        out["z_end"] = p1[:, 2]
    return out
