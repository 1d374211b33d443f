"""Export of trained surfaces.

Counterpart of ``export_boundary_stl`` in
``tensorflowraytrace_tpu/utils/checkpoint.py``; the save and restore of
parameters, optimizer state and generator state are not ported yet.
"""

from __future__ import annotations


def export_boundary_stl(boundary, params, filename):
    """Write ``boundary`` (a parametric triangle boundary or guide) at
    ``params`` to ``filename`` as binary STL; returns the file name."""
    boundary.updated_mesh(params).save(filename)
    return filename
