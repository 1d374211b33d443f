"""Triangle meshes for building parametric surfaces, in NumPy.

A copy of the parts of ``tensorflowraytrace_tpu/models/mesh.py`` the 3D
lens path needs (that package imports JAX when it is imported, so nothing
is imported from it).  These tools run once at set-up time on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

PI = math.pi


@dataclass
class TriMesh:
    """A triangle mesh: ``points`` (V, 3) float64, ``faces`` (F, 3) int64.
    Face rows are counter-clockwise: the normal is cross(v1 - vp, v2 - v1)."""

    points: np.ndarray
    faces: np.ndarray

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(self.faces, dtype=np.int64).reshape(-1, 3)

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    def copy(self) -> "TriMesh":
        return TriMesh(self.points.copy(), self.faces.copy())

    def flip_faces(self) -> "TriMesh":
        """Reverse face orientation (flips all normals)."""
        return TriMesh(self.points.copy(), self.faces[:, ::-1].copy())


def as_trimesh(obj) -> TriMesh:
    """Coerce a mesh-like object to TriMesh: a TriMesh, any object with
    ``points`` and (F, 3) ``faces`` (or pyvista's flat [3, i, j, k, ...]
    faces), or a ``(points, faces)`` pair."""
    if isinstance(obj, TriMesh):
        return obj
    if hasattr(obj, "points") and hasattr(obj, "faces"):
        faces = np.asarray(obj.faces)
        if faces.ndim == 1:
            if faces.size % 4 != 0 or (faces.size and (faces[::4] != 3).any()):
                raise ValueError("as_trimesh: mesh has non-triangle faces")
            faces = faces.reshape(-1, 4)[:, 1:]
        return TriMesh(np.asarray(obj.points), faces)
    if isinstance(obj, (tuple, list)) and len(obj) == 2:
        return TriMesh(np.asarray(obj[0]), np.asarray(obj[1]))
    raise TypeError(f"cannot interpret {type(obj).__name__} as a TriMesh")


def hexagonal_mesh(radius=1.0, step_count=10) -> TriMesh:
    """Uniform hexagon of equilateral triangles in the z = 0 plane: ring k
    has 6k vertices on the hexagon edge, woven to the inner ring so every
    edge has length radius / step_count."""
    points = [(0.0, 0.0, 0.0)]
    ring_start = [0]  # start index of each ring (ring 0 = center)
    radii = np.linspace(0, radius, step_count + 1)
    for k in range(1, step_count + 1):
        r = radii[k]
        ring_start.append(len(points))
        for edge in range(6):
            a0 = PI / 3 * edge
            a1 = PI / 3 * (edge + 1)
            p0 = np.asarray([r * math.cos(a0), r * math.sin(a0), 0.0])
            p1 = np.asarray([r * math.cos(a1), r * math.sin(a1), 0.0])
            for s in range(k):  # k points per edge; edge end = next edge start
                points.append(tuple(p0 + (p1 - p0) * (s / k)))

    faces = []
    for k in range(1, step_count + 1):
        o_base = ring_start[k]
        i_base = ring_start[k - 1]
        n_out = 6 * k
        n_in = 6 * (k - 1)
        for edge in range(6):
            for s in range(k):
                o0 = o_base + (edge * k + s) % n_out
                o1 = o_base + (edge * k + s + 1) % n_out
                if k == 1:
                    faces.append((0, o0, o1))
                    continue
                i0 = i_base + (edge * (k - 1) + s) % n_in
                i1 = i_base + (edge * (k - 1) + s + 1) % n_in
                faces.append((i0, o0, o1))
                if s < k - 1:
                    faces.append((i0, o1, i1))
    return TriMesh(np.asarray(points), np.asarray(faces, dtype=np.int64))
