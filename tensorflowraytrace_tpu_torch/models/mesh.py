"""Triangle meshes for building parametric surfaces, in NumPy.

A copy of the parts of ``tensorflowraytrace_tpu/models/mesh.py`` the 3D
lens and light-guide paths need (that package imports JAX when it is
imported, so nothing is imported from it): the mesh container, the
hexagonal and cylindrical generators, and the
vertex-graph tools that make the optimizer's gradient accumulator, smoother
and vertex update map.  These tools run once at set-up time on the host;
the matrices they make are applied on the device by ``optim.Optimizer``.
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

    def unique_edges(self) -> np.ndarray:
        """(E, 2) sorted unique vertex-index pairs."""
        f = self.faces
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [0, 2]]], axis=0)
        e = np.sort(e, axis=1)
        return np.unique(e, axis=0)

    def vertex_neighbors(self):
        """list of sets: neighbors of each vertex via shared faces."""
        neigh = [set() for _ in range(self.n_points)]
        for a, b, c in self.faces:
            neigh[a].update((b, c))
            neigh[b].update((a, c))
            neigh[c].update((a, b))
        return neigh


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


def cylindrical_mesh(start, end, radius=1.0, theta_res=6, z_res=8,
                     start_cap=True, end_cap=True, use_twist=False,
                     epsilion=1e-6) -> TriMesh:
    """Cylinder between two axis points, optionally capped and twisted: z_res
    rings of theta_res points, woven into quads of two faces, and a fan of
    faces to the axis point of each cap.  Made for light-guide parametric
    surfaces: the cap centres lie on the axis, so their FromAxisVG vectors
    are zero and they stay put."""
    start = np.reshape(np.asarray(start, dtype=np.float64), (3,))
    end = np.reshape(np.asarray(end, dtype=np.float64), (3,))
    axis = end - start

    u = np.cross(axis, (1.0, 0.0, 0.0))
    if np.linalg.norm(u) < epsilion:
        u = np.cross(axis, (0.0, 1.0, 0.0))
    if np.linalg.norm(u) < epsilion:
        raise ValueError("cylindrical_mesh: degenerate axis")
    u = u * radius / np.linalg.norm(u)
    v = np.cross(axis, u)
    v = v * radius / np.linalg.norm(v)

    points = []
    faces = []
    if start_cap:
        points.append(start)

    ring_start = []
    for zi in range(z_res):
        z = zi / (z_res - 1)
        twist = (PI / theta_res) * zi if use_twist else 0.0
        ring_start.append(len(points))
        for ti in range(theta_res):
            theta = 2 * PI * ti / theta_res + twist
            points.append(start + z * axis + math.cos(theta) * u
                          + math.sin(theta) * v)

    if start_cap:
        base = ring_start[0]
        for t in range(theta_res):
            faces.append((base + t, 0, base + (t + 1) % theta_res))

    for zi in range(1, z_res):
        a = ring_start[zi - 1]
        b = ring_start[zi]
        for t in range(theta_res):
            t2 = (t + 1) % theta_res
            faces.append((a + t2, b + t, a + t))
            faces.append((b + t, a + t2, b + t2))

    if end_cap:
        points.append(end)
        last = len(points) - 1
        base = ring_start[-1]
        for t in range(theta_res):
            faces.append((base + (t + 1) % theta_res, last, base + t))

    return TriMesh(np.asarray(points), np.asarray(faces, dtype=np.int64))


# ======================================================================
# vertex-graph tools (parametrization / accumulator / smoother)
# ======================================================================

def get_closest_point(mesh: TriMesh, target) -> int:
    """Index of the mesh vertex nearest to ``target``."""
    target = np.asarray(target, dtype=np.float64)
    return int(np.argmin(np.sum((mesh.points - target) ** 2, axis=1)))


def find_generations(mesh: TriMesh, top_parent: int):
    """BFS waves of vertices outward from ``top_parent``."""
    neigh = mesh.vertex_neighbors()
    generations = [{top_parent}]
    remaining = set(range(mesh.n_points)) - generations[0]
    while remaining:
        wave = set()
        for v in generations[-1]:
            wave |= neigh[v]
        wave &= remaining
        if not wave:
            break  # disconnected component; leave it unparametrized
        remaining -= wave
        generations.append(wave)
    return generations


def connections_to_array(connection_list, dtype=np.float64) -> np.ndarray:
    """List-of-sets -> dense matrix with 1s at connections plus identity:
    left-multiplying a gradient by this matrix adds each vertex's gradient
    into all vertices connected to it."""
    n = len(connection_list)
    arr = np.eye(n, dtype=dtype)
    for i, row in enumerate(connection_list):
        for j in row:
            arr[i, j] += 1.0
    return arr


def mesh_parametrization_tools(mesh: TriMesh, top_parent: int,
                               active_vertices=None):
    """vertex_update_map + gradient accumulator.

    The BFS wave from ``top_parent`` assigns each face the subset of its
    vertices it is allowed to move (the not-yet-claimed ones when the wave
    first touches it), which minimizes faces competing for shared vertices;
    each vertex's ancestors are its BFS-parents transitively, giving the
    accumulator matrix that left-multiplies gradients so moving a vertex
    drags its descendants.

    Returns
    -------
    vertex_update_map : (F, 3) bool -- True where a face may move that vertex.
    accumulator : (n, n) float64 -- identity + ancestor indicator.
    """
    generations = find_generations(mesh, top_parent)
    level = np.full(mesh.n_points, -1, dtype=np.int64)
    for g, wave in enumerate(generations):
        for v in wave:
            level[v] = g
    # disconnected vertices: treat as their own roots
    level[level < 0] = 0

    neigh = mesh.vertex_neighbors()

    # parents: neighbors exactly one BFS level up; ancestors: transitive
    ancestors = [set() for _ in range(mesh.n_points)]
    order = np.argsort(level, kind="stable")
    for v in order:
        parents = {u for u in neigh[v] if level[u] == level[v] - 1}
        anc = set(parents)
        for p in parents:
            anc |= ancestors[p]
        ancestors[v] = anc

    # a face may move its vertices at its maximum level (the wave reaches
    # the face through its minimum-level vertex; the not-yet-claimed
    # vertices are those at deeper levels)
    face_levels = level[mesh.faces]  # (F, 3)
    min_level = face_levels.min(axis=1, keepdims=True)
    update_map = face_levels > min_level
    # faces whose vertices are all in one wave may move everything
    orphaned = ~update_map.any(axis=1)
    update_map[orphaned] = True

    accumulator = connections_to_array(ancestors)

    if active_vertices is not None:
        kept = [i for i in range(accumulator.shape[0]) if i in set(active_vertices)]
        accumulator = accumulator[np.ix_(kept, kept)]

    return update_map, accumulator


def gaussian_weights(sigma, count):
    """Unnormalized Gaussian ring weights for the smoother."""
    x = np.arange(count) / sigma
    return np.exp(-0.5 * x ** 2)


def mesh_smoothing_tool(mesh: TriMesh, weights, active_vertices=None):
    """Row-normalized n-th-neighbor weight matrix.

    Left-multiply onto parameters: each vertex keeps weights[0]/sum of its
    value, spreads weights[k]/sum evenly over its k-th-ring neighbors.
    """
    neigh = mesh.vertex_neighbors()
    n = mesh.n_points
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    depth = len(weights)

    smoother = np.zeros((n, n), dtype=np.float64)
    for v in range(n):
        taken = {v}
        ring = {v}
        smoother[v, v] = weights[0]
        for k in range(1, depth):
            new_ring = set()
            for u in ring:
                new_ring |= neigh[u]
            new_ring -= taken
            if not new_ring:
                # re-normalize the weight that cannot be distributed
                smoother[v] /= smoother[v].sum()
                break
            w = weights[k] / len(new_ring)
            for u in new_ring:
                smoother[v, u] = w
            taken |= new_ring
            ring = new_ring

    if active_vertices is not None:
        kept = [i for i in range(n) if i in set(active_vertices)]
        smoother = smoother[np.ix_(kept, kept)]
        smoother /= smoother.sum(axis=1, keepdims=True)
    return smoother
