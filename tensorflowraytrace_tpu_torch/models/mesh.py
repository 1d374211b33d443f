"""Triangle meshes for building parametric surfaces, in NumPy.

A copy of ``tensorflowraytrace_tpu/models/mesh.py`` (that package imports
JAX when it is imported, so nothing is imported from it): the mesh
container with its binary / ASCII STL I/O and
pyvista interchange, the circular, hexagonal and cylindrical generators,
the vertex-graph tools that make the optimizer's gradient accumulator,
smoother and vertex update map (and the relationships behind them),
re-meshing onto a regular base mesh (scipy's ``griddata``) and cleaning,
and the drawing helpers ``visualize_*`` (matplotlib, imported by the
axis they are given).  These tools run once at
set-up time on the host; the matrices they make are applied on the device
by ``optim.Optimizer``.  Generators and STL files match the JAX package's
exactly: the same faces in the same order, the same records.
"""

from __future__ import annotations

import math
import struct
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

    def face_normals(self) -> np.ndarray:
        """(F, 3) unit normals, cross(v1 - vp, v2 - v1) normalised."""
        vp = self.points[self.faces[:, 0]]
        v1 = self.points[self.faces[:, 1]]
        v2 = self.points[self.faces[:, 2]]
        n = np.cross(v1 - vp, v2 - v1)
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)

    def save(self, filename: str):
        """Write the mesh as a binary STL file (the only format)."""
        if not str(filename).lower().endswith(".stl"):
            raise ValueError(f"unsupported mesh format: {filename}")
        save_stl(self, filename)

    @staticmethod
    def read(filename: str) -> "TriMesh":
        """Read an STL file (binary or ASCII; the only format)."""
        if not str(filename).lower().endswith(".stl"):
            raise ValueError(f"unsupported mesh format: {filename}")
        return load_stl(filename)

    @staticmethod
    def from_pyvista(polydata) -> "TriMesh":
        """A TriMesh of a pyvista.PolyData (or anything with ``points`` and
        pyvista's flat [3, i, j, k, 3, ...] ``faces``, or (F, 3) faces).
        The mesh must be all triangles (``polydata.triangulate()``)."""
        faces = np.asarray(polydata.faces)
        if faces.ndim != 1:
            return TriMesh(np.asarray(polydata.points), faces)
        if faces.size % 4 != 0 or (faces.size and (faces[::4] != 3).any()):
            raise ValueError(
                "from_pyvista: mesh has non-triangle faces; call "
                ".triangulate() on the PolyData first")
        return TriMesh(np.asarray(polydata.points), unpack_faces(faces))

    def to_pyvista(self):
        """The mesh as a pyvista.PolyData; raises ImportError without the
        optional pyvista package (``save`` writes STL without it)."""
        try:
            import pyvista
        except ImportError as e:
            raise ImportError(
                "to_pyvista needs the optional pyvista package; use "
                ".save('mesh.stl') for dependency-free interchange") from e
        return pyvista.PolyData(np.asarray(self.points),
                                pack_faces(self.faces))

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
        return TriMesh.from_pyvista(obj)
    if isinstance(obj, (tuple, list)) and len(obj) == 2:
        return TriMesh(np.asarray(obj[0]), np.asarray(obj[1]))
    raise TypeError(f"cannot interpret {type(obj).__name__} as a TriMesh")


def pack_faces(faces) -> np.ndarray:
    """(F, 3) -> pyvista's flat format [3, i, j, k, 3, ...]."""
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    return np.reshape(np.pad(faces, ((0, 0), (1, 0)), constant_values=3), (-1,))


def unpack_faces(faces) -> np.ndarray:
    """pyvista's flat format -> (F, 3), all faces being triangles."""
    return np.reshape(np.asarray(faces, dtype=np.int64), (-1, 4))[:, 1:]


# one binary STL record: a normal, three vertices, an attribute word
_STL_RECORD = np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])


def save_stl(mesh: TriMesh, filename: str):
    """Binary STL: an 80-byte header, a uint32 face count and one 50-byte
    record a face, in face order (float32 normal and vertices, a zero
    attribute)."""
    rec = np.zeros((mesh.n_faces,), dtype=_STL_RECORD)
    rec["n"] = mesh.face_normals().astype(np.float32)
    rec["v"] = mesh.points[mesh.faces].astype(np.float32)  # (F, 3, 3)
    with open(filename, "wb") as f:
        f.write(b"tensorflowraytrace_tpu_torch binary STL".ljust(80, b"\0"))
        f.write(struct.pack("<I", mesh.n_faces))
        f.write(rec.tobytes())


def _merged(tris) -> TriMesh:
    """A mesh from (3F, 3) face-corner coordinates, corners that agree to 7
    decimals merged into one vertex (so the points come out sorted)."""
    points, inverse = np.unique(tris.round(decimals=7), axis=0,
                                return_inverse=True)
    return TriMesh(points, inverse.reshape(-1, 3))


def load_stl(filename: str) -> TriMesh:
    """Read a binary or ASCII STL file; duplicate vertices are merged."""
    with open(filename, "rb") as f:
        head = f.read(80)
        if head[:5] == b"solid" and b"facet" in (head + f.read(200)):
            f.seek(0)
            return _load_stl_ascii(f.read().decode("ascii", errors="ignore"))
        f.seek(80)
        (count,) = struct.unpack("<I", f.read(4))
        rec = np.frombuffer(f.read(count * 50), dtype=_STL_RECORD, count=count)
    return _merged(rec["v"].astype(np.float64).reshape(-1, 3))


def _load_stl_ascii(text: str) -> TriMesh:
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if parts[:1] == ["vertex"]:
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return _merged(np.asarray(verts, dtype=np.float64))


# ======================================================================
# mesh generators
# ======================================================================

def _weave_rings(inner, inner_angles, outer, outer_angles, faces, join):
    """Triangulate the band between two concentric vertex rings by an angular
    two-pointer walk.  Rings are listed CCW; emitted faces are CCW (+z
    normals).  ``join`` closes the ring (full circle)."""
    ni, no = len(inner), len(outer)
    if ni == 0 or no == 0:
        return
    i_steps = 0 if ni == 1 else (ni if join else ni - 1)
    o_steps = no if join else no - 1

    def iang(k):
        return inner_angles[k % ni] + 2 * PI * (k // ni) if join else inner_angles[k]

    def oang(k):
        return outer_angles[k % no] + 2 * PI * (k // no) if join else outer_angles[k]

    i = o = 0
    while i < i_steps or o < o_steps:
        advance_outer = o < o_steps and (
            i >= i_steps or oang(o + 1) <= iang(i + 1)
        )
        if advance_outer:
            faces.append((inner[i % ni], outer[o % no], outer[(o + 1) % no]))
            o += 1
        else:
            faces.append((inner[i % ni], outer[o % no], inner[(i + 1) % ni]))
            i += 1


def circular_mesh(radius, target_edge_size, starting_radius=0.0,
                  theta_start=0.0, theta_end=2 * PI, join=None) -> TriMesh:
    """Near-uniform disk, annulus or wedge in the x-y plane: concentric
    vertex rings spaced by edge * sin(60 deg), woven into triangles."""
    if join is None:
        join = (theta_start == 0.0) and (theta_end == 2 * PI)
    if starting_radius >= radius:
        raise ValueError("circular_mesh: starting_radius must be < radius")

    span = theta_end - theta_start
    radius_step = target_edge_size * math.sin(PI / 3)
    n_rings = max(int(1 + (radius - starting_radius) / radius_step), 2)
    radii = np.linspace(starting_radius, radius, n_rings)

    points = []
    ring_indices = []
    ring_angles = []
    for r in radii:
        if r == 0.0:
            n_pts = 1
            angles = np.asarray([theta_start])
        else:
            arc = r * span
            n_pts = max(int(round(arc / target_edge_size)), 3 if join else 2)
            if join:
                angles = theta_start + span * np.arange(n_pts) / n_pts
            else:
                angles = np.linspace(theta_start, theta_end, n_pts)
        idx = np.arange(len(points), len(points) + n_pts)
        points.extend(
            (r * math.cos(a), r * math.sin(a), 0.0) for a in angles
        )
        ring_indices.append(idx)
        ring_angles.append(angles)

    faces = []
    for k in range(1, n_rings):
        _weave_rings(ring_indices[k - 1], ring_angles[k - 1],
                     ring_indices[k], ring_angles[k], faces, join)
    return TriMesh(np.asarray(points), np.asarray(faces, dtype=np.int64))


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
        # a row's indices are distinct (a set), so one fancy add is exact
        arr[i, np.fromiter(row, dtype=np.intp, count=len(row))] += 1.0
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


def find_all_relationships(mesh: TriMesh, top_parent: int):
    """The BFS vertex relationships from ``top_parent``: ``(descendants,
    children, parents, ancestors)``, each a list of sets indexed by vertex.
    A vertex's parents are its neighbours one BFS level up."""
    generations = find_generations(mesh, top_parent)
    level = np.full(mesh.n_points, -1, dtype=np.int64)
    for g, wave in enumerate(generations):
        for v in wave:
            level[v] = g
    level[level < 0] = 0
    neigh = mesh.vertex_neighbors()

    n = mesh.n_points
    parents = [set() for _ in range(n)]
    children = [set() for _ in range(n)]
    ancestors = [set() for _ in range(n)]
    order = np.argsort(level, kind="stable")
    for v in order:
        p = {u for u in neigh[v] if level[u] == level[v] - 1}
        parents[v] = p
        for u in p:
            children[u].add(v)
        anc = set(p)
        for u in p:
            anc |= ancestors[u]
        ancestors[v] = anc
    descendants = [set() for _ in range(n)]
    for v in order[::-1]:
        d = set(children[v])
        for c in children[v]:
            d |= descendants[c]
        descendants[v] = d
    return descendants, children, parents, ancestors


def _quiver_3d(ax, starts, ends, color):
    if not starts:
        return None
    starts = np.asarray(starts)
    dirs = np.asarray(ends) - starts
    return ax.quiver(starts[:, 0], starts[:, 1], starts[:, 2],
                     dirs[:, 0], dirs[:, 1], dirs[:, 2], color=color)


def visualize_connections(ax, mesh: TriMesh, connection_list, color="orange"):
    """Draw a vertex-relationship graph (``connection_list[i]``: the
    vertices vertex i points to) as arrows on an mplot3d axis."""
    pairs = [(i, j) for i, conns in enumerate(connection_list) for j in conns]
    return _quiver_3d(ax, [mesh.points[i] for i, _ in pairs],
                      [mesh.points[j] for _, j in pairs], color)


def visualize_generations(ax, mesh: TriMesh, generations,
                          colors=("red", "yellow", "green", "blue", "purple")):
    """Colour the vertices by breadth-first generation on an mplot3d axis;
    returns the scatter artists, one a generation."""
    artists = []
    for k, generation in enumerate(generations):
        pts = mesh.points[sorted(generation)]
        artists.append(ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2],
                                  color=colors[k % len(colors)], s=30))
    return artists


def visualize_face_updates(ax, mesh: TriMesh, face_updates, color="red"):
    """Draw arrows from each face's centre to the vertices it may move
    (``face_updates``: (F, 3) booleans, an array or a tensor) on an mplot3d
    axis."""
    if hasattr(face_updates, "detach"):
        face_updates = face_updates.detach().cpu().numpy()
    starts, ends = [], []
    for face, mask in zip(mesh.faces, np.asarray(face_updates)):
        verts = mesh.points[face]
        center = verts.mean(axis=0)
        for v, movable in zip(verts, mask):
            if movable:
                starts.append(center)
                ends.append(v)
    return _quiver_3d(ax, starts, ends, color)


def gradient_accumulator(mesh: TriMesh, origin=(0, 0, 0)):
    """The descendant-based accumulator matrix built around the vertex
    nearest ``origin``.  Returns ``(accumulator, relationships)``, the
    latter a dict of the top parent and the four relationship lists."""
    top_parent = get_closest_point(mesh, origin)
    descendants, children, parents, ancestors = find_all_relationships(
        mesh, top_parent)
    accumulator = connections_to_array(descendants)
    return accumulator, {
        "top_parent": top_parent,
        "descendant": descendants,
        "child": children,
        "parent": parents,
        "ancestor": ancestors,
    }


def get_flat_initial(mesh: TriMesh, axis: int = 0) -> np.ndarray:
    """Flatten one coordinate of the mesh in place and return the removed
    values, the initial parameters that re-inflate it."""
    if axis not in (0, 1, 2):
        raise ValueError("get_flat_initial: axis must be in {0, 1, 2}")
    initial = mesh.points[:, axis].copy()
    mesh.points[:, axis] = 0.0
    return initial


def planar_interpolated_remesh(input_mesh: TriMesh, base_mesh: TriMesh,
                               range_axis=2, interp_fill_value=0.0,
                               flatten=True):
    """Re-mesh an irregular height-field mesh onto a regular base mesh by
    linear interpolation (``scipy.interpolate.griddata``).  Returns the
    flattened base copy and the heights (its initial parameters) if
    ``flatten``, else the base mesh at those heights."""
    from scipy.interpolate import griddata

    if range_axis not in (0, 1, 2):
        raise ValueError("planar_interpolated_remesh: axis must be in {0,1,2}")
    domain_axes = [a for a in (0, 1, 2) if a != range_axis]

    heights = griddata(
        input_mesh.points[:, domain_axes],
        input_mesh.points[:, range_axis],
        base_mesh.points[:, domain_axes],
        fill_value=interp_fill_value,
    )
    out = base_mesh.copy()
    if flatten:
        out.points[:, range_axis] = 0.0
        return out, heights
    out.points[:, range_axis] = heights
    return out


def clean_mesh(mesh: TriMesh, distance_tolerance=1e-6) -> TriMesh:
    """Merge vertices that agree after rounding to ``distance_tolerance``
    and drop degenerate and duplicate faces (a duplicate: the same vertex
    set; the first occurrence's orientation is kept)."""
    pts = mesh.points
    quant = np.round(pts / distance_tolerance).astype(np.int64)
    _, first_idx, inverse = np.unique(quant, axis=0, return_index=True,
                                      return_inverse=True)
    new_points = pts[first_idx]
    faces = inverse.reshape(-1)[mesh.faces]

    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]

    key = np.sort(faces, axis=1)
    _, keep = np.unique(key, axis=0, return_index=True)
    faces = faces[np.sort(keep)]
    return TriMesh(new_points, faces)


def clean_mesh_raw(points, faces, distance_tolerance=1e-6):
    """``clean_mesh`` on arrays: returns ``(points, faces)``."""
    m = clean_mesh(TriMesh(np.asarray(points), np.asarray(faces)),
                   distance_tolerance)
    return m.points, m.faces
