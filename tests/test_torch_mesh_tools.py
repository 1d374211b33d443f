"""The rest of the mesh tools (``models/mesh.py``) against the JAX package:
host-side NumPy and SciPy, so every result is exactly equal.

* ``find_all_relationships``, ``gradient_accumulator`` and
  ``mesh_parametrization_tools`` on a hexagon and a capped cylinder;
* ``get_flat_initial``, ``planar_interpolated_remesh`` (flattened and
  inflated), ``clean_mesh`` and ``clean_mesh_raw`` on a mesh with
  duplicated vertices and degenerate and repeated faces;
* ``TriMesh.read``, ``TriMesh.from_pyvista`` (flat and (F, 3) faces, and
  its refusal of non-triangles) and ``TriMesh.to_pyvista`` (ImportError:
  pyvista is not installed);
* ``scenes3d.remesh`` (examples/remesh.py) and its check.
"""

import os

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu_torch import config, scenes3d
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def both(name, *args):
    """``name`` built by both packages from the same arguments."""
    return getattr(j_mesh, name)(*args), getattr(t_mesh, name)(*args)


def port(mesh):
    return t_mesh.TriMesh(mesh.points.copy(), mesh.faces.copy())


MESHES = {
    "hexagon": lambda: j_mesh.hexagonal_mesh(1.0, 4),
    "cylinder": lambda: j_mesh.cylindrical_mesh((0, 0, 0), (0, 0, 2.0),
                                                0.5, 6, 5),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_relationships_and_accumulator_match_jax(name):
    mesh = MESHES[name]()
    j_rel = j_mesh.find_all_relationships(mesh, 3)
    t_rel = t_mesh.find_all_relationships(port(mesh), 3)
    assert t_rel == j_rel
    j_acc, j_data = j_mesh.gradient_accumulator(mesh, (0.1, 0.0, 0.2))
    t_acc, t_data = t_mesh.gradient_accumulator(port(mesh), (0.1, 0.0, 0.2))
    np.testing.assert_array_equal(t_acc, j_acc)
    assert t_data == j_data


@pytest.mark.parametrize("name", sorted(MESHES))
def test_parametrization_tools_match_jax(name):
    """The vertex update map and the ancestor accumulator (the dense matrix
    ``connections_to_array`` fills row by row) equal the JAX package's
    loop, entry for entry."""
    mesh = MESHES[name]()
    j_map, j_acc = j_mesh.mesh_parametrization_tools(mesh, 0)
    t_map, t_acc = t_mesh.mesh_parametrization_tools(port(mesh), 0)
    np.testing.assert_array_equal(t_map, j_map)
    np.testing.assert_array_equal(t_acc, j_acc)
    assert t_acc.sum() > t_acc.shape[0]  # some vertex has an ancestor


def dirty_mesh(rng):
    """A hexagon with every vertex duplicated (jittered well inside the
    tolerance), half the faces pointing at the duplicates, a degenerate
    face and a face repeated with the other orientation."""
    mesh = j_mesh.hexagonal_mesh(1.0, 3)
    n = mesh.n_points
    dup = mesh.points + rng.uniform(-1e-9, 1e-9, mesh.points.shape)
    faces = mesh.faces.copy()
    faces[::2] += n
    extra = np.array([[0, 0, 1], faces[3][::-1], faces[5]])
    return np.concatenate([mesh.points, dup]), np.concatenate([faces, extra])


def test_clean_mesh_matches_jax(rng):
    points, faces = dirty_mesh(rng)
    j_m = j_mesh.clean_mesh(j_mesh.TriMesh(points, faces))
    t_m = t_mesh.clean_mesh(t_mesh.TriMesh(points, faces))
    np.testing.assert_array_equal(t_m.points, j_m.points)
    np.testing.assert_array_equal(t_m.faces, j_m.faces)
    assert t_m.n_points == len(points) // 2
    for out_j, out_t in zip(j_mesh.clean_mesh_raw(points, faces, 1e-4),
                            t_mesh.clean_mesh_raw(points, faces, 1e-4)):
        np.testing.assert_array_equal(out_t, out_j)


def test_flat_initial_and_remesh_match_jax():
    bumpy = j_mesh.hexagonal_mesh(1.0, 5)
    r2 = np.sum(bumpy.points[:, :2] ** 2, axis=1)
    bumpy.points[:, 2] = 0.4 * np.exp(-3 * r2)
    base = j_mesh.hexagonal_mesh(1.0, 9)
    j_flat, j_h = j_mesh.planar_interpolated_remesh(bumpy, base)
    t_flat, t_h = t_mesh.planar_interpolated_remesh(port(bumpy), port(base))
    np.testing.assert_array_equal(t_h, j_h)
    np.testing.assert_array_equal(t_flat.points, j_flat.points)
    np.testing.assert_array_equal(t_flat.faces, j_flat.faces)
    j_out = j_mesh.planar_interpolated_remesh(bumpy, base, 2, 0.0, False)
    t_out = t_mesh.planar_interpolated_remesh(port(bumpy), port(base), 2, 0.0,
                                              False)
    np.testing.assert_array_equal(t_out.points, j_out.points)
    j_m, t_m = bumpy.copy(), port(bumpy)
    np.testing.assert_array_equal(t_mesh.get_flat_initial(t_m, 2),
                                  j_mesh.get_flat_initial(j_m, 2))
    np.testing.assert_array_equal(t_m.points, j_m.points)
    with pytest.raises(ValueError):
        t_mesh.get_flat_initial(t_m, 3)
    with pytest.raises(ValueError):
        t_mesh.planar_interpolated_remesh(t_m, t_m, range_axis=5)


class FakePolyData:
    def __init__(self, points, faces):
        self.points = points
        self.faces = faces


def test_read_and_pyvista_interchange(tmp_path):
    mesh = j_mesh.circular_mesh(1.0, 0.5)
    path = str(tmp_path / "disk.stl")
    mesh.save(path)
    j_m, t_m = j_mesh.TriMesh.read(path), t_mesh.TriMesh.read(path)
    np.testing.assert_array_equal(t_m.points, j_m.points)
    np.testing.assert_array_equal(t_m.faces, j_m.faces)
    with pytest.raises(ValueError):
        t_mesh.TriMesh.read(str(tmp_path / "disk.obj"))
    for faces in (t_mesh.pack_faces(mesh.faces), mesh.faces):
        poly = FakePolyData(mesh.points, faces)
        j_p, t_p = (j_mesh.TriMesh.from_pyvista(poly),
                    t_mesh.TriMesh.from_pyvista(poly))
        np.testing.assert_array_equal(t_p.faces, j_p.faces)
        np.testing.assert_array_equal(t_mesh.as_trimesh(poly).faces, j_p.faces)
    quads = FakePolyData(mesh.points, np.array([4, 0, 1, 2, 3]))
    with pytest.raises(ValueError, match="non-triangle"):
        t_mesh.TriMesh.from_pyvista(quads)
    with pytest.raises(ImportError, match="pyvista"):
        t_m.to_pyvista()


def test_remesh_example(tmp_path):
    out = scenes3d.remesh(out_dir=tmp_path, dtype=torch.float64,
                          device="cpu")
    assert abs(out["initial"].max() - 0.4) < 0.02
    np.testing.assert_allclose(out["peak"], out["initial"].max(), rtol=1e-12)
    assert os.path.exists(out["stl"])
    assert os.path.dirname(out["stl"]) == str(tmp_path)
    assert out["boundary"].n_params == out["initial"].shape[0]
