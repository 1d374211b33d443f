"""Parity of the port's mesh generators and STL I/O with the JAX package's,
on the CPU.

* ``circular_mesh`` (a disk, an annulus, a 30-degree wedge and the
  hexalens's wedge): faces equal exactly (the vertex update map, the
  accumulator and the smoother all depend on face order), points within
  1e-15.
* Binary STL written by each package and read by the other: bytes 80
  onward (all but the free-text header) equal, and the meshes read back
  equal.  ASCII STL, ``pack_faces`` / ``unpack_faces`` and
  ``face_normals`` likewise.
* ``export_boundary_stl`` of a parametric surface and of the cylindrical
  guide, at the same parameters in both packages: the same file from byte
  80, its vertices those of ``updated_mesh`` within float32 rounding.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.utils.checkpoint import export_boundary_stl as j_export
from tensorflowraytrace_tpu_torch import config, hexalens
from tensorflowraytrace_tpu_torch.models import boundaries as t_bd
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh
from tensorflowraytrace_tpu_torch.utils.checkpoint import export_boundary_stl
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PI = math.pi
F64 = torch.float64

# (name, radius, target edge, keyword arguments)
CIRCLES = [
    ("disk", 1.0, 0.2, {}),
    ("annulus", 1.5, 0.15, {"starting_radius": 0.4}),
    ("wedge_30", 1.0, 0.08, {"theta_start": 0.0, "theta_end": PI / 6}),
    ("hexalens_test_wedge", 1.0, 0.3, {"theta_start": 0.0, "theta_end": PI / 6}),
    ("off_axis_wedge", 2.0, 0.25, {"theta_start": -PI / 5, "theta_end": PI / 3}),
]


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def same_mesh(t, j, atol=1e-15):
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=atol)


@pytest.mark.parametrize("name,radius,edge,kw", CIRCLES,
                         ids=[c[0] for c in CIRCLES])
def test_circular_mesh_matches_jax(name, radius, edge, kw):
    t, j = t_mesh.circular_mesh(radius, edge, **kw), j_mesh.circular_mesh(
        radius, edge, **kw)
    assert t.n_faces >= 5
    same_mesh(t, j)
    np.testing.assert_allclose(t.face_normals(), j.face_normals(), rtol=0,
                               atol=1e-15)
    # every face is counter-clockwise seen from +z
    assert (t.face_normals()[:, 2] > 0).all()


def test_hexalens_lens_tools_match_jax():
    """The wedge the hexalens trains and the tools made from it."""
    mesh, vum, acc = hexalens.lens_tools(0.3)
    j = j_mesh.circular_mesh(1.0, 0.3, theta_start=0.0, theta_end=PI / 6)
    j.points = np.stack([j.points[:, 2], j.points[:, 0], j.points[:, 1]], axis=1)
    same_mesh(mesh, j)
    j_vum, j_acc = j_mesh.mesh_parametrization_tools(
        j, j_mesh.get_closest_point(j, (0.0, 0.0, 0.0)))
    np.testing.assert_array_equal(vum, j_vum)
    np.testing.assert_array_equal(acc, j_acc)


def meshes():
    return [(t_mesh.circular_mesh(1.0, 0.25), j_mesh.circular_mesh(1.0, 0.25)),
            (t_mesh.hexagonal_mesh(1.2, 3), j_mesh.hexagonal_mesh(1.2, 3)),
            (t_mesh.cylindrical_mesh((0, 0, 0), (0, 0, 4), 0.5, 7, 5),
             j_mesh.cylindrical_mesh((0, 0, 0), (0, 0, 4), 0.5, 7, 5))]


def test_binary_stl_crosses_packages(tmp_path):
    for k, (t, j) in enumerate(meshes()):
        # off the lattice, so the float32 rounding and the merge both matter
        t.points = t.points * 1.37 + 0.11
        j.points = j.points * 1.37 + 0.11
        t_file, j_file = tmp_path / f"t{k}.stl", tmp_path / f"j{k}.stl"
        t.save(str(t_file))
        j.save(str(j_file))
        t_bytes, j_bytes = t_file.read_bytes(), j_file.read_bytes()
        assert len(t_bytes) == 84 + 50 * t.n_faces
        assert t_bytes[80:] == j_bytes[80:]
        for file in (t_file, j_file):
            same_mesh(t_mesh.load_stl(str(file)), j_mesh.load_stl(str(file)),
                      atol=0)
        back = t_mesh.load_stl(str(j_file))
        np.testing.assert_allclose(back.points[back.faces],
                                   t.points[t.faces], rtol=0, atol=1e-6)


def test_ascii_stl_matches_jax(tmp_path):
    text = """solid demo
  facet normal 0 0 1
    outer loop
      vertex 0 0 0
      vertex 1 0 0
      vertex 0 1 0.5
    endloop
  endfacet
  facet normal 0 0 1
    outer loop
      vertex 1 0 0
      vertex 1 1 0.25
      vertex 0 1 0.5
    endloop
  endfacet
endsolid demo
"""
    path = tmp_path / "demo.stl"
    path.write_text(text)
    t, j = t_mesh.load_stl(str(path)), j_mesh.load_stl(str(path))
    same_mesh(t, j, atol=0)
    assert t.n_points == 4 and t.n_faces == 2


def test_pack_and_unpack_faces_match_jax():
    faces = t_mesh.hexagonal_mesh(1.0, 2).faces
    packed = t_mesh.pack_faces(faces)
    np.testing.assert_array_equal(packed, j_mesh.pack_faces(faces))
    np.testing.assert_array_equal(t_mesh.unpack_faces(packed), faces)
    np.testing.assert_array_equal(j_mesh.unpack_faces(packed), faces)
    with pytest.raises(ValueError):
        t_mesh.TriMesh(np.zeros((3, 3)), [[0, 1, 2]]).save("mesh.obj")


def test_export_boundary_stl_matches_jax(tmp_path, rng):
    mesh = t_mesh.circular_mesh(1.0, 0.2, theta_start=0.0, theta_end=PI / 6)
    vum, _ = t_mesh.mesh_parametrization_tools(mesh, 0)
    params = rng.normal(0, 0.05, mesh.n_points)
    boundaries = [
        (t_bd.ParametricTriangleBoundary(
            mesh, t_bd.FromVectorVG((0.0, 0.0, 1.0)), flip_norm=True,
            vertex_update_map=vum, dtype=F64, device="cpu"),
         j_bd.ParametricTriangleBoundary(
             j_mesh.TriMesh(mesh.points, mesh.faces),
             j_bd.FromVectorVG((0.0, 0.0, 1.0)), flip_norm=True,
             vertex_update_map=vum, dtype=jnp.float64), params),
        (t_bd.ParametricCylindricalGuide((0, 0, 0), (0, 0, 3), 0.4, 6, 5,
                                         dtype=F64, device="cpu"),
         j_bd.ParametricCylindricalGuide((0, 0, 0), (0, 0, 3), 0.4, 6, 5,
                                         dtype=jnp.float64),
         rng.uniform(0, 0.2, 30)),
    ]
    for k, (t_b, j_b, p) in enumerate(boundaries):
        t_updated = t_b.updated_mesh(torch.as_tensor(p))
        same_mesh(t_updated, j_b.updated_mesh(jnp.asarray(p)))
        t_file = export_boundary_stl(t_b, torch.as_tensor(p),
                                     str(tmp_path / f"t{k}.stl"))
        j_file = j_export(j_b, jnp.asarray(p), str(tmp_path / f"j{k}.stl"))
        with open(t_file, "rb") as ft, open(j_file, "rb") as fj:
            assert ft.read()[80:] == fj.read()[80:]
        back = t_mesh.load_stl(t_file)
        np.testing.assert_array_equal(back.faces.shape, t_updated.faces.shape)
        # each face's corners, within float32 rounding and the 7-decimal merge
        np.testing.assert_allclose(back.points[back.faces],
                                   t_updated.points[t_updated.faces], rtol=0,
                                   atol=2e-7)
    # with no parameters given, the module's own
    t_b = boundaries[0][0]
    with torch.no_grad():
        t_b.params.copy_(torch.as_tensor(params))
    same_mesh(t_b.updated_mesh(), boundaries[0][1].updated_mesh(
        jnp.asarray(params)))
