"""The rest of the boundaries (``models/boundaries.py``) against the JAX
package, on the CPU in float64.

* ``ClipConstraint`` and the vector generators (``SecondSurfaceVG`` from an
  array, a mesh and an STL file, ``FromPointVG``, ``FromVectorVG``,
  ``FromAxisVG``) give the same arrays within 1e-12.
* ``manual_segment_boundary``, ``manual_arc_boundary`` and
  ``manual_triangle_boundary`` (from a mesh, flipped, and from an STL
  file) build the same surface sets exactly.
* ``ParametricSegmentBoundary``, ``ParametricMultiSegmentBoundary`` (the
  BASELINE config 2 lens), ``MasterSlaveParametricTriangleBoundary`` and
  the even aspheres (``ParametricAsphereBoundary``,
  ``ParametricAsphereSegment``) build the same surfaces within 1e-12 at
  the same seeded parameters, and the gradient of a scalar of the built
  vertices is within 1e-10 of ``jax.grad``'s.  The master-slave gather is
  equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.models import boundaries as t_bd
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh
from torch_normals import assert_near_jax_normals, written_out_normals
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
TOL = 1e-12       # built surfaces and vector fields
GRAD_TOL = 1e-10  # gradients of a scalar of the vertices


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def close(t, j, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=tol, atol=tol)


def same_columns(t_set, j_set, names):
    for name in names:
        t, j = getattr(t_set, name), getattr(j_set, name)
        if t.dtype.is_floating_point:
            close(t, j)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


SEG = ("p0", "p1", "category", "mat_in", "mat_out")
ARC = ("center", "angle_start", "angle_end", "radius", "category", "mat_in",
       "mat_out")
TRI = ("vp", "v1", "v2", "norm", "category", "mat_in", "mat_out")


def kw(dtype, **more):
    return dict(mat_in=1, mat_out=0, dtype=dtype, **more)


def vertex_scalar(xp):
    """A scalar of built vertex arrays whose gradient reaches every one."""
    def f(arrays):
        total = 0.0
        for k, a in enumerate(arrays):
            total = total + xp.sum(xp.sin((k + 1.3) * a) * a)
        return total
    return f


def grads_match(j_build, t_build, params):
    """jax.grad and torch.autograd of ``vertex_scalar`` of the built
    vertices with respect to a list of numpy parameter arrays."""
    j_g = jax.jit(jax.grad(lambda ps: vertex_scalar(jnp)(j_build(ps))))(
        [jnp.asarray(p) for p in params])
    leaves = [torch.tensor(p, dtype=F64, requires_grad=True) for p in params]
    t_g = torch.autograd.grad(vertex_scalar(torch)(t_build(leaves)), leaves)
    for t, j in zip(t_g, j_g):
        assert np.all(np.isfinite(np.asarray(j))) and float(np.abs(j).max()) > 0
        close(t, j, GRAD_TOL)


# ----------------------------------------------------------------------
# constraints and vector generators
# ----------------------------------------------------------------------

def test_clip_constraint_matches_jax(rng):
    p = rng.uniform(-2, 2, 40)
    j_c, t_c = j_bd.ClipConstraint(-0.5, 0.7), t_bd.ClipConstraint(-0.5, 0.7)
    close(t_c.apply_literal(torch.as_tensor(p)),
          j_c.apply_literal(jnp.asarray(p)), 0.0)
    close(t_c.apply(0, [torch.as_tensor(p)]), j_c.apply(0, [jnp.asarray(p)]),
          0.0)
    grads_match(lambda ps: [j_c.apply_literal(ps[0])],
                lambda ps: [t_c.apply_literal(ps[0])], [p])


@pytest.mark.parametrize("kind", ["array", "mesh", "stl", "point", "vector",
                                  "axis"])
def test_vector_generators_match_jax(rng, tmp_path, kind):
    mesh = j_mesh.hexagonal_mesh(1.0, 3)
    zero = mesh.points
    other = zero + rng.normal(0, 0.3, zero.shape)
    if kind in ("array", "mesh", "stl"):
        surface = {"array": other,
                   "mesh": j_mesh.TriMesh(other, mesh.faces)}.get(kind)
        if kind == "stl":
            # the STL reader merges and sorts vertices: the zero points are
            # its own points, so the two sets still pair up row for row
            surface = str(tmp_path / "second.stl")
            j_mesh.TriMesh(other, mesh.faces).save(surface)
            zero = j_mesh.TriMesh.read(surface).points + 0.1
        j_vg, t_vg = j_bd.SecondSurfaceVG(surface), t_bd.SecondSurfaceVG(surface)
    elif kind == "point":
        j_vg, t_vg = (j_bd.FromPointVG((0.3, -0.2, 2.0)),
                      t_bd.FromPointVG((0.3, -0.2, 2.0)))
    elif kind == "vector":
        j_vg, t_vg = (j_bd.FromVectorVG((1.0, 2.0, -0.5)),
                      t_bd.FromVectorVG((1.0, 2.0, -0.5)))
    else:
        j_vg, t_vg = (j_bd.FromAxisVG((0, 0, 0), direction=(0.2, 0.1, 1.0)),
                      t_bd.FromAxisVG((0, 0, 0), direction=(0.2, 0.1, 1.0)))
    assert isinstance(t_vg, t_bd.VectorGeneratorBase)
    close(t_vg.generate(torch.as_tensor(zero)), j_vg.generate(jnp.asarray(zero)))


# ----------------------------------------------------------------------
# manual boundaries
# ----------------------------------------------------------------------

def test_manual_segment_and_arc_boundaries_match_jax(rng):
    rows = rng.uniform(-3, 3, (12, 4))
    tk, jk = kw(F64), kw(jnp.float64)
    same_columns(t_bd.manual_segment_boundary(rows, **tk),
                 j_bd.manual_segment_boundary(rows, **jk), SEG)
    cols = dict(x_start=rows[:, 0], y_start=rows[:, 1], x_end=rows[:, 2],
                y_end=rows[:, 3])
    same_columns(t_bd.manual_segment_boundary(**cols, **tk),
                 j_bd.manual_segment_boundary(**cols, **jk), SEG)
    args = (rng.uniform(-1, 1, 5), rng.uniform(-1, 1, 5), rng.uniform(-3, 0, 5),
            rng.uniform(0, 3, 5), rng.uniform(0.1, 1, 5))
    same_columns(t_bd.manual_arc_boundary(*args, **tk),
                 j_bd.manual_arc_boundary(*args, **jk), ARC)
    same_columns(t_bd.manual_arc_boundary(0.5, -0.2, 0.0, 1.0, 0.3, **tk),
                 j_bd.manual_arc_boundary(0.5, -0.2, 0.0, 1.0, 0.3, **jk), ARC)


@pytest.mark.parametrize("source", ["mesh", "flipped", "stl"])
def test_manual_triangle_boundary_matches_jax(tmp_path, source):
    """The JAX package's ``manual_triangle_boundary`` hands its ``dtype``
    to the vertices but not to ``TriangleSet.make``, so its triangles are
    always float32 (the package's default dtype).  The port's equal them
    exactly in float32; in float64 the port keeps float64, the mesh's own
    points gathered face by face."""
    mesh = j_mesh.circular_mesh(1.0, 0.4)
    mesh.points[:, 2] = 0.2 * mesh.points[:, 0] ** 2
    flip = source == "flipped"
    if source == "stl":
        path = str(tmp_path / "lens.stl")
        mesh.save(path)
        j_set = j_bd.manual_triangle_boundary(file_name=path,
                                              **kw(jnp.float64))
        t_sets = [t_bd.manual_triangle_boundary(file_name=path, **kw(dt))
                  for dt in (torch.float32, F64)]
        faces = j_mesh.TriMesh.read(path)
    else:
        j_set = j_bd.manual_triangle_boundary(mesh, flip_norm=flip,
                                              **kw(jnp.float64))
        t_sets = [t_bd.manual_triangle_boundary(
            t_mesh.TriMesh(mesh.points, mesh.faces), flip_norm=flip, **kw(dt))
            for dt in (torch.float32, F64)]
        faces = mesh.flip_faces() if flip else mesh
    assert j_set.vp.dtype == jnp.float32
    assert t_sets[0].n_surfaces == mesh.n_faces
    for name in TRI:
        got, want = getattr(t_sets[0], name).numpy(), np.asarray(
            getattr(j_set, name))
        if name == "norm":  # the cross product written out, JAX's corners,
            # and near JAX's own (XLA fuses its cross product)
            corners = (j_set.vp, j_set.v1, j_set.v2)
            assert_near_jax_normals(got, want, *corners)
            want = written_out_normals(*corners)
        np.testing.assert_array_equal(got, want)
    assert t_sets[1].vp.dtype == F64
    for k, name in enumerate(("vp", "v1", "v2")):
        np.testing.assert_array_equal(getattr(t_sets[1], name).numpy(),
                                      faces.points[faces.faces[:, k]])


# ----------------------------------------------------------------------
# parametric boundaries
# ----------------------------------------------------------------------

def segment_bases(pkg, n=21):
    return (pkg.StaticUniformAperaturePoints((0.0, -1.2), (0.0, 1.2), n),
            pkg.StaticUniformAperaturePoints((1.0, -1.2), (1.0, 1.2), n))


@pytest.mark.parametrize("flip,constraint", [(False, None), (True, "clip")])
def test_parametric_segment_boundary_matches_jax(rng, flip, constraint):
    def make(bd, d, dtype):
        c = None if constraint is None else bd.ClipConstraint(-0.1, 0.25)
        return bd.ParametricSegmentBoundary(
            *segment_bases(d), flip_norm=flip, initial_parameters=0.05,
            constraint=c, **kw(dtype))

    j_b, t_b = make(j_bd, j_dist, jnp.float64), make(t_bd, t_dist, F64)
    j_build = jax.jit(j_b.build)
    close(t_b.init_params(), j_b.init_params(), 0.0)
    same_columns(t_b.build(), j_build(j_b.init_params()), SEG)
    p = rng.uniform(-0.3, 0.4, 21)
    same_columns(t_b.build(torch.as_tensor(p)), j_build(jnp.asarray(p)), SEG)
    grads_match(lambda ps: [(s := j_b.build(ps[0])).p0, s.p1],
                lambda ps: [(s := t_b.build(ps[0])).p0, s.p1], [p])


def test_parametric_multi_segment_boundary_matches_jax(rng):
    def make(bd, d, dtype):
        return bd.ParametricMultiSegmentBoundary(
            *segment_bases(d),
            [bd.ThicknessConstraint(0.0, "min"),
             bd.ThicknessConstraint(0.15, "min")],
            flip_norm=[True, False],
            material_list=[{"mat_in": 1, "mat_out": 0}] * 2, dtype=dtype)

    j_b, t_b = make(j_bd, j_dist, jnp.float64), make(t_bd, t_dist, F64)
    params = [rng.uniform(-0.2, 0.3, 21) for _ in range(2)]
    t_in = [torch.as_tensor(p) for p in params]
    j_in = [jnp.asarray(p) for p in params]
    j_build = jax.jit(j_b.build)
    for t, j in zip(t_b.constrain(t_in), jax.jit(j_b.constrain)(j_in)):
        close(t, j)
    for t, j in zip(t_b.build(t_in), j_build(j_in)):
        same_columns(t, j, SEG)
    assert len(list(t_b.parameters())) == 2
    for t, j in zip(t_b.build(), j_build(j_b.init_params())):
        same_columns(t, j, SEG)

    def flat(sets):
        return [a for s in sets for a in (s.p0, s.p1)]

    grads_match(lambda ps: flat(j_b.build(ps)),
                lambda ps: flat(t_b.build(ps)), params)


def master_slave(bd, mesh, dtype):
    """Masters on the +x half of a hexagon; each slave follows the master
    at its mirror image across x = 0."""
    def masters(v):
        return [i for i in range(v.shape[0]) if v[i, 0] >= -1e-9]

    def attach(v, m, unclaimed):
        mirror = v[m] * np.array([-1.0, 1.0, 1.0])
        return [i for i in unclaimed
                if np.linalg.norm(v[i] - mirror) < 1e-6]

    return bd.MasterSlaveParametricTriangleBoundary(
        masters, attach, mesh, bd.FromVectorVG((0.0, 0.0, 1.0)),
        initial_parameters=0.1, **kw(dtype))


def test_master_slave_boundary_matches_jax(rng):
    j_m = j_mesh.hexagonal_mesh(1.0, 4)
    j_b = master_slave(j_bd, j_m, jnp.float64)
    t_b = master_slave(t_bd, t_mesh.TriMesh(j_m.points, j_m.faces), F64)
    np.testing.assert_array_equal(t_b.gather.numpy(), np.asarray(j_b.gather))
    np.testing.assert_array_equal(t_b.masters, j_b.masters)
    assert t_b.n_params == j_b.n_params < j_m.n_points
    close(t_b.init_params(), j_b.init_params(), 0.0)
    p = rng.uniform(-0.2, 0.2, t_b.n_params)
    same_columns(t_b.build(torch.as_tensor(p)),
                 jax.jit(j_b.build)(jnp.asarray(p)), TRI)
    grads_match(lambda ps: [(s := j_b.build(ps[0])).vp, s.v1, s.v2],
                lambda ps: [(s := t_b.build(ps[0])).vp, s.v1, s.v2], [p])


def test_parametric_asphere_boundary_matches_jax(rng):
    def make(bd, dtype):
        return bd.ParametricAsphereBoundary(
            (0.5, 0.0, 0.1), (1.0, 0.2, 0.0), 0.8, 0.25, n_aspheric=2,
            initial_curvature=0.3, initial_conic=-0.5, flip_norm=True,
            **kw(dtype))

    j_b, t_b = make(j_bd, jnp.float64), make(t_bd, F64)
    j_build = jax.jit(j_b.build)
    close(t_b.init_params(), j_b.init_params(), 0.0)
    same_columns(t_b.build(), j_build(j_b.init_params()), TRI)
    p = np.array([0.4, -1.3, 0.05, -0.02])
    same_columns(t_b.build(torch.as_tensor(p)), j_build(jnp.asarray(p)), TRI)
    np.testing.assert_allclose(t_b.updated_mesh(torch.as_tensor(p)).points,
                               j_b.updated_mesh(jnp.asarray(p)).points,
                               rtol=TOL, atol=TOL)
    grads_match(lambda ps: [(s := j_b.build(ps[0])).vp, s.v1, s.v2],
                lambda ps: [(s := t_b.build(ps[0])).vp, s.v1, s.v2], [p])


@pytest.mark.parametrize("flip", [False, True])
def test_parametric_asphere_segment_matches_jax(flip):
    def make(bd, dtype):
        return bd.ParametricAsphereSegment(
            0.35, 0.95, resolution=16, n_aspheric=1, initial_curvature=0.42,
            flip_norm=flip, **kw(dtype))

    j_b, t_b = make(j_bd, jnp.float64), make(t_bd, F64)
    j_build = jax.jit(j_b.build)
    same_columns(t_b.build(), j_build(j_b.init_params()), SEG)
    p = np.array([-0.5, -2.0, 0.08])
    same_columns(t_b.build(torch.as_tensor(p)), j_build(jnp.asarray(p)), SEG)
    grads_match(lambda ps: [(s := j_b.build(ps[0])).p0, s.p1],
                lambda ps: [(s := t_b.build(ps[0])).p0, s.p1], [p])
