"""The port's matplotlib drawers (``drawing.py``) and the mesh drawing
helpers (``models/mesh.visualize_*``) against the JAX package's, headless
(Agg): the matplotlib cases of tests/test_drawing.py, each drawer's artist
data (segments, colour arrays, arrow ends, patches, quiver vectors) equal
to the JAX drawer's on the same scene within 1e-12, also when the port's
drawer is fed tensors that require a gradient.  The JAX package's two
pyvista cases have no counterpart: its pyvista drawers are not ported."""

import math

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tensorflowraytrace_tpu import RaySet as JRaySet  # noqa: E402
from tensorflowraytrace_tpu import Scene2D as JScene2D  # noqa: E402
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet  # noqa: E402
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig  # noqa: E402
from tensorflowraytrace_tpu import drawing as j_drawing  # noqa: E402
from tensorflowraytrace_tpu import trace as j_trace  # noqa: E402
from tensorflowraytrace_tpu.models import boundaries as j_bd  # noqa: E402
from tensorflowraytrace_tpu.models import mesh as j_mesh  # noqa: E402
from tensorflowraytrace_tpu.models.surfaces import ArcSet as JArcSet  # noqa: E402
from tensorflowraytrace_tpu.models.surfaces import TriangleSet as JTriangleSet  # noqa: E402
from tensorflowraytrace_tpu.ops import materials as j_mats  # noqa: E402
from tensorflowraytrace_tpu_torch import (  # noqa: E402
    ArcSet, RaySet, Scene2D, SegmentSet, TraceConfig, TriangleSet, config,
    drawing, trace,
)
from tensorflowraytrace_tpu_torch.models import boundaries as bd  # noqa: E402
from tensorflowraytrace_tpu_torch.models import mesh  # noqa: E402
from tensorflowraytrace_tpu_torch.ops import materials as mats  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (a fixture)

F64 = torch.float64
PI = math.pi
ATOL = 1e-12


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


@pytest.fixture
def axes():
    """A 2D axis for the port's drawer and one for the JAX drawer's."""
    fig, (a, b) = plt.subplots(1, 2)
    yield a, b
    plt.close(fig)


@pytest.fixture
def axes3d():
    fig = plt.figure()
    yield fig.add_subplot(1, 2, 1, projection="3d"), \
        fig.add_subplot(1, 2, 2, projection="3d")
    plt.close(fig)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=0, atol=ATOL)


def grad_leaf(x):
    return torch.tensor(x, dtype=F64, requires_grad=True)


def arrow_ends(arrows):
    return [(a.xy, a.xyann) for a in arrows]


def segments3d(collection):
    return np.asarray(collection._segments3d, dtype=np.float64)


P0 = [[0.0, 0.0], [1.0, 1.0]]
P1 = [[1.0, 0.0], [2.0, 2.0]]


@pytest.mark.parametrize("requires_grad", [False, True],
                         ids=["tensor", "grad_tensor"])
def test_ray_drawer_2d(axes, requires_grad):
    make = grad_leaf if requires_grad else (lambda x: torch.tensor(x, dtype=F64))
    rays = RaySet(p0=make(P0), p1=make(P1), wavelength=make([500.0, 600.0]),
                  state=torch.zeros(2, dtype=torch.int32))
    d = drawing.RayDrawer2D(axes[0], rays)
    d.draw()
    j = j_drawing.RayDrawer2D(axes[1], JRaySet.make(
        P0, P1, [500.0, 600.0], dtype=jnp.float64))
    j.draw()
    assert len(d._line_collection.get_segments()) == 2
    close(d._line_collection.get_segments(), j._line_collection.get_segments())
    close(d._line_collection.get_array(), j._line_collection.get_array())
    assert (d._line_collection.norm.vmin, d._line_collection.norm.vmax) == \
        (j._line_collection.norm.vmin, j._line_collection.norm.vmax)


def test_ray_drawer_2d_empty_and_units(axes):
    d = drawing.RayDrawer2D(axes[0], None)
    d.draw()
    assert len(d._line_collection.get_segments()) == 0
    with pytest.raises(ValueError):
        drawing.RayDrawer2D(axes[0], None, units="parsec")
    um = drawing.RayDrawer2D(axes[0], None, units="um")
    j_um = j_drawing.RayDrawer2D(axes[1], None, units="um")
    assert um._line_collection.norm.vmax == j_um._line_collection.norm.vmax


@pytest.mark.parametrize("requires_grad", [False, True],
                         ids=["tensor", "grad_tensor"])
def test_segment_drawer_with_norms(axes, requires_grad):
    make = grad_leaf if requires_grad else (lambda x: torch.tensor(x, dtype=F64))
    segs = SegmentSet(p0=make([[0.0, 0.0], [1.0, 2.0]]),
                      p1=make([[1.0, 0.0], [3.0, -1.0]]),
                      category=torch.zeros(2, dtype=torch.int32),
                      mat_in=torch.zeros(2, dtype=torch.int32),
                      mat_out=torch.zeros(2, dtype=torch.int32))
    d = drawing.SegmentDrawer(axes[0], segs, draw_norm_arrows=True)
    d.draw()
    j = j_drawing.SegmentDrawer(axes[1], JSegmentSet.make(
        [[0.0, 0.0], [1.0, 2.0]], [[1.0, 0.0], [3.0, -1.0]],
        dtype=jnp.float64), draw_norm_arrows=True)
    j.draw()
    assert len(d._arrows) == 2
    close(d._line_collection.get_segments(), j._line_collection.get_segments())
    close(arrow_ends(d._arrows), arrow_ends(j._arrows))


def test_arc_drawer(axes):
    arcs = ArcSet.make([[0.0, 0.0], [2.0, 1.0]], [-PI / 2, 0.3], [PI / 2, 4.0],
                       [1.0, -0.5], dtype=F64)
    d = drawing.ArcDrawer(axes[0], arcs, draw_norm_arrows=True,
                          norm_arrow_count=3)
    d.draw()
    j = j_drawing.ArcDrawer(axes[1], JArcSet.make(
        [[0.0, 0.0], [2.0, 1.0]], jnp.asarray([-PI / 2, 0.3]),
        jnp.asarray([PI / 2, 4.0]), jnp.asarray([1.0, -0.5]),
        dtype=jnp.float64), draw_norm_arrows=True, norm_arrow_count=3)
    j.draw()
    assert len(d._patches) == 2 and len(d._arrows) == 6
    for p, q in zip(d._patches, j._patches):
        close([*p.center, p.width, p.height, p.theta1, p.theta2],
              [*q.center, q.width, q.height, q.theta1, q.theta2])
    close(arrow_ends(d._arrows), arrow_ends(j._arrows))
    d.draw()  # a redraw clears and rebuilds
    assert len(d._patches) == 2


def test_ray_drawer_3d(axes3d):
    p0, p1 = [[0.0, 0.0, 0.0], [1.0, -1.0, 2.0]], [[1.0, 1.0, 1.0],
                                                   [0.5, 0.0, 0.0]]
    rays = RaySet.make(grad_leaf(p0), grad_leaf(p1), 500.0, dtype=F64)
    d = drawing.RayDrawer3D(axes3d[0], rays)
    d.draw()
    j = j_drawing.RayDrawer3D(axes3d[1], JRaySet.make(p0, p1, 500.0,
                                                      dtype=jnp.float64))
    j.draw()
    assert segments3d(d._collection).shape == (2, 2, 3)
    close(segments3d(d._collection), segments3d(j._collection))
    close(d._collection.get_array(), j._collection.get_array())
    axes3d[0].figure.canvas.draw()


def triangle_sets(m):
    pts, faces = m.points, m.faces
    port = TriangleSet.make(pts[faces[:, 0]], pts[faces[:, 1]],
                            pts[faces[:, 2]], dtype=F64)
    return port, JTriangleSet.from_vertices_faces(pts, faces,
                                                  dtype=jnp.float64)


def test_triangle_drawer_from_mesh_and_set(axes3d):
    m, jm = mesh.hexagonal_mesh(1.0, 2), j_mesh.hexagonal_mesh(1.0, 2)
    d = drawing.TriangleDrawer(axes3d[0], m, draw_norm_arrows=True)
    d.draw()
    j = j_drawing.TriangleDrawer(axes3d[1], jm, draw_norm_arrows=True)
    j.draw()
    close(d._triangles(), j._triangles())
    close(segments3d(d._quiver), segments3d(j._quiver))
    port_set, jax_set = triangle_sets(m)
    d2 = drawing.TriangleDrawer(axes3d[0], port_set)
    d2.draw()
    assert d2._poly is not None
    close(d2._triangles(), j_drawing.TriangleDrawer(axes3d[1],
                                                    jax_set)._triangles())


def test_triangle_drawer_parameter_arrows(axes3d):
    """One parameter arrow a vertex along the direction its parameter
    moves it; both arrow kinds toggle."""
    zm, j_zm = mesh.hexagonal_mesh(1.0, 2), j_mesh.hexagonal_mesh(1.0, 2)
    boundary = bd.ParametricTriangleBoundary(
        zm, bd.FromVectorVG((0.0, 0.0, 1.0)), dtype=F64, device="cpu")
    params = boundary.init_params() + 0.1
    j_boundary = j_bd.ParametricTriangleBoundary(
        j_zm, j_bd.FromVectorVG((0.0, 0.0, 1.0)), dtype=jnp.float64)
    j_params = j_boundary.init_params() + 0.1
    d = drawing.TriangleDrawer(
        axes3d[0], boundary.build(params), draw_norm_arrows=True,
        draw_parameter_arrows=True, boundary=boundary,
        params=params.requires_grad_(True))
    d.draw()
    j = j_drawing.TriangleDrawer(
        axes3d[1], j_boundary.build(j_params), draw_norm_arrows=True,
        draw_parameter_arrows=True, boundary=j_boundary, params=j_params)
    j.draw()
    close(segments3d(d._param_quiver), segments3d(j._param_quiver))
    close(segments3d(d._quiver), segments3d(j._quiver))
    d.toggle_parameter_arrow_visibility()
    assert d._param_quiver is None
    d.toggle_norm_arrow_visibility()
    assert d._quiver is None
    d.toggle_parameter_arrow_visibility()
    assert d._param_quiver is not None


def test_goal_drawer(axes3d):
    rng = np.random.default_rng(0)
    out, goal = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    d = drawing.GoalDrawer3D(axes3d[0])
    d.output, d.goal = grad_leaf(out), torch.tensor(goal)
    d.draw()
    j = j_drawing.GoalDrawer3D(axes3d[1])
    j.output, j.goal = out, goal
    j.draw()
    close(segments3d(d._quiver), segments3d(j._quiver))


def test_history_rays_flatten(axes):
    mirror = SegmentSet.make([[1.0, -5.0]], [[1.0, 5.0]], mat_in=1, dtype=F64)
    target = SegmentSet.make([[-1.0, -5.0]], [[-1.0, 5.0]], dtype=F64)
    scene = Scene2D.build(optical_segments=[mirror], target_segments=[target])
    rays = RaySet.make([[0.0, 0.0]], [[1.0, 0.5]], 500.0, dtype=F64)
    res = trace(rays, scene, (mats.vacuum, mats.reflective),
                TraceConfig(max_bounces=3, keep_history=True))
    flat = drawing.history_rays(res)
    j_scene = JScene2D.build(
        optical_segments=[JSegmentSet.make([[1.0, -5.0]], [[1.0, 5.0]],
                                           mat_in=1, dtype=jnp.float64)],
        target_segments=[JSegmentSet.make([[-1.0, -5.0]], [[-1.0, 5.0]],
                                          dtype=jnp.float64)])
    j_res = j_trace(JRaySet.make([[0.0, 0.0]], [[1.0, 0.5]], 500.0,
                                 dtype=jnp.float64), j_scene,
                    (j_mats.vacuum, j_mats.reflective),
                    JTraceConfig(max_bounces=3, keep_history=True))
    j_flat = j_drawing.history_rays(j_res)
    assert flat["x_start"].shape == (2,)
    for key in flat:
        close(flat[key], j_flat[key])
    d = drawing.RayDrawer2D(axes[0], flat)
    d.draw()
    assert len(d._line_collection.get_segments()) == 2


def test_disable_key_commands():
    drawing.disable_figure_key_commands()
    assert plt.rcParams["keymap.save"] == []
    drawing.redraw_current_figure()


def test_mesh_visualize_helpers(axes3d):
    m, jm = mesh.hexagonal_mesh(1.0, 3), j_mesh.hexagonal_mesh(1.0, 3)
    top = mesh.get_closest_point(m, (0.0, 0.0, 0.0))
    _, children, _, _ = mesh.find_all_relationships(m, top)
    generations = mesh.find_generations(m, top)
    vum, _ = mesh.mesh_parametrization_tools(m, top)
    a, b = axes3d
    close(segments3d(mesh.visualize_connections(a, m, children)),
          segments3d(j_mesh.visualize_connections(b, jm, children)))
    for s, t in zip(mesh.visualize_generations(a, m, generations),
                    j_mesh.visualize_generations(b, jm, generations)):
        close(np.stack(s._offsets3d, 1), np.stack(t._offsets3d, 1))
        close(s.get_facecolor(), t.get_facecolor())
    close(segments3d(mesh.visualize_face_updates(a, m, torch.as_tensor(vum))),
          segments3d(j_mesh.visualize_face_updates(b, jm, vum)))
    assert mesh.visualize_connections(a, m, [[] for _ in children]) is None


def test_the_package_imports_no_matplotlib():
    """The facade imports ``drawing.history_rays``; matplotlib is imported
    only by the drawers, so the port runs where it is missing."""
    import subprocess
    import sys

    code = ("import sys, tensorflowraytrace_tpu_torch, "
            "tensorflowraytrace_tpu_torch.system, "
            "tensorflowraytrace_tpu_torch.drawing, "
            "tensorflowraytrace_tpu_torch.facade, "
            "tensorflowraytrace_tpu_torch.utils.export, "
            "tensorflowraytrace_tpu_torch.utils.profiling; "
            "print('matplotlib' in sys.modules)")
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root, timeout=120)
    assert out.stdout.strip() == "False"
