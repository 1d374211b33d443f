"""The stateful facade (``system.py``, ``update.py``, ``drawing.history_rays``)
against the JAX package's, on the CPU in float64.

Each case of the JAX ``tests/test_system.py`` is run through the port, with
its own assertions, and held against the JAX facade wherever the facade
computes a result: the ``intersect()`` dicts (hit indices and validity
exactly, floats within 1e-12), the traced rays (states exactly, endpoints
and intensities within 1e-12; 1e-9 in 3D), ``all_rays``, the
``SGD_Optimizer`` errors (rtol 1e-9), and the ``validate_system`` refusals
(the same exception with the same message).  The port's random sources draw
from its own generator, so the 3D lens case traces the JAX system's rays
through the port's.  ``OldestAncestor.annotate`` runs through both facades;
``SGD_Optimizer(mesh=...)`` runs on a one-rank gloo group against the
single process.  The JAX facade's jit cache has no counterpart: the port's
``jit=`` flag changes nothing.
"""

import math
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import tensorflowraytrace_tpu as J
import tensorflowraytrace_tpu.system as j_system
import tensorflowraytrace_tpu_torch as T
import tensorflowraytrace_tpu_torch.system as t_system
from tensorflowraytrace_tpu import operations as j_ops
from tensorflowraytrace_tpu.models import boundaries as j_bd
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.ops import thinfilm as j_thinfilm
from tensorflowraytrace_tpu_torch import config, operations as t_ops, streamed
from tensorflowraytrace_tpu_torch.models import boundaries as t_bd
from tensorflowraytrace_tpu_torch.models import distributions as t_dist
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh
from tensorflowraytrace_tpu_torch.models import sources as t_src
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.ops import thinfilm as t_thinfilm
from tensorflowraytrace_tpu_torch.parallel import sharding as t_par
from tensorflowraytrace_tpu_torch.utils.convert import rayset_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PI = math.pi
ATOL = 1e-12
ATOL_3D = 1e-9
RAINBOW = [680.0, 620.0, 575.0, 510.0, 450.0, 400.0]


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


JAX = types.SimpleNamespace(
    pkg=J, system=j_system, ops=j_ops, bd=j_bd, dist=j_dist, mesh=j_mesh,
    src=j_src, mats=j_mats, thinfilm=j_thinfilm, f64=jnp.float64,
    torch=False)
PORT = types.SimpleNamespace(
    pkg=T, system=t_system, ops=t_ops, bd=t_bd, dist=t_dist, mesh=t_mesh,
    src=t_src, mats=t_mats, thinfilm=t_thinfilm, f64=torch.float64,
    torch=True)


def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def bare_arc(m, **mats):
    return m.bd.manual_arc_boundary(
        x_center=[5.0], y_center=[0.0], angle_start=[3 * PI / 4],
        angle_end=[5 * PI / 4], radius=[5.0], dtype=m.f64, **mats)


def build_single_arc_system(m, wavelengths=RAINBOW):
    """The optimize_single_arc setup in facade style."""
    target = m.pkg.SegmentSet.make([[10.0, -5.0]], [[10.0, 5.0]], dtype=m.f64)
    beam = m.dist.StaticUniformBeam(-1.5, 1.5, 10)
    angles = m.dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    source = m.src.AngularSource(2, (-1.0, 0.0), 0.0, angles, beam,
                                 list(wavelengths))
    system = m.system.OpticalSystem2D(dtype=m.f64)
    system.optical_arcs = [bare_arc(m, mat_in=1, mat_out=0)]
    system.sources = [source]
    system.target_segments = [target]
    system.materials = [{"n": m.mats.vacuum}, {"n": m.mats.acrylic}]
    return system


def engine_on(m, system, *args, **kwargs):
    engine = m.system.OpticalEngine(*args, **kwargs)
    engine.optical_system = system
    return engine


def assert_rays_equal(got, want, atol=ATOL, fields=()):
    np.testing.assert_array_equal(host(got.state), host(want.state))
    np.testing.assert_allclose(host(got.p0), host(want.p0), rtol=0, atol=atol)
    np.testing.assert_allclose(host(got.p1), host(want.p1), rtol=0, atol=atol)
    for f in fields:
        np.testing.assert_allclose(host(got[f]), host(want[f]), rtol=0,
                                   atol=atol)


@pytest.fixture(scope="module")
def jax_arc_trace():
    """The JAX facade's 2-bounce trace of the single-arc system, with
    history."""
    system = build_single_arc_system(JAX)
    engine = engine_on(JAX, system, 2, keep_history=True)
    system.update()
    engine.ray_trace(2)
    return engine


def test_2d_system_trace_via_engine(jax_arc_trace):
    system = build_single_arc_system(PORT)
    engine = engine_on(PORT, system, 2, simple_ray_inheritance={"wavelength"})
    system.update()
    engine.validate_system()
    engine.ray_trace(2)
    finished = engine.finished_rays
    assert finished.n_rays == 60  # all 10 beams x 6 wavelengths reach x=10
    np.testing.assert_allclose(host(finished.p1[:, 0]), 10.0, atol=1e-9)
    assert_rays_equal(engine.result.rays, jax_arc_trace.result.rays)
    # the four views partition the slots
    assert (engine.finished_rays.n_rays + engine.stopped_rays.n_rays
            + engine.dead_rays.n_rays + engine.active_rays.n_rays) == 60


def intersect_rays(m):
    """Horizontal unit rays from x=-1 plus one starting ON the target."""
    ys = np.linspace(-1.5, 1.5, 7)
    p0 = np.stack([np.full(7, -1.0), ys], axis=1)
    p0 = np.vstack([p0, [[10.0, 0.0]]])
    p1 = p0 + np.asarray([1.0, 0.0])
    return ys, m.pkg.RaySet.make(p0, p1, 575.0, dtype=m.f64)


def assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = host(got[key]), host(want[key])
        if key.startswith("gather") or key == "valid":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            valid = host(want["valid"])
            np.testing.assert_allclose(g[valid], w[valid], rtol=0, atol=ATOL,
                                       err_msg=key)


def test_2d_system_intersect_facade():
    """system.intersect(rays): segment and arc dicts, garbage under
    ~valid, and the ray-start epsilon rejecting the self-intersection."""
    results = {}
    for m in (JAX, PORT):
        system = build_single_arc_system(m)
        system.update()
        ys, rays = intersect_rays(m)
        results[m.torch] = system.intersect(rays)
    seg, arc = results[True]
    assert set(seg) == {"x", "y", "valid", "ray_u", "segment_u",
                        "gather_ray", "gather_segment", "norm"}
    assert set(arc) == {"x", "y", "valid", "ray_u", "arc_u",
                        "gather_ray", "gather_arc", "norm"}
    sv = host(seg["valid"])
    assert sv[:7].all() and not sv[7]
    np.testing.assert_allclose(host(seg["x"])[:7], 10.0, atol=1e-9)
    np.testing.assert_allclose(host(seg["segment_u"])[:7], (ys + 5.0) / 10.0,
                               atol=1e-9)
    np.testing.assert_allclose(host(seg["ray_u"])[:7], 11.0, atol=1e-9)
    np.testing.assert_array_equal(host(seg["gather_ray"]), np.arange(8))
    np.testing.assert_array_equal(host(seg["gather_segment"])[:7], 0)
    av = host(arc["valid"])
    assert av[:7].all()
    np.testing.assert_allclose(host(arc["x"])[:7],
                               5.0 - np.sqrt(25.0 - ys ** 2), atol=1e-9)
    np.testing.assert_allclose(
        np.abs(host(arc["norm"])[:7]),
        np.abs(np.arctan2(ys, host(arc["x"])[:7] - 5.0)), atol=1e-9)
    for got, want in zip(results[True], results[False]):
        assert_dicts_equal(got, want)


def wall(m, x=1.0, half=2.0, **kw):
    return m.pkg.TriangleSet.make(
        [[x, -half, -half], [x, half, half]],
        [[x, half, -half], [x, -half, half]],
        [[x, half, half], [x, -half, -half]], dtype=m.f64, **kw)


def test_3d_system_intersect_facade():
    """3D system.intersect: hit point, barycentric parameters, gather
    indices, the gathered normal; an empty system gives {}."""
    p0 = np.asarray([[0.0, 0.3, -0.2], [0.0, 0.0, 0.0], [0.0, 0.0, 5.0]])
    p1 = p0 + np.asarray([[1.0, 0.0, 0.0]])
    results = {}
    for m in (JAX, PORT):
        system = m.system.OpticalSystem3D(dtype=m.f64)
        system.optical = [wall(m, mat_in=1, mat_out=0)]
        system.materials = [{"n": m.mats.vacuum}, {"n": m.mats.acrylic}]
        system.update()
        rays = m.pkg.RaySet.make(p0, p1, 575.0, dtype=m.f64)
        results[m.torch] = system.intersect(rays)
        assert m.system.OpticalSystem3D(dtype=m.f64).intersect(rays) == {}
    res = results[True]
    v = host(res["valid"])
    assert v[0] and v[1] and not v[2]
    np.testing.assert_allclose(host(res["x"])[:2], 1.0, atol=1e-12)
    np.testing.assert_allclose(host(res["y"])[:2], p0[:2, 1], atol=1e-12)
    np.testing.assert_allclose(host(res["z"])[:2], p0[:2, 2], atol=1e-12)
    np.testing.assert_allclose(host(res["ray_u"])[:2], 1.0, atol=1e-12)
    tu, tv = host(res["trig_u"])[:2], host(res["trig_v"])[:2]
    assert ((tu >= 0) & (tv >= 0) & (tu + tv <= 1)).all()
    np.testing.assert_array_equal(host(res["gather_ray"]), np.arange(3))
    np.testing.assert_allclose(np.abs(host(res["norm"])[:2, 0]), 1.0,
                               atol=1e-12)
    assert_dicts_equal(results[True], results[False])


def test_engine_all_rays_history(jax_arc_trace):
    system = build_single_arc_system(PORT)
    engine = engine_on(PORT, system, 2, keep_history=True)
    system.update()
    engine.ray_trace(2)
    rays = engine.all_rays
    # each of the 60 rays appears twice (source->arc, arc->target)
    assert rays["x_start"].shape == (120,)
    want = jax_arc_trace.all_rays
    assert set(rays) == set(want)
    for key in want:
        np.testing.assert_allclose(rays[key], np.asarray(want[key]), rtol=0,
                                   atol=ATOL, err_msg=key)
    bare = engine_on(PORT, system, 2)
    bare.ray_trace(2)
    with pytest.raises(RuntimeError, match="keep_history"):
        bare.all_rays


def test_annotation_helper_reapplies_on_update(jax_arc_trace):
    system = build_single_arc_system(PORT)
    system.optical_arcs = [bare_arc(PORT)]
    entry = system.optical_arcs[0]
    t_system.annotation_helper(entry, "mat_in", 1, "x_center",
                               dtype=torch.int32)
    t_system.annotation_helper(entry, "mat_out", 0, "x_center",
                               dtype=torch.int32)
    system.update()
    assert int(system.optical_arcs[0].surface_set.mat_in[0]) == 1
    engine = engine_on(PORT, system, 2)
    engine.ray_trace(2)
    assert engine.finished_rays.n_rays == 60
    # the annotated system is the single-arc system
    assert_rays_equal(engine.result.rays, jax_arc_trace.result.rays)


def refusal(m, mutate, exc):
    """The exception ``validate_system`` raises on the single-arc system
    after ``mutate(m, system)``."""
    system = build_single_arc_system(m)
    mutate(m, system)
    system.update()
    engine = engine_on(m, system, 2)
    with pytest.raises(exc) as info:
        engine.validate_system()
    return info.value


def same_refusal(mutate, exc, match):
    """Both facades refuse alike: the same type and the same message."""
    got = refusal(PORT, mutate, exc)
    want = refusal(JAX, mutate, exc)
    assert type(got) is type(want)
    assert str(got) == str(want)
    assert re.search(match, str(got)), str(got)


def test_validate_system_catches_bad_material_index():
    def mutate(m, system):
        system.materials = [{"n": m.mats.vacuum}]  # mat_in=1 out of range
    same_refusal(mutate, ValueError, "material index")


def test_engine_dimension_mismatch():
    for m in (JAX, PORT):
        system = build_single_arc_system(m)
        engine = m.system.OpticalEngine(3)
        with pytest.raises(ValueError):
            engine.optical_system = system


def lens_system(m, rays=None):
    """The parametric-lens system of the JAX test: a random source (or the
    given rays), a two-surface lens on a hexagonal mesh, a far target."""
    zero_mesh = m.mesh.hexagonal_mesh(1.2, 3)
    pts = np.asarray(zero_mesh.points).copy()
    zero_mesh.points = np.stack([pts[:, 2], pts[:, 0], pts[:, 1]], axis=1)
    lens = m.bd.ParametricMultiTriangleBoundary(
        zero_mesh, m.bd.FromVectorVG((1.0, 0.0, 0.0)),
        [m.bd.ThicknessConstraint(0.0, "min"),
         m.bd.ThicknessConstraint(0.2, "min")],
        [True, False], material_list=[{"mat_in": 1, "mat_out": 0}] * 2,
        dtype=m.f64)
    rc = 16
    source = rays if rays is not None else m.src.AngularSource(
        3, (-4.0, 0.0, 0.0), (1.0, 0.0, 0.0),
        m.dist.RandomUniformSphere(PI / 16.0, rc),
        m.dist.RandomUniformSquare(0.2, 4), [575.0] * rc, dense=False)
    system = m.system.OpticalSystem3D(dtype=m.f64)
    system.optical = [lens]
    system.targets = [wall(m, x=8.0, half=50.0)]
    system.sources = [source]
    system.materials = [{"n": m.mats.vacuum}, {"n": m.mats.acrylic}]
    system.update()
    return system, lens, rc


def test_3d_system_with_parametric_lens():
    system, lens, rc = lens_system(PORT)
    engine = engine_on(PORT, system, 3)
    engine.validate_system()
    engine.ray_trace(3)
    assert engine.finished_rays.n_rays == rc
    # mutate the lens parameters; update() rebuilds the scene from them
    with torch.no_grad():
        for p in lens.param_list():
            p += 0.1
    system.update()
    engine.ray_trace(3)
    assert engine.finished_rays.n_rays == rc
    # a random source re-samples on update, from the system's generator
    r1 = host(system.sources.p0)
    system.update()
    assert not np.allclose(r1, host(system.sources.p0))

    # against the JAX facade on the JAX system's rays, before and after the
    # same parameter move
    j_sys, j_lens, _ = lens_system(JAX)
    jr = j_sys.sources
    j_sys.sources = [jr]  # fixed rays: update() re-samples no more
    rays = rayset_from_numpy(np.asarray(jr.p0), np.asarray(jr.p1),
                             np.asarray(jr.wavelength),
                             fields={k: np.asarray(v)
                                     for k, v in jr.fields.items()},
                             dtype=torch.float64)
    t_sys, t_lens, _ = lens_system(PORT, rays=rays)
    j_eng, t_eng = engine_on(JAX, j_sys, 3), engine_on(PORT, t_sys, 3)
    for move in (False, True):
        if move:
            j_lens.parameters = [p + 0.1 for p in j_lens.parameters]
            with torch.no_grad():
                for p in t_lens.param_list():
                    p += 0.1
            j_sys.update()
            t_sys.update()
        j_eng.ray_trace(3)
        t_eng.ray_trace(3)
        assert_rays_equal(t_eng.result.rays, j_eng.result.rays, ATOL_3D)


def test_amalgamate_field_dicts():
    outs = []
    for m, asarray in ((JAX, jnp.asarray), (PORT, torch.tensor)):
        a = {"x": asarray([1.0, 2.0]), "y": asarray([0.0, 0.0])}
        b = {"x": asarray([3.0]), "y": asarray([1.0]), "z": asarray([9.0])}
        outs.append(m.system.amalgamate([a, b]))
        assert m.system.amalgamate([{}, {}]) == {}
    got, want = outs[1], outs[0]
    assert set(got) == {"x", "y"} == set(want)
    np.testing.assert_allclose(host(got["x"]), [1.0, 2.0, 3.0])
    for key in want:
        np.testing.assert_array_equal(host(got[key]), np.asarray(want[key]))


class TorchTrainableArc:
    """Minimal parametric arc: x_center == radius == p[0]."""

    def __init__(self):
        self.parameters = None

    def init_params(self):
        return torch.tensor([5.0], dtype=torch.float64)

    def build(self, p):
        r = p[0]
        center = torch.stack([torch.stack([r, torch.zeros_like(r)])])
        return T.ArcSet.make(center, 3 * PI / 4, 5 * PI / 4, r, mat_in=1,
                             mat_out=0, dtype=torch.float64)


class JaxTrainableArc:
    def __init__(self):
        self.parameters = None

    def init_params(self):
        return jnp.asarray([5.0], jnp.float64)

    def build(self, p):
        r = p[0]
        center = jnp.stack([jnp.stack([r, jnp.asarray(0.0, jnp.float64)])])
        return J.ArcSet.make(center, 3 * PI / 4, 5 * PI / 4, r, mat_in=1,
                             mat_out=0, dtype=jnp.float64)


def facade_sgd_problem(m):
    arc = TorchTrainableArc() if m.torch else JaxTrainableArc()
    system = build_single_arc_system(m, [680.0, 575.0, 450.0])
    system.optical_arcs = [arc]
    system.update()
    engine = engine_on(m, system, 2)
    xp = torch if m.torch else jnp

    def error_function(result):
        fin = result.rays.state == m.pkg.FINISHED
        return xp.sum(xp.where(fin, result.rays.p1[:, 1] ** 2, 0.0))

    return engine, error_function, arc


SGD_KW = dict(trace_depth=2, learning_rate=1.0, grad_clip=0.1)


@pytest.fixture(scope="module")
def jax_sgd_errors():
    """The JAX facade's first three SGD_Optimizer steps."""
    engine, error_function, arc = facade_sgd_problem(JAX)
    opt = j_system.SGD_Optimizer(engine, error_function=error_function,
                                 **SGD_KW)
    errors = [opt.single_step(None, momentum=0.8) for _ in range(3)]
    return np.asarray(errors), float(arc.parameters[0])


def test_sgd_optimizer_facade_single_arc(jax_sgd_errors):
    """SGD_Optimizer(engine, erf, depth) optimizes the arc through the
    facade; its first steps equal the JAX facade's."""
    engine, error_function, arc = facade_sgd_problem(PORT)
    opt = t_system.SGD_Optimizer(engine, error_function=error_function,
                                 **SGD_KW)
    first = [opt.single_step(None, momentum=0.8) for _ in range(3)]
    want, want_param = jax_sgd_errors
    np.testing.assert_allclose(first, want, rtol=1e-9)
    np.testing.assert_allclose(float(arc.parameters[0]), want_param,
                               rtol=1e-9)
    errors = opt.run_phase(58, None, lr_scale=0.5, momentum=0.8)
    assert errors[-1] < 0.1 * first[0]
    # parameters written back into the engine's boundary
    assert abs(float(arc.parameters[0]) - 5.0) > 0.1
    engine.ray_trace(2)
    assert float(engine.finished_rays.p1[:, 1].abs().max()) < 0.5
    with pytest.raises(NotImplementedError):
        opt.process_gradient()


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process."""
    t_par.init_multihost("gloo", init_method="tcp://localhost:"
                         f"{streamed.free_port()}", world_size=1, rank=0)
    try:
        yield t_par.ray_mesh()
    finally:
        dist.destroy_process_group()


def test_sgd_optimizer_facade_mesh(one_rank_group, jax_sgd_errors):
    """SGD_Optimizer(mesh=...) on a one-rank gloo group: the rank-mean loss
    equals the single process's exactly (adding mesh= rescales nothing)
    and the JAX facade's step 0; the run converges."""
    def make(mesh):
        engine, error_function, arc = facade_sgd_problem(PORT)
        opt = t_system.SGD_Optimizer(
            engine, error_function=error_function, mesh=mesh,
            generator=torch.Generator().manual_seed(0), **SGD_KW)
        return opt, arc

    meshed, arc = make(one_rank_group)
    single, _ = make(None)
    e0 = meshed.single_step(None, momentum=0.8)
    assert e0 == single.single_step(None, momentum=0.8)
    np.testing.assert_allclose(e0, jax_sgd_errors[0][0], rtol=1e-9)
    errors = meshed.run_phase(40, None, lr_scale=0.5, momentum=0.8)
    assert errors[-1] < 0.1 * e0
    assert abs(float(arc.parameters[0]) - 5.0) > 0.1


def test_validate_system_missing_mat_annotation():
    """An optical boundary built without material annotation is named, with
    the missing fields spelled out."""
    def mutate(m, system):
        system.optical_arcs = [bare_arc(m)]
    same_refusal(mutate, RuntimeError, r"optical arcs\[0\].*mat_in")


def test_validate_system_missing_wavelength_index_mode():
    """Index-mode dispersion needs real wavelengths: rays without them fail
    the sources audit."""
    def mutate(m, system):
        system.sources = [m.pkg.RaySet.make([[-1.0, 0.1]], [[0.0, 0.1]],
                                            dtype=m.f64)]
    same_refusal(mutate, RuntimeError, "sources.*wavelength")


def test_validate_system_value_mode_missing_n_fields():
    """'value' mode requires n_in / n_out fields on optical surfaces."""
    def mutate(m, system):
        system.materials = []
    same_refusal(mutate, RuntimeError, r"n_in.*n_out|n_out.*n_in")


def test_validate_system_material_missing_n_key():
    def mutate(m, system):
        system.materials = [{"n": m.mats.vacuum},
                            {"refractive": m.mats.acrylic}]
    same_refusal(mutate, RuntimeError, "material 1.*'n'")


def test_validate_system_mat_override_passes():
    """Annotating the materials through the entry satisfies the audit
    though the set was built bare."""
    system = build_single_arc_system(PORT)
    system.optical_arcs = [bare_arc(PORT)]
    entry = system.optical_arcs[0]
    t_system.annotation_helper(entry, "mat_in", 1, "x_center",
                               dtype=torch.int32)
    t_system.annotation_helper(entry, "mat_out", 0, "x_center",
                               dtype=torch.int32)
    system.update()
    engine_on(PORT, system, 2).validate_system()  # must not raise


def seeded_single_arc(m):
    system = build_single_arc_system(m)
    for entry in system._source_entries:
        entry._obj.extra_fields = {"intensity": ("whole", 1.0)}
        entry.update()
    return system


def intensity_run(m, op):
    system = seeded_single_arc(m)
    engine = engine_on(m, system, 2, operations=[op],
                       simple_ray_inheritance={"wavelength"})
    system.update()
    engine.validate_system()
    engine.ray_trace(2)
    return engine.finished_rays


@pytest.fixture(scope="module")
def jax_intensities():
    """The JAX facade's finished rays under FresnelIntensity and under an
    AR-coated ThinFilmIntensity."""
    d = float(j_thinfilm.quarter_wave_thickness(1.38, 550.0))
    return {
        "bare": intensity_run(JAX, j_ops.FresnelIntensity()),
        "coated": intensity_run(JAX, j_ops.ThinFilmIntensity(
            [[(1.38, d)]], {"arcs": np.asarray([0])})),
    }


def test_validate_system_fresnel_intensity_signature(jax_intensities):
    """FresnelIntensity needs the 'intensity' field: without it the audit
    names it; seeded, the system validates, traces and attenuates."""
    for m in (PORT, JAX):
        system = build_single_arc_system(m)
        engine = engine_on(m, system, 2, operations=[m.ops.FresnelIntensity()],
                           simple_ray_inheritance={"wavelength"})
        system.update()
        with pytest.raises(RuntimeError, match="intensity"):
            engine.validate_system()
    fin = intensity_run(PORT, t_ops.FresnelIntensity())
    inten = host(fin["intensity"])
    assert inten.shape == (60,)
    assert (inten < 1.0).all() and (inten > 0.8).all()
    assert_rays_equal(fin, jax_intensities["bare"], fields=("intensity",))


def test_exclusion_clash_raises():
    for m in (JAX, PORT):
        class NoGhosts(m.ops.RayOperation):
            exclusions = frozenset({m.ops.GhostThrough})

        with pytest.raises(RuntimeError, match="exclusive operations"):
            m.system.OpticalEngine(2, operations=[NoGhosts(),
                                                  m.ops.GhostThrough()])


def test_validate_system_custom_op_target_signature():
    """An operation's target_signature joins the audit: a target lacking
    the field is named; annotating it passes."""
    for m in (JAX, PORT):
        class NeedsGoal(m.ops.RayOperation):
            target_signature = frozenset({"goal_weight"})

        system = build_single_arc_system(m)
        system.update()
        engine = engine_on(m, system, 2,
                           operations=[m.ops.StandardReaction(), NeedsGoal()])
        with pytest.raises(RuntimeError,
                           match=r"target segments\[0\].*goal_weight"):
            engine.validate_system()
        m.system.annotation_helper(system.target_segments[0], "goal_weight",
                                   1.0, "x_start")
        system.update()
        engine.validate_system()


def mirror_run(m):
    """The single-arc system with a mirror segment at x=1 annotated through
    its entry, traced, then re-fed at x=2 and traced again."""
    system = build_single_arc_system(m)
    system.optical_arcs = []
    system.optical_segments = [m.pkg.SegmentSet.make([[1.0, -5.0]],
                                                     [[1.0, 5.0]], dtype=m.f64)]
    entry = system.optical_segments[0]
    entry["mat_in"] = 1
    entry["mat_out"] = 0
    system.materials = [{"n": m.mats.reflective}, {"n": m.mats.reflective}]
    system.update()
    engine = engine_on(m, system, 2)
    engine.ray_trace(2)
    n_before = engine.finished_rays.n_rays
    entry.feed_segments([[2.0, -5.0, 2.0, 5.0]])
    system.update()
    engine.ray_trace(2)
    return engine, entry, n_before


def test_feed_segments_refeed():
    """feed_segments re-feeds a manual boundary through its entry: the
    material overrides persist and the next trace uses the new geometry."""
    engine, entry, n_before = mirror_run(PORT)
    assert int(entry.surface_set.mat_in[0]) == 1
    assert engine.finished_rays.n_rays == n_before
    np.testing.assert_allclose(host(entry["x_start"]), 2.0)
    j_engine, _, _ = mirror_run(JAX)
    assert_rays_equal(engine.result.rays, j_engine.result.rays)


def test_trace_config_recommended_and_overrides(jax_arc_trace):
    """The facade starts from TraceConfig.recommended on the system's
    device (no kernel off the card, as the JAX facade's no Pallas off the
    TPU) and trace_overrides win; a float64 system keeps the plain
    searches where a float32 one takes the kernels."""
    system = build_single_arc_system(PORT)
    system.update()
    engine = engine_on(PORT, system, 2)
    cfg = engine.trace_config(6)
    want = engine_on(JAX, jax_arc_trace.optical_system, 2).trace_config(6)
    assert cfg.max_bounces == want.max_bounces == 6
    assert not cfg.use_kernel and not want.use_pallas
    assert not cfg.cull and not want.cull
    assert (cfg.remat, cfg.resort_rays) == (want.remat, want.resort_rays)

    engine2 = engine_on(PORT, system, 2, trace_overrides={
        "remat": True, "ray_block": 4096})
    cfg2 = engine2.trace_config(6)
    assert cfg2.remat and cfg2.ray_block == 4096
    engine2.ray_trace(2)
    assert engine2.finished_rays.n_rays == 60

    # the card's rules, read on CPU tensors: a float32 system takes the
    # kernels and the float32 start epsilon, a float64 one neither
    for dtype, kernels in ((torch.float32, True), (torch.float64, False)):
        sys_ = build_single_arc_system(
            types.SimpleNamespace(**{**vars(PORT), "f64": dtype}))
        sys_.update()
        sys_.device = torch.device("cuda")
        cfg = engine_on(PORT, sys_, 2).trace_config(50)
        assert cfg.use_kernel is kernels
        assert not cfg.cull and not cfg.resort_rays and cfg.remat
        assert (cfg.ray_start_epsilon is not None) is kernels


def test_facade_thin_film_class_op(jax_intensities):
    """ThinFilmIntensity through the facade validates like
    FresnelIntensity, traces, and the AR-coated arc delivers more power
    than the bare one; both equal the JAX facade's."""
    d = float(t_thinfilm.quarter_wave_thickness(1.38, 550.0))
    coated = intensity_run(PORT, t_ops.ThinFilmIntensity(
        [[(1.38, d)]], {"arcs": np.asarray([0])}))
    bare = intensity_run(PORT, t_ops.FresnelIntensity())
    c, b = host(coated["intensity"]), host(bare["intensity"])
    assert c.shape == b.shape
    assert (c > b).all() and (c < 1.0).all()
    assert_rays_equal(coated, jax_intensities["coated"],
                      fields=("intensity",))


def test_engine_jit_flag_changes_nothing(jax_arc_trace):
    """OpticalEngine(jit=...) is accepted for the JAX facade's signature
    and changes nothing: both flags trace bit for bit alike, and equal the
    JAX facade's trace."""
    system = build_single_arc_system(PORT)
    system.update()
    a = engine_on(PORT, system, 2, jit=True).ray_trace(2)
    b = engine_on(PORT, system, 2, jit=False).ray_trace(2)
    assert_rays_equal(a.rays, b.rays, atol=0.0)
    assert_rays_equal(a.rays, jax_arc_trace.result.rays)


def test_oldest_ancestor_through_the_facade():
    """operations.OldestAncestor.annotate tags the facade's source entries
    with their running index; the tags ride through the trace as in the
    JAX facade."""
    results = []
    for m in (JAX, PORT):
        system = build_single_arc_system(m)
        extra = m.src.AngularSource(
            2, (-1.0, 0.5), 0.0,
            m.dist.StaticUniformAngularDistribution(0.0, 0.0, 1),
            m.dist.StaticUniformBeam(-0.5, 0.5, 4), [575.0])
        system.sources = [system._source_entries[0]._obj, extra]
        engine = engine_on(m, system, 2, operations=[m.ops.OldestAncestor()])
        system.update()
        engine.annotate()
        engine.ray_trace(2)
        results.append(engine.result.rays)
    want, got = results
    np.testing.assert_array_equal(host(got["oldest_ancestor"]),
                                  np.arange(64))
    assert_rays_equal(got, want, fields=("oldest_ancestor",))
