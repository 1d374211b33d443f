"""The port's reaction core against the JAX package's, on the CPU in
float64: ``ops/geometry``'s ``snells_law_3D`` and ``transverse_basis``,
``operations``' standard and pass-through reactions, the ancestry tag, the
class API, the Fresnel intensity, Jones polarization and optical-path
trackers and their compositions.

Reaction level: both packages' reactions on one projection made from the
same numpy arrays (random rays and surfaces, and the edges: grazing
``nu == 0``, TIR, exactly critical incidence, the mirror sentinel seen from
either side in 2D and 3D), children and updates within rtol 1e-12.  Trace
level: a few hundred rays through a 3D water surface and a 2D lens, at most
4 bounces: states equal, fields within rtol 1e-10, gradients within 1e-8 of
their largest magnitude.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu import operations as jop
from tensorflowraytrace_tpu.models.surfaces import ArcSet as JArcSet
from tensorflowraytrace_tpu.ops import geometry as j_geo
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import (
    RaySet, Scene2D, Scene3D, SegmentSet, TraceConfig, TriangleSet,
)
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch import operations as top
from tensorflowraytrace_tpu_torch.models.surfaces import ArcSet
from tensorflowraytrace_tpu_torch.ops import geometry as t_geo
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from torch_reactions_common import (  # noqa: F401 (on_cpu: a fixture)
    F64, assert_same, concat_cases, edge_case, jax_inputs, on_cpu,
    random_case, run_both, torch_inputs, with_fields,
)

pytestmark = pytest.mark.usefixtures("on_cpu")


def cases(rng, dim, n=64):
    return concat_cases(random_case(rng, n, dim), edge_case(dim))


# ----------------------------------------------------------------------
# ops/geometry
# ----------------------------------------------------------------------

def test_snells_law_3D_and_transverse_basis_match_jax(rng):
    c = cases(rng, 3)
    p0, p1 = c["p0"], c["point"]
    j = j_geo.snells_law_3D(*[jnp.asarray(p0[:, i]) for i in range(3)],
                            *[jnp.asarray(p1[:, i]) for i in range(3)],
                            jnp.asarray(c["norm"]), jnp.asarray(c["n_in"]),
                            jnp.asarray(c["n_out"]), 1.0)
    t = t_geo.snells_law_3D(*[torch.as_tensor(p0[:, i]) for i in range(3)],
                            *[torch.as_tensor(p1[:, i]) for i in range(3)],
                            torch.as_tensor(c["norm"]),
                            torch.as_tensor(c["n_in"]),
                            torch.as_tensor(c["n_out"]), 1.0)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-13)
    # ties between the least-aligned axes take the first, as JAX's argmin
    u = np.concatenate([unit_rows(rng.normal(size=(50, 3))),
                        [[1.0, 0, 0], [0, 0, 1.0], [0.6, 0.8, 0.0]]])
    jt = j_geo.transverse_basis(jnp.asarray(u))
    tt = t_geo.transverse_basis(torch.as_tensor(u))
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-15)


def unit_rows(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# ----------------------------------------------------------------------
# core: standard, ghost_through, ancestry, class API, protocol errors
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_standard_and_ghost_through_match_jax(rng, dim):
    c = cases(rng, dim)
    for jr, tr in ((jop.standard_reaction, top.standard_reaction),
                   (jop.ghost_through, top.ghost_through)):
        j, t = run_both(c, jr, tr)
        assert_same(j, t)


def test_oldest_ancestor_and_class_api(rng):
    p0 = rng.normal(size=(5, 3))
    jr = jop.annotate_oldest_ancestor(JRaySet.make(p0, p0 + 1.0), 7)
    tr = top.annotate_oldest_ancestor(RaySet.make(p0, p0 + 1.0, device="cpu"),
                                      7)
    assert tr.fields["oldest_ancestor"].dtype == torch.int32
    np.testing.assert_array_equal(tr.fields["oldest_ancestor"].numpy(),
                                  np.asarray(jr.fields["oldest_ancestor"]))
    names = ["RayOperation", "StandardReaction", "GhostThrough",
             "FresnelIntensity", "JonesPolarization", "OpticalPath",
             "OldestAncestor", "ThinFilmIntensity", "ThinFilmJones",
             "Grating", "Absorption", "Metasurface", "RoughSurface",
             "SurfaceAbsorber", "BranchOverride", "RussianRoulette"]
    args = {"ThinFilmIntensity": ([], {}), "ThinFilmJones": ([], {}),
            "Grating": ([], {}), "Absorption": ({},), "Metasurface": ([], {}),
            "RoughSurface": ([], {}, 0), "SurfaceAbsorber": ({},),
            "BranchOverride": ([0],), "RussianRoulette": (0,)}
    sigs = ("input_signature", "output_signature", "optical_signature",
            "stop_signature", "target_signature", "material_signature",
            "simple_ray_inheritance", "exclusions")
    for name in names:
        a = args.get(name, ())
        jo = getattr(jop, name)(*a)
        to = getattr(top, name)(*a)
        for s in sigs:
            assert getattr(to, s) == getattr(jo, s), (name, s)
        assert to.active is True
    for mode in ("index", "value"):
        jo, to = jop.StandardReaction(mode), top.StandardReaction(mode)
        for s in sigs:
            assert getattr(to, s) == getattr(jo, s)
    with pytest.raises(ValueError):
        top.StandardReaction("bogus")


def test_composition_errors(rng):
    c = with_fields(cases(rng, 3), intensity=np.ones(71))
    tp, tr = torch_inputs(c)
    cfg = TraceConfig()
    # two trackers of one field clash ...
    twice = top.optical_path_reaction(top.optical_path_reaction())
    tr2 = top.seed_optical_path(tr)
    with pytest.raises(ValueError, match="both update field"):
        twice(tp, tr2, cfg)
    # ... while intensity trackers chain multiplicatively
    chained = top.fresnel_intensity_reaction(top.fresnel_intensity_reaction())
    jchained = jop.fresnel_intensity_reaction(jop.fresnel_intensity_reaction())
    j, t = run_both(c, jchained, chained)
    assert_same(j, t)
    # a missing seed fails loudly
    bare = torch_inputs(cases(rng, 3))
    for reaction in (top.fresnel_intensity_reaction(),
                     top.jones_polarization_reaction(),
                     top.optical_path_reaction()):
        with pytest.raises(KeyError):
            reaction(*bare, cfg)


# ----------------------------------------------------------------------
# Fresnel intensity
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_fresnel_intensity_matches_jax(rng, dim):
    c = cases(rng, dim)
    c = with_fields(c, intensity=rng.uniform(0.5, 1.0, len(c["p0"])))
    j, t = run_both(c, jop.fresnel_intensity_reaction(),
                    top.fresnel_intensity_reaction())
    assert_same(j, t)
    # TIR and mirrors keep their power; grazing refraction transmits none
    e = edge_case(dim)
    j, t = run_both(with_fields(e, intensity=np.ones(7)),
                    jop.fresnel_intensity_reaction(),
                    top.fresnel_intensity_reaction())
    assert_same(j, t)
    assert t[2]["intensity"][3] == 1.0 and t[2]["intensity"][4] == 1.0


@pytest.mark.parametrize("dim", [2, 3])
def test_nan_indices_keep_the_gradient_finite(rng, dim):
    """NaN indices on slots that do not react (the engine masks them):
    the masked field's gradient stays finite, and equals JAX's."""
    c = cases(rng, dim)
    n = len(c["p0"])
    bad = rng.random(n) < 0.3
    c["n_in"] = np.where(bad, np.nan, c["n_in"])
    c = with_fields(c, intensity=np.ones(n), opl=np.zeros(n),
                    cur_n=np.ones(n))
    keep = ~bad

    def j_loss(p0, norm):
        jp, jr = jax_inputs(c)
        jp = dataclasses.replace(jp, norm=norm)
        jr = dataclasses.replace(jr, p0=p0)
        rx = jop.optical_path_reaction(jop.fresnel_intensity_reaction())
        _, _, upd = rx(jp, jr, JTraceConfig())
        return jnp.sum(jnp.where(jnp.asarray(keep),
                                 upd["intensity"] * upd["opl"], 0.0))

    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(c["p0"]),
                                          jnp.asarray(c["norm"]))
    tp, tr = torch_inputs(c, requires_grad=("p0", "norm"))
    rx = top.optical_path_reaction(top.fresnel_intensity_reaction())
    _, _, upd = rx(tp, tr, TraceConfig())
    loss = torch.sum(torch.where(torch.as_tensor(keep),
                                 upd["intensity"] * upd["opl"], 0.0))
    tg = torch.autograd.grad(loss, (tr.p0, tp.norm))
    for a, b in zip(tg, jg):
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


# ----------------------------------------------------------------------
# Jones polarization
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_jones_polarization_matches_jax(rng, dim):
    c = cases(rng, dim)
    n = len(c["p0"])
    jones = (rng.normal(size=n) + 1j * rng.normal(size=n),
             rng.normal(size=n) + 1j * rng.normal(size=n))
    _, jr = jax_inputs(c)
    _, tr = torch_inputs(c)
    js = jop.seed_polarization(jr, jones)
    ts = top.seed_polarization(tr, jones)
    for k in ts.fields:
        np.testing.assert_allclose(ts.fields[k].numpy(),
                                   np.asarray(js.fields[k]), rtol=1e-12,
                                   atol=1e-15, err_msg=k)
    c = with_fields(c, **{k: ts.fields[k].numpy() for k in ts.fields})
    j, t = run_both(c, jop.jones_polarization_reaction(),
                    top.jones_polarization_reaction())
    assert_same(j, t)
    # Stokes parameters of the transported rays, and a seeded s axis
    jout = dataclasses.replace(js, fields={**js.fields, **{
        k: jnp.asarray(v) for k, v in j[2].items()}})
    tout = dataclasses.replace(ts, fields={**ts.fields, **{
        k: torch.as_tensor(v) for k, v in t[2].items()}})
    js_ = jop.stokes_parameters(jout)
    ts_ = top.stokes_parameters(tout)
    for k in js_:
        np.testing.assert_allclose(ts_[k].numpy(), np.asarray(js_[k]),
                                   rtol=1e-11, atol=1e-12)
    if dim == 3:
        ja = jop.seed_polarization(jr, (1.0, 1j), s_axis=(0.0, 1.0, 0.0))
        ta = top.seed_polarization(tr, (1.0, 1j), s_axis=(0.0, 1.0, 0.0))
        for k in ta.fields:
            np.testing.assert_allclose(ta.fields[k].numpy(),
                                       np.asarray(ja.fields[k]), rtol=1e-12,
                                       atol=1e-15)


# ----------------------------------------------------------------------
# optical path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_optical_path_over_fresnel_matches_jax(rng, dim):
    c = cases(rng, dim)
    n = len(c["p0"])
    n0 = rng.uniform(1.0, 1.5, n)
    _, jr = jax_inputs(c)
    _, tr = torch_inputs(c)
    js, ts = jop.seed_optical_path(jr, n0), top.seed_optical_path(tr, n0)
    for k in ("opl", "cur_n"):
        np.testing.assert_array_equal(ts.fields[k].numpy(),
                                      np.asarray(js.fields[k]))
    c = with_fields(c, opl=rng.uniform(0, 3, n), cur_n=n0,
                    intensity=np.ones(n))
    j, t = run_both(c, jop.optical_path_reaction(
        jop.fresnel_intensity_reaction()),
        top.optical_path_reaction(top.fresnel_intensity_reaction()))
    assert_same(j, t)
    _, jr = jax_inputs(c)
    _, tr = torch_inputs(c)
    np.testing.assert_allclose(top.total_optical_path(tr).numpy(),
                               np.asarray(jop.total_optical_path(jr)),
                               rtol=1e-12)


# ----------------------------------------------------------------------
# traces
# ----------------------------------------------------------------------

def water_np(steps=4, amp=0.08):
    """A small wavy surface (the caustic's, cut to ``steps`` rings) and the
    floor as numpy triangles."""
    from tensorflowraytrace_tpu_torch.models import mesh as mt

    m = mt.hexagonal_mesh(1.5, steps)
    x, y = m.points[:, 0], m.points[:, 1]
    z = amp * np.sin(2.6 * x + 0.8 * y + 0.3) + 0.06 * np.sin(4.3 * x)
    pts = np.stack([x, y, z], 1)
    f = m.faces
    return pts[f[:, 0]], pts[f[:, 1]], pts[f[:, 2]]


FLOOR = ([[-3.0, -3.0, -2.0], [3.0, 3.0, -2.0]],
         [[3.0, -3.0, -2.0], [-3.0, 3.0, -2.0]],
         [[3.0, 3.0, -2.0], [-3.0, -3.0, -2.0]])


def test_fresnel_opl_trace_3d_matches_jax(rng):
    """300 tilted rays through the wavy surface onto the floor, 2 bounces,
    Fresnel intensity under the optical path: states equal, fields within
    rtol 1e-10, and the gradient of the landed intensity-weighted optical
    path with respect to the surface heights within 1e-8 of its largest
    magnitude."""
    vp, v1, v2 = water_np()
    n = 300
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    p0 = np.concatenate([xy, np.full((n, 1), 1.0)], 1)
    d = unit_rows(np.concatenate([rng.normal(0, 0.4, (n, 2)),
                                  -np.ones((n, 1))], 1))
    mats_j = (j_mats.vacuum, j_mats.build_constant_material(4 / 3))
    mats_t = (t_mats.vacuum, t_mats.build_constant_material(4 / 3))
    bounces = 2

    def j_run(dz):
        surf = JTriangleSet.make(vp + dz[:, None] * jnp.asarray([0, 0, 1.0]),
                                 v1, v2, mat_in=1, mat_out=0,
                                 dtype=jnp.float64)
        scene = JScene3D.build(optical=[surf],
                               targets=[JTriangleSet.make(*FLOOR,
                                                          dtype=jnp.float64)])
        rays = jop.seed_optical_path(JRaySet.make(
            p0, p0 + d, 550.0, dtype=jnp.float64).with_field(
            "intensity", jnp.ones(n)))
        res = j_engine.trace(rays, scene, mats_j,
                             JTraceConfig(max_bounces=bounces),
                             reaction=jop.optical_path_reaction(
                                 jop.fresnel_intensity_reaction()))
        fin = res.rays.state == 1
        loss = jnp.sum(jnp.where(fin, res.rays.fields["intensity"]
                                 * jop.total_optical_path(res.rays), 0.0))
        return loss, res.rays

    dz0 = np.zeros(len(vp))
    (jl, jrays), jg = jax.jit(jax.value_and_grad(j_run, has_aux=True))(
        jnp.asarray(dz0))

    dz = torch.zeros(len(vp), dtype=F64, requires_grad=True)
    surf = TriangleSet.make(torch.as_tensor(vp) + dz[:, None]
                            * torch.tensor([0, 0, 1.0], dtype=F64), v1, v2,
                            mat_in=1, mat_out=0, dtype=F64, device="cpu")
    scene = Scene3D.build(optical=[surf], targets=[TriangleSet.make(
        *FLOOR, dtype=F64, device="cpu")])
    rays = top.seed_optical_path(RaySet.make(
        p0, p0 + d, 550.0, dtype=F64, device="cpu").with_field(
        "intensity", torch.ones(n, dtype=F64)))
    res = t_engine.trace(rays, scene, mats_t, TraceConfig(max_bounces=bounces),
                         reaction=top.optical_path_reaction(
                             top.fresnel_intensity_reaction()))
    fin = res.rays.state == 1
    loss = torch.sum(torch.where(fin, res.rays.fields["intensity"]
                                 * top.total_optical_path(res.rays), 0.0))
    tg = torch.autograd.grad(loss, dz)[0].numpy()

    np.testing.assert_array_equal(res.rays.state.numpy(),
                                  np.asarray(jrays.state))
    assert int(fin.sum()) > n // 2
    for k in ("intensity", "opl", "cur_n"):
        np.testing.assert_allclose(res.rays.fields[k].detach().numpy(),
                                   np.asarray(jrays.fields[k]), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-10)
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    assert np.abs(tg - jg).max() <= 1e-8 * np.abs(jg).max()


def test_jones_trace_2d_matches_jax():
    """A 2D biconvex lens (arcs) in a mirror-walled barrel, 256 rays, 4
    bounces under Jones polarization: states, amplitudes and landings."""
    r, th = 4.0, math.asin(0.95 / 4.0)
    n = 256
    ys = np.linspace(-0.9, 0.9, n)
    p0 = np.stack([np.full(n, -0.5), ys], 1)
    d = np.stack([np.cos(0.3 * ys), np.sin(0.3 * ys)], 1)
    jones = (np.cos(ys) + 0j, 1j * np.sin(ys))

    def scene(pkg):
        A, S, Sc = ((JArcSet, JSegmentSet, JScene2D) if pkg == "jax" else
                    (ArcSet, SegmentSet, Scene2D))
        kw = {"dtype": jnp.float64} if pkg == "jax" else {"dtype": F64,
                                                          "device": "cpu"}
        front = A.make([[1.0 + r, 0.0]], [math.pi - th], [math.pi + th], [r],
                       mat_in=1, mat_out=0, **kw)
        back = A.make([[1.4 - r, 0.0]], [-th], [th], [r], mat_in=1,
                      mat_out=0, **kw)
        walls = S.make([[7.5, 1.0], [0.0, -1.0]], [[0.0, 1.0], [7.5, -1.0]],
                       mat_in=2, mat_out=0, **kw)
        det = S.make([[8.0, -3.0]], [[8.0, 3.0]], **kw)
        return Sc.build(optical_arcs=[front, back], optical_segments=[walls],
                        target_segments=[det])

    jr = jop.seed_polarization(JRaySet.make(p0, p0 + d, 550.0,
                                            dtype=jnp.float64), jones)
    jres = j_engine.trace(jr, scene("jax"), (j_mats.vacuum,
                                             j_mats.build_constant_material(
                                                 1.5), j_mats.reflective),
                          JTraceConfig(max_bounces=4),
                          reaction=jop.jones_polarization_reaction())
    tr = top.seed_polarization(RaySet.make(p0, p0 + d, 550.0, dtype=F64,
                                           device="cpu"), jones)
    tres = t_engine.trace(tr, scene("torch"), (t_mats.vacuum,
                                               t_mats.build_constant_material(
                                                   1.5), t_mats.reflective),
                          TraceConfig(max_bounces=4),
                          reaction=top.jones_polarization_reaction())
    np.testing.assert_array_equal(tres.rays.state.numpy(),
                                  np.asarray(jres.rays.state))
    np.testing.assert_allclose(tres.rays.p1.numpy(), np.asarray(jres.rays.p1),
                               rtol=1e-10, atol=1e-12)
    for k in top.POL_FIELDS_2D:
        np.testing.assert_allclose(tres.rays.fields[k].numpy(),
                                   np.asarray(jres.rays.fields[k]),
                                   rtol=1e-10, atol=1e-12)
