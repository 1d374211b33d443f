"""The port's diffractive and lossy reactions against the JAX package's, on
the CPU in float64: gratings (transmission and reflection orders,
evanescent orders, efficiencies, 3D groove vectors), metasurfaces (the
hyperbolic metalens and a steep linear profile whose kick is evanescent),
bulk absorption and surface absorbers, and the compositions the JAX tests
compose (optical path over Fresnel over a grating, absorption over optical
path).  Reaction level within rtol 1e-12; a 2D metalens trace whose
gradient with respect to the focal length, a coefficient the phase profile
closes over, is within 1e-8 of JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu import operations as jop
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import (
    FINISHED, RaySet, Scene2D, SegmentSet, TraceConfig,
)
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch import operations as top
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.utils import convert
from torch_reactions_common import (  # noqa: F401 (on_cpu: a fixture)
    F64, assert_same, concat_cases, edge_case, on_cpu, random_case,
    run_both, torch_inputs, with_fields,
)

pytestmark = pytest.mark.usefixtures("on_cpu")


def cases(rng, dim, n=64):
    c = concat_cases(random_case(rng, n, dim), edge_case(dim))
    m = len(c["p0"])
    return with_fields(c, intensity=rng.uniform(0.5, 1.0, m),
                       opl=rng.uniform(0.0, 2.0, m),
                       cur_n=rng.choice([1.0, 1.5], m),
                       cur_alpha=rng.uniform(0.0, 0.3, m))


def tables_of(dim, ids):
    ids = np.asarray(ids)
    return ({"triangles": ids} if dim == 3 else
            {"segments": ids, "arcs": np.roll(ids, 1)})


def gratings(dim):
    """A coarse transmission grating, a reflection grating, and one so fine
    that its orders are evanescent."""
    specs = [(2000.0, 1, "transmission"), (900.0, -2, "reflection"),
             (150.0, 3, "transmission")]
    if dim == 3:
        grooves = ([1.0, 0.2, 0.0], [0.0, 1.0, 0.5], [0.3, -0.4, 1.0])
        specs = [s + (g,) for s, g in zip(specs, grooves)]
    return specs


@pytest.mark.parametrize("dim", [2, 3])
def test_grating_matches_jax(rng, dim):
    c = cases(rng, dim)
    ids = tables_of(dim, [0, 1, 2, -1])
    eff = [0.6, lambda m, wl, cos_i: 0.5 + 0.1 * m * cos_i + 0.0 * wl, None]
    specs = gratings(dim)
    t_specs = convert.gratings_from_numpy(specs, dtype=F64, device="cpu")
    t_ids = convert.surface_tables_from_numpy(ids, device="cpu")
    for e in (None, eff):
        j, t = run_both(c, jop.grating_reaction(specs, ids, efficiencies=e),
                        top.grating_reaction(t_specs, t_ids, efficiencies=e))
        assert_same(j, t)
    # the fine grating's orders are evanescent: those rays keep the Snell
    # child (the base reaction's)
    _, base = run_both(c, jop.standard_reaction, top.standard_reaction)
    j, t = run_both(c, jop.grating_reaction(specs, ids),
                    top.grating_reaction(t_specs, t_ids))
    evanescent = np.asarray(ids["triangles" if dim == 3 else "segments"])[
        np.clip(c["surf_idx"], 0, 3)] == 2
    if dim == 2:
        evanescent &= c["kind"] == 0
    assert evanescent.any()
    np.testing.assert_array_equal(t[1][evanescent], base[1][evanescent])
    # the composition of the JAX tests: OPL over Fresnel over a grating
    j, t = run_both(
        c, jop.optical_path_reaction(jop.fresnel_intensity_reaction(
            jop.grating_reaction(specs, ids, efficiencies=eff))),
        top.optical_path_reaction(top.fresnel_intensity_reaction(
            top.grating_reaction(t_specs, t_ids, efficiencies=eff))))
    assert_same(j, t)
    with pytest.raises(ValueError):
        top.grating_reaction([(1.0, 1, "sideways")], ids)(
            *torch_inputs(c), TraceConfig())


def phases(pkg, dim):
    """The hyperbolic metalens and a steep linear profile (reflection kind)
    whose kick is evanescent for most rays."""
    op = jop if pkg == "jax" else top
    lens = op.hyperbolic_metalens_phase(5.0, 550.0, axis=0,
                                        center=[0.1] * dim)
    return [(lens, "transmission"),
            (lambda p, wl: 0.02 * p[1] + 1e-4 * p[0] * p[0] * wl,
             "reflection"),
            (lambda p, wl: 0.004 * p[1] * p[1], "transmission")]


@pytest.mark.parametrize("dim", [2, 3])
def test_metasurface_matches_jax(rng, dim):
    c = cases(rng, dim)
    ids = tables_of(dim, [0, 1, 2, -1])
    t_ids = convert.surface_tables_from_numpy(ids, device="cpu")
    eff = [None, 0.7, lambda wl, cos_i: 0.9 - 0.1 * cos_i + 0.0 * wl]
    for e in (None, eff):
        j, t = run_both(
            c, jop.metasurface_reaction(phases("jax", dim), ids,
                                        efficiencies=e),
            top.metasurface_reaction(phases("torch", dim), t_ids,
                                     efficiencies=e))
        assert_same(j, t)
    # the imparted phase is optical path for a composed OPL tracker
    j, t = run_both(
        c, jop.optical_path_reaction(jop.metasurface_reaction(
            phases("jax", dim), ids)),
        top.optical_path_reaction(top.metasurface_reaction(
            phases("torch", dim), t_ids)))
    assert_same(j, t)


@pytest.mark.parametrize("dim", [2, 3])
def test_absorption_and_surface_absorber_match_jax(rng, dim):
    c = cases(rng, dim)
    a_in, a_out = rng.uniform(0, 0.5, 4), rng.uniform(0, 0.5, 4)
    alphas = ({"triangles": (a_in, a_out)} if dim == 3 else
              {"segments": (a_in, a_out), "arcs": (a_out, a_in)})
    t_alphas = convert.surface_tables_from_numpy(alphas, dtype=F64,
                                                 device="cpu")
    absorb = tables_of(dim, rng.uniform(0, 1, 4))
    t_absorb = convert.surface_tables_from_numpy(absorb, dtype=F64,
                                                 device="cpu")
    for jr, tr in (
            (jop.absorption_reaction(alphas),
             top.absorption_reaction(t_alphas)),
            (jop.absorption_reaction(alphas, jop.optical_path_reaction()),
             top.absorption_reaction(t_alphas, top.optical_path_reaction())),
            (jop.surface_absorber_reaction(absorb,
                                           jop.fresnel_intensity_reaction()),
             top.surface_absorber_reaction(t_absorb,
                                           top.fresnel_intensity_reaction())),
            (jop.absorption_reaction(alphas, jop.grating_reaction(
                gratings(dim), tables_of(dim, [1, -1, 0, 2]))),
             top.absorption_reaction(t_alphas, top.grating_reaction(
                 gratings(dim), tables_of(dim, [1, -1, 0, 2]))))):
        j, t = run_both(c, jr, tr)
        assert_same(j, t)
    p0 = rng.normal(size=(9, dim))
    jr = jop.seed_absorption(JRaySet.make(p0, p0 + 1.5, dtype=jnp.float64),
                             0.2)
    tr = top.seed_absorption(RaySet.make(p0, p0 + 1.5, dtype=F64,
                                         device="cpu"), 0.2)
    for k in ("cur_alpha", "intensity"):
        np.testing.assert_array_equal(tr.fields[k].numpy(),
                                      np.asarray(jr.fields[k]))
    np.testing.assert_allclose(top.final_intensity(tr).numpy(),
                               np.asarray(jop.final_intensity(jr)),
                               rtol=1e-13)


def test_metalens_focal_gradient_matches_jax():
    """128 collimated rays through a flat 2D metalens (a segment at x = 0)
    onto a screen at x = 4, 2 bounces: states and landings, and the
    gradient of the squared landing heights with respect to the focal
    length the phase closes over (and to the lens's end point) within 1e-8
    of its largest magnitude."""
    n = 128
    ys = np.linspace(-0.8, 0.8, n)
    p0 = np.stack([np.full(n, -1.0), ys], 1)

    def run(pkg, f, x1):
        op, S, Sc, mats_, kw = (
            (jop, JSegmentSet, JScene2D, j_mats, {"dtype": jnp.float64})
            if pkg == "jax" else
            (top, SegmentSet, Scene2D, t_mats, {"dtype": F64,
                                                "device": "cpu"}))
        stack = jnp.stack if pkg == "jax" else torch.stack
        lens_p0 = stack([x1 * 0.0, x1 * 0.0 - 1.0])[None]
        lens_p1 = stack([x1, x1 * 0.0 + 1.0])[None]
        lens = S.make(lens_p0, lens_p1, **kw)
        screen = S.make([[4.0, -3.0]], [[4.0, 3.0]], **kw)
        scene = Sc.build(optical_segments=[lens], target_segments=[screen])
        phase = op.hyperbolic_metalens_phase(f, 550.0, axis=0)
        rx = op.metasurface_reaction([(phase, "transmission")],
                                     {"segments": np.asarray([0, -1])})
        R, trace, cfg = ((JRaySet, j_engine.trace, JTraceConfig)
                         if pkg == "jax" else
                         (RaySet, t_engine.trace, TraceConfig))
        rays = R.make(p0, p0 + [1.0, 0.0], 550.0, **kw)
        res = trace(rays, scene, (mats_.vacuum,), cfg(max_bounces=2),
                    reaction=rx)
        fin = res.rays.state == (J_FINISHED if pkg == "jax" else FINISHED)
        where = jnp.where if pkg == "jax" else torch.where
        return where(fin, res.rays.p1[:, 1] ** 2, 0.0).sum(), res.rays

    (jl, jrays), jg = jax.jit(jax.value_and_grad(
        lambda f, x1: run("jax", f, x1), argnums=(0, 1), has_aux=True))(
        jnp.float64(3.0), jnp.float64(0.05))
    f = torch.tensor(3.0, dtype=F64, requires_grad=True)
    x1 = torch.tensor(0.05, dtype=F64, requires_grad=True)
    tl, trays = run("torch", f, x1)
    tl.backward()
    np.testing.assert_array_equal(trays.state.numpy(),
                                  np.asarray(jrays.state))
    assert int((trays.state == FINISHED).sum()) == n
    np.testing.assert_allclose(trays.p1.detach().numpy(),
                               np.asarray(jrays.p1), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-10)
    for got, want in ((f.grad, jg[0]), (x1.grad, jg[1])):
        want = float(want)
        assert want != 0.0 and math.isfinite(float(got))
        assert abs(float(got) - want) <= 1e-8 * abs(want)
