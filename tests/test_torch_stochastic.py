"""The port's branching and stochastic reactions against the JAX package's,
on the CPU in float64: the branch override, rough surfaces and Russian
roulette, and the port's own counter-based stream.

The rough and roulette comparisons replace the port's ``ray_uniform`` and
``ray_normal`` with JAX's own draws, ``fold_in(key, slot + ctr *
0x9E3779B9)`` a ray (``torch_reactions_common.jax_draws``), so that
whole traces match JAX ray for ray: reaction level within rtol 1e-12;
traces of a few hundred rays with states equal, fields within rtol 1e-10
and the gradient with respect to the roughness within 1e-8 of its largest
magnitude.  Separate tests hold the port's stream: the same key repeats
its draws, another counter or key changes them, the uniforms lie in
(0, 1), and the normals have mean ~0 and variance ~1 at 2^16 draws.
``scenes2d.stray_light`` at the CI size of tests/test_examples.py keeps
the example's assertions on the port's stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene3D as JScene3D
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import TriangleSet as JTriangleSet
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu import operations as jop
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import RaySet, Scene3D, TraceConfig
from tensorflowraytrace_tpu_torch import TriangleSet
from tensorflowraytrace_tpu_torch import engine as t_engine
from tensorflowraytrace_tpu_torch import operations as top
from tensorflowraytrace_tpu_torch import scenes2d, scenes3d
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.utils import convert
from torch_reactions_common import (  # noqa: F401 (on_cpu: a fixture)
    F64, assert_same, concat_cases, edge_case, jax_draws, jax_key, on_cpu,
    random_case, run_both, with_fields,
)

pytestmark = pytest.mark.usefixtures("on_cpu")
KEY = convert.seed_from_jax_key(np.asarray(jax.random.PRNGKey(11)))


def cases(rng, dim, n=64):
    c = concat_cases(random_case(rng, n, dim), edge_case(dim))
    m = len(c["p0"])
    ctr = rng.integers(0, 5, m).astype(np.int32)
    return with_fields(c, intensity=rng.uniform(0.5, 1.0, m),
                       scatter_ctr=ctr, rr_ctr=ctr[::-1].copy(),
                       branch_ctr=ctr)


def tables_of(dim, ids):
    ids = np.asarray(ids)
    return ({"triangles": ids} if dim == 3 else
            {"segments": ids, "arcs": np.roll(ids, 1)})


# ----------------------------------------------------------------------
# the port's stream
# ----------------------------------------------------------------------

def test_stream_repeats_and_resamples():
    ctr = torch.zeros(1 << 16, dtype=torch.int32)
    mix = top.ray_mix(ctr)
    # the JAX package's mix, in uint32 arithmetic
    want = (np.arange(1 << 16, dtype=np.uint64) + 3 * 0x9E3779B9) % (1 << 32)
    np.testing.assert_array_equal(top.ray_mix(ctr + 3).numpy(), want)
    for dtype in (torch.float32, F64):
        u = top.ray_uniform(KEY, mix, dtype)
        assert u.dtype == dtype
        assert float(u.min()) > 0.0 and float(u.max()) < 1.0
        assert torch.equal(u, top.ray_uniform(KEY, mix, dtype))
        assert abs(float(u.double().mean()) - 0.5) < 0.01
        other = top.ray_uniform(KEY, top.ray_mix(ctr + 1), dtype)
        assert float((u == other).double().mean()) < 1e-3
        assert float((u == top.ray_uniform(KEY + 1, mix, dtype)
                      ).double().mean()) < 1e-3
        for dim in (2, 3):
            g = top.ray_normal(KEY, mix, dim, dtype)
            assert g.shape == (1 << 16, dim) and g.dtype == dtype
            assert bool(torch.isfinite(g).all())
            assert torch.equal(g, top.ray_normal(KEY, mix, dim, dtype))
            mean, var = g.double().mean(0), g.double().var(0)
            assert float(mean.abs().max()) < 0.02
            assert float((var - 1).abs().max()) < 0.03
    # float32 uniforms are the 24-bit grid; a zero draw stays inside (0, 1)
    u32 = top.ray_uniform(KEY, mix, torch.float32).double() * 2 ** 24
    assert torch.equal(u32, torch.floor(u32))
    assert convert.seed_from_jax_key(np.array([1, 2], np.uint32)) == \
        (1 << 32) | 2


# ----------------------------------------------------------------------
# branch override, rough surfaces, roulette: reaction level
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_branch_override_matches_jax(rng, dim):
    c = cases(rng, dim)
    sched = [1, -1, 0, 1, 0]   # every code, and past the end physics
    for jb, tb in ((jop.standard_reaction, top.standard_reaction),
                   (jop.fresnel_intensity_reaction(),
                    top.fresnel_intensity_reaction())):
        j, t = run_both(c, jop.branch_override_reaction(sched, jb),
                        top.branch_override_reaction(sched, tb))
        assert_same(j, t)
    assert top.seed_branch_counter(
        RaySet.make(c["p0"], c["point"], dtype=F64, device="cpu")
    ).fields["branch_ctr"].dtype == torch.int32


@pytest.mark.parametrize("dim", [2, 3])
def test_rough_and_roulette_match_jax_under_its_draws(rng, dim,
                                                      monkeypatch):
    jax_draws(monkeypatch, top)
    c = cases(rng, dim)
    jkey = jax_key(KEY)
    rough = tables_of(dim, [0, -1, 1, 0])
    sigmas = [0.05, 0.4]
    j, t = run_both(c, jop.rough_surface_reaction(sigmas, rough, jkey),
                    top.rough_surface_reaction(sigmas, rough, KEY))
    assert_same(j, t)
    # an index-matched interface's R is 0 or ~1e-32 by the last bit of the
    # ray's unit direction, which the defensive floor turns into p = 0 or
    # p = floor; the floored case has no such interface
    matched = c["n_in"] == c["n_out"]
    c_floor = dict(c, n_out=np.where(matched, 1.7, c["n_out"]))
    for ids, floor, cc in ((None, 0.0, c),
                           (tables_of(dim, [0, 0, -1, 0]), 0.2, c_floor)):
        j, t = run_both(
            cc, jop.fresnel_intensity_reaction(jop.russian_roulette_reaction(
                jkey, roulette_ids=ids, defensive_floor=floor)),
            top.fresnel_intensity_reaction(top.russian_roulette_reaction(
                KEY, roulette_ids=ids, defensive_floor=floor)))
        assert_same(j, t)
    # roughness under the absorber, as the stray-light example composes
    absorb = tables_of(dim, [0.9, 0.5, 0.0, 0.2])
    j, t = run_both(
        c, jop.surface_absorber_reaction(absorb, jop.rough_surface_reaction(
            sigmas, rough, jkey)),
        top.surface_absorber_reaction(absorb, top.rough_surface_reaction(
            sigmas, rough, KEY)))
    assert_same(j, t)


# ----------------------------------------------------------------------
# traces under JAX's draws
# ----------------------------------------------------------------------

def test_stray_light_rough_trace_matches_jax_under_its_draws(monkeypatch):
    """400 rays of the stray-light barrel, 12 bounces, rough absorbing
    walls: states, landings, intensities and counters equal JAX's, and the
    gradient of the landed power with respect to the wall roughness."""
    jax_draws(monkeypatch, top)
    n = 400
    p0, p1 = scenes2d.stray_light_rays_np(n)
    ex = _example("stray_light")
    j_scene, j_mats_ = ex.build_scene(jnp.float64)
    jkey = jax_key(KEY)

    def j_run(sigma):
        r0 = jop.seed_scatter(JRaySet.make(p0, p1, 550.0, dtype=jnp.float64))
        r0 = r0.with_field("intensity", jnp.ones(n))
        rx = jop.surface_absorber_reaction(
            {"segments": jnp.asarray([0.5, 0.5, 0.0])},
            jop.rough_surface_reaction([sigma], {"segments": jnp.asarray(
                [0, 0, -1])}, jkey))
        res = j_engine.trace(r0, j_scene, j_mats_,
                             JTraceConfig(max_bounces=12), reaction=rx)
        fin = res.rays.state == 1
        return jnp.sum(jnp.where(fin, res.rays.fields["intensity"]
                                 * res.rays.p1[:, 1] ** 2, 0.0)), res.rays

    (jl, jrays), jg = jax.jit(jax.value_and_grad(j_run, has_aux=True))(
        jnp.float64(0.2))
    scene, mats_ = scenes2d.stray_light_scene(F64, "cpu")
    rays = scenes2d.stray_light_rays(n, F64, "cpu")
    sigma = torch.tensor(0.2, dtype=F64, requires_grad=True)
    rx = top.surface_absorber_reaction(
        {"segments": torch.tensor([0.5, 0.5, 0.0], dtype=F64)},
        top.rough_surface_reaction([sigma], {"segments": torch.tensor(
            [0, 0, -1])}, KEY))
    res = t_engine.trace(rays, scene, mats_, TraceConfig(max_bounces=12),
                         reaction=rx)
    fin = res.rays.state == 1
    loss = torch.sum(torch.where(fin, res.rays.fields["intensity"]
                                 * res.rays.p1[:, 1] ** 2, 0.0))
    loss.backward()
    np.testing.assert_array_equal(res.rays.state.numpy(),
                                  np.asarray(jrays.state))
    np.testing.assert_array_equal(res.rays.fields["scatter_ctr"].numpy(),
                                  np.asarray(jrays.fields["scatter_ctr"]))
    assert int(res.rays.fields["scatter_ctr"].max()) > 3
    np.testing.assert_allclose(res.rays.p1.detach().numpy(),
                               np.asarray(jrays.p1), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(res.rays.fields["intensity"].detach().numpy(),
                               np.asarray(jrays.fields["intensity"]),
                               rtol=1e-10)
    assert float(jg) != 0.0
    assert abs(float(sigma.grad) - float(jg)) <= 1e-8 * abs(float(jg))


def test_roulette_caustic_trace_matches_jax_under_its_draws(monkeypatch):
    """512 sun rays onto the caustic's water surface cut to 96 triangles,
    3 bounces, Russian roulette under the Fresnel tracker with a
    defensive floor: states, landings and weights equal JAX's."""
    jax_draws(monkeypatch, top)
    n = 512
    rng = np.random.default_rng(3)
    xy = rng.uniform(-3.0, 3.0, (n, 2))
    p0 = np.concatenate([xy, np.ones((n, 1))], 1)
    p1 = np.concatenate([xy + rng.normal(0, 0.3, (n, 2)), np.zeros((n, 1))],
                        1)
    surf = scenes3d.water_surface(4, 0.3, F64, "cpu")
    vp, v1, v2 = (x.numpy() for x in (surf.vp, surf.v1, surf.v2))
    floor = [np.asarray(a) for a in (
        [[-6.0, -6.0, -3.0], [6.0, 6.0, -3.0]],
        [[6.0, -6.0, -3.0], [-6.0, 6.0, -3.0]],
        [[6.0, 6.0, -3.0], [-6.0, -6.0, -3.0]])]
    j_scene = JScene3D.build(optical=[JTriangleSet.make(
        vp, v1, v2, mat_in=1, mat_out=0, dtype=jnp.float64)],
        targets=[JTriangleSet.make(*floor, dtype=jnp.float64)])
    t_scene = Scene3D.build(optical=[surf], targets=[TriangleSet.make(
        *floor, dtype=F64, device="cpu")])
    jr = jop.seed_roulette(JRaySet.make(p0, p1, 550.0, dtype=jnp.float64)
                           ).with_field("intensity", jnp.ones(n))
    tr = top.seed_roulette(RaySet.make(p0, p1, 550.0, dtype=F64,
                                       device="cpu")).with_field(
        "intensity", torch.ones(n, dtype=F64))
    jres = jax.jit(lambda r: j_engine.trace(
        r, j_scene, (j_mats.vacuum, j_mats.build_constant_material(4 / 3)),
        JTraceConfig(max_bounces=3),
        reaction=jop.fresnel_intensity_reaction(jop.russian_roulette_reaction(
            jax_key(KEY), defensive_floor=0.1))))(jr)
    tres = t_engine.trace(
        tr, t_scene, (t_mats.vacuum, t_mats.build_constant_material(4 / 3)),
        TraceConfig(max_bounces=3),
        reaction=top.fresnel_intensity_reaction(top.russian_roulette_reaction(
            KEY, defensive_floor=0.1)))
    np.testing.assert_array_equal(tres.rays.state.numpy(),
                                  np.asarray(jres.rays.state))
    np.testing.assert_array_equal(tres.rays.fields["rr_ctr"].numpy(),
                                  np.asarray(jres.rays.fields["rr_ctr"]))
    np.testing.assert_allclose(tres.rays.p1.numpy(), np.asarray(jres.rays.p1),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tres.rays.fields["intensity"].numpy(),
                               np.asarray(jres.rays.fields["intensity"]),
                               rtol=1e-10)
    # some rays were sent up by the draw, and weighted up for it
    assert float(tres.rays.fields["intensity"].max()) > 1.0


def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stray_light_example_holds_on_the_port_stream():
    """``scenes2d.stray_light`` at the example's CI size (1200 rays), 6
    (sigma, absorptivity) pairs x 4 keys on the port's own stream: the
    example's three assertions hold (the function raises otherwise)."""
    results = scenes2d.stray_light(1200, dtype=F64, device="cpu",
                                   verbose=False)
    assert sorted(results) == sorted(
        (s, a) for s in scenes2d.STRAY_SIGMAS
        for a in scenes2d.STRAY_ABSORPTIVITIES)
    assert results[(0.2, 0.0)] > 0.0
