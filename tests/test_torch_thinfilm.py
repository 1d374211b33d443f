"""The port's thin films and aspheres against the JAX package's, on the
CPU in float64: ``ops/thinfilm`` (layer cosines, stack amplitudes with
TIR, padding and perfect-conductor substrates, their gradients at critical
incidence), ``ops/asphere`` (sag and its derivative), the thin-film
intensity and Jones reactions (reaction level, rtol 1e-12; over the branch
override, as the ghost analysis composes them), and ``scenes2d``'s
``ghost_analysis`` at the CI size of tests/test_examples.py (101 rays,
depth 4) against the JAX example's vmapped trace, path by path.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import engine as j_engine
from tensorflowraytrace_tpu import operations as jop
from tensorflowraytrace_tpu.ops import asphere as j_asphere
from tensorflowraytrace_tpu.ops import thinfilm as j_tf
from tensorflowraytrace_tpu_torch import TraceConfig, scenes2d
from tensorflowraytrace_tpu_torch import operations as top
from tensorflowraytrace_tpu_torch.ops import asphere as t_asphere
from tensorflowraytrace_tpu_torch.ops import thinfilm as t_tf
from tensorflowraytrace_tpu_torch.utils import convert
from torch_reactions_common import (  # noqa: F401 (on_cpu: a fixture)
    F64, assert_same, concat_cases, edge_case, on_cpu, random_case,
    run_both, torch_inputs, with_fields,
)

pytestmark = pytest.mark.usefixtures("on_cpu")
ROOT = Path(__file__).resolve().parents[1]


def np_out(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stack_inputs(rng, n=40, layers=3):
    """Incidence cosines from normal through critical (n0 = 1.6 onto 1.0
    substrates) to grazing, dispersive per-ray layers, a ragged valid
    prefix, and mirror substrates."""
    n0 = np.where(rng.random(n) < 0.5, 1.0, 1.6)
    n_sub = rng.choice([1.0, 1.52, 0.0], n)
    cos0 = np.concatenate([[1.0, math.sqrt(1 - 1 / 1.6 ** 2), 1e-3],
                           rng.uniform(0.05, 1.0, n - 3)])
    n0[1], n_sub[1] = 1.6, 1.0                  # exactly critical
    wl = rng.uniform(450, 650, n)
    ln = rng.uniform(1.3, 2.4, (layers, n))
    ld = rng.uniform(50, 200, (layers, n))
    valid = np.arange(layers)[:, None] < rng.integers(0, layers + 1, n)
    return n0, n_sub, cos0, wl, ln, ld, valid


def test_stack_amplitudes_match_jax(rng):
    n0, n_sub, cos0, wl, ln, ld, valid = stack_inputs(rng)
    pec = n_sub == 0
    J = [jnp.asarray(a) for a in (n0, n_sub, cos0, wl, ln, ld, valid)]
    T = [torch.as_tensor(a) for a in (n0, n_sub, cos0, wl, ln, ld, valid)]
    for jf, tf, kw in (
            (j_tf.stack_rt, t_tf.stack_rt, {}),
            (j_tf.stack_rt, t_tf.stack_rt, {"pec_substrate": pec}),
            (j_tf.stack_r, t_tf.stack_r, {}),
            (j_tf.stack_R_unpolarized, t_tf.stack_R_unpolarized, {})):
        jout = jf(*J, **{k: jnp.asarray(v) for k, v in kw.items()})
        tout = tf(*T, **{k: torch.as_tensor(v) for k, v in kw.items()})
        for a, b in zip(tout if isinstance(tout, tuple) else (tout,),
                        jout if isinstance(jout, tuple) else (jout,)):
            np.testing.assert_allclose(np_out(a), np_out(b), rtol=1e-12,
                                       atol=1e-13)
    # no layers: the bare interface; and the cosine under TIR
    jr = j_tf.stack_r(*J[:4], jnp.zeros((0, 40)), jnp.zeros((0, 40)))
    tr = t_tf.stack_r(*T[:4], torch.zeros((0, 40), dtype=F64),
                      torch.zeros((0, 40), dtype=F64))
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(np_out(a), np_out(b), rtol=1e-12,
                                   atol=1e-13)
    np.testing.assert_allclose(
        np_out(t_tf.layer_cosine(T[0], T[2], T[4][0] * 0.5)),
        np_out(j_tf.layer_cosine(J[0], J[2], J[4][0] * 0.5)), rtol=1e-12)
    assert t_tf.quarter_wave_thickness(1.38, 550.0) == \
        j_tf.quarter_wave_thickness(1.38, 550.0)


def test_stack_gradient_at_critical_incidence_matches_jax(rng):
    """d R / d(thickness, cos0) through the complex arithmetic: finite on
    every row and equal to JAX's, but for the exactly critical row.  There
    the guarded sqrt's derivative is of order 1/eps, and the last bit of
    1 - (1 - cos0^2)(n0/n)^2, which XLA's contraction into a fused
    multiply-add may round differently, decides its value; that row is
    held finite only."""
    n0, n_sub, cos0, wl, ln, ld, valid = stack_inputs(rng)
    keep = n_sub != 0

    def j_loss(ld_, cos_):
        R = j_tf.stack_R_unpolarized(n0, n_sub, cos_, wl, ln, ld_, valid)
        return jnp.sum(jnp.where(keep, R, 0.0))

    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(ld),
                                                   jnp.asarray(cos0))
    tld = torch.as_tensor(ld).requires_grad_(True)
    tcos = torch.as_tensor(cos0).requires_grad_(True)
    R = t_tf.stack_R_unpolarized(torch.as_tensor(n0), torch.as_tensor(n_sub),
                                 tcos, torch.as_tensor(wl),
                                 torch.as_tensor(ln), tld,
                                 torch.as_tensor(valid))
    tg = torch.autograd.grad(torch.sum(torch.where(torch.as_tensor(keep), R,
                                                   0.0)), (tld, tcos))
    others = np.arange(len(cos0)) != 1
    for a, b in zip(tg, jg):
        assert np.all(np.isfinite(np_out(a)))
        np.testing.assert_allclose(np_out(a)[..., others],
                                   np_out(b)[..., others], rtol=1e-9,
                                   atol=1e-12)


def test_asphere_matches_jax(rng):
    u = rng.uniform(0.0, 4.0, 64)
    for coeffs in (np.zeros((0,)), np.array([1e-3, -2e-4, 5e-6])):
        for c, k in ((0.2, -1.2), (0.8, 0.5)):   # the second past aperture
            for name in ("sag", "sag_du"):
                j = getattr(j_asphere, name)(jnp.asarray(u), c, k,
                                             jnp.asarray(coeffs))
                t = getattr(t_asphere, name)(torch.as_tensor(u), c, k,
                                             torch.as_tensor(coeffs))
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-13, atol=1e-15)
    tu = torch.as_tensor(u).requires_grad_(True)
    coeffs = torch.tensor([1e-3, -2e-4], dtype=F64)
    g = torch.autograd.grad(t_asphere.sag(tu, 0.2, -1.2, coeffs).sum(),
                            tu)[0]
    np.testing.assert_allclose(g.numpy(), t_asphere.sag_du(
        torch.as_tensor(u), 0.2, -1.2, coeffs).numpy(), rtol=1e-12)


def stacks_and_ids(dim, n_surfaces=4):
    """Two stacks (a dispersive two-layer AR and a zero-thickness one) and
    per-kind coating ids with bare surfaces."""
    stacks_j = [[(lambda wl: 1.38 + 0.0 * wl, 99.6), (2.1, 65.5)],
                [(1.45, 0.0)]]
    stacks_t = [[(lambda wl: 1.38 + 0.0 * wl, 99.6), (2.1, 65.5)],
                [(1.45, 0.0)]]
    ids = np.array([0, -1, 1, 0][:n_surfaces])
    tables = ({"triangles": ids} if dim == 3 else
              {"segments": ids, "arcs": ids[::-1].copy()})
    return stacks_j, stacks_t, tables


@pytest.mark.parametrize("dim", [2, 3])
def test_thin_film_reactions_match_jax(rng, dim):
    c = concat_cases(random_case(rng, 64, dim), edge_case(dim))
    n = len(c["p0"])
    stacks_j, stacks_t, tables = stacks_and_ids(dim)
    tables_t = convert.surface_tables_from_numpy(tables, device="cpu")
    c_int = with_fields(c, intensity=rng.uniform(0.5, 1.0, n))
    j, t = run_both(c_int,
                    jop.thin_film_intensity_reaction(stacks_j, tables),
                    top.thin_film_intensity_reaction(stacks_t, tables_t))
    assert_same(j, t)
    _, tr = torch_inputs(c)
    pol = top.seed_polarization(tr, (1.0 + 0.5j, 0.3 - 0.2j))
    c_pol = with_fields(c, **{k: v.numpy() for k, v in pol.fields.items()})
    j, t = run_both(c_pol, jop.thin_film_jones_reaction(stacks_j, tables),
                    top.thin_film_jones_reaction(stacks_t, tables_t))
    assert_same(j, t)
    # off mirrors, the zero-thickness coating is the bare Jones transport.
    # At grazing and at exactly critical incidence (edge rays 0 and 6) both
    # transmit nothing to within sqrt(eps): the stack's clamped cosine and
    # guarded sqrt leave ~1e-8 where the bare coefficients leave ~1e-16
    zero = {k: np.ones_like(v) for k, v in tables.items()}
    tp, tr = torch_inputs(c_pol)
    t0 = top.thin_film_jones_reaction(stacks_t, zero)(tp, tr, TraceConfig())
    tb = top.jones_polarization_reaction()(tp, tr, TraceConfig())
    edge = np.zeros(n, bool)
    edge[[n - 7, n - 1]] = True
    dielectric = c["n_in"] != 0
    for k in top.POL_FIELDS_2D:
        a, b = t0[2][k].numpy(), tb[2][k].numpy()
        rows = dielectric & ~edge
        np.testing.assert_allclose(a[rows], b[rows], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(a[edge], b[edge], atol=1e-7)


@pytest.mark.parametrize("dim", [2, 3])
def test_thin_film_over_branch_override_matches_jax(rng, dim):
    c = concat_cases(random_case(rng, 64, dim), edge_case(dim))
    n = len(c["p0"])
    stacks_j, stacks_t, tables = stacks_and_ids(dim)
    c = with_fields(c, intensity=np.ones(n),
                    branch_ctr=rng.integers(0, 4, n).astype(np.int32))
    sched = [1, -1, 0, 1]   # reflect, physics, transmit, reflect, physics
    j, t = run_both(
        c, jop.thin_film_intensity_reaction(
            stacks_j, tables,
            base_reaction=jop.branch_override_reaction(sched)),
        top.thin_film_intensity_reaction(
            stacks_t, tables,
            base_reaction=top.branch_override_reaction(torch.as_tensor(sched))))
    assert_same(j, t)


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ghost_analysis_matches_jax_path_by_path():
    """scenes2d.ghost_analysis at the example's CI size against the JAX
    example's vmapped trace of every schedule: landed powers, landing
    heights and branch counters of every path and ray, and the analytic
    checks held at the example's rtol 1e-6."""
    rays, depth = 101, 4
    ex = load_example("ghost_analysis")
    scene, materials = ex.build_lens(jnp.float64)
    rs = ex.beam(rays, jnp.float64)
    cfg = JTraceConfig(max_bounces=depth + 1)
    d_qw = float(j_tf.quarter_wave_thickness(ex.N_MGF2, ex.LAM))
    coatings = {"bare": ([], {}),
                "AR-coated": ([[(ex.N_MGF2, d_qw)]],
                              {"arcs": np.asarray([0, 0])})}
    schedules = jop.all_branch_schedules(depth)

    results, names = scenes2d.ghost_analysis(rays, depth, dtype=F64,
                                             device="cpu", verbose=False)
    assert names == [ex.schedule_name(r) for r in np.asarray(schedules)]
    np.testing.assert_array_equal(
        top.all_branch_schedules(depth, "cpu").numpy(), np.asarray(schedules))
    for label, (stacks, coat_ids) in coatings.items():
        def trace_sched(sched, stacks=stacks, coat_ids=coat_ids):
            rx = jop.thin_film_intensity_reaction(
                stacks, coat_ids,
                base_reaction=jop.branch_override_reaction(sched))
            res = j_engine.trace(rs, scene, materials, cfg, reaction=rx)
            landed = res.rays.state == J_FINISHED
            power = jnp.where(landed, res.rays.fields["intensity"], 0.0)
            return power, res.rays.p1[:, 1], res.rays.fields["branch_ctr"]

        power, y, ctr = jax.jit(jax.vmap(trace_sched))(schedules)
        got = results[label]
        np.testing.assert_allclose(got["power"], np.asarray(power),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got["y"], np.asarray(y), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_array_equal(got["ctr"], np.asarray(ctr))
        assert max(got["rel"].values()) <= 1e-6
