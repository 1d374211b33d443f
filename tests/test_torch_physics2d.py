"""The 2D reaction examples of ``physics2d.py`` (``fresnel_intensity``,
``spectrometer``, ``fresnel_rhomb``, ``ar_coating``) against the JAX
examples on the CPU in float64; the three designs are in
tests/test_torch_physics2d_designs.py.

For each example the JAX example's own helpers (loaded from examples/, as
tests/test_examples.py loads them) and the port's counterparts take the
same inputs: one trace's landings and fields and one gradient, or the
first steps' losses and parameters of the design (optax against
``torch.optim.Adam``; the JAX ``Optimizer`` against the port's), within
rtol 1e-9.  Then each port function runs end to end at its size in
tests/test_examples.py's CASES with the example's checks, its numbers held
to those the example prints there.
"""

import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config, physics2d
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64
RTOL = 1e-9
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True)
def on_cpu(tmp_path, monkeypatch):
    """The CPU, and a scratch working directory for the JAX examples'
    files."""
    monkeypatch.chdir(tmp_path)
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def close(t, j, rtol=RTOL, atol=1e-14):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


# ----------------------------------------------------------------------
# fresnel_intensity
# ----------------------------------------------------------------------

def test_fresnel_intensity_matches_jax():
    ex = load("fresnel_intensity")
    rays = 400
    angles = np.linspace(-0.5, 0.5, rays)
    p0 = np.full((rays, 2), [-2.0, 0.0])
    p1 = p0 + np.stack([np.cos(angles), np.sin(angles)], axis=1)
    j_mat = (j_mats.vacuum, j_mats.build_constant_material(1.52))
    j_rays = JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 550.0,
                          fields={"intensity": jnp.ones(rays, J64)},
                          dtype=J64)
    rx = ex.fresnel_intensity_reaction()

    def j_delivered(radius):
        r = j_trace(j_rays, ex.build_scene(radius, J64), j_mat,
                    JTraceConfig(max_bounces=3), reaction=rx)
        ok = r.rays.state == 1
        return jnp.sum(jnp.where(ok, r.rays.fields["intensity"], 0.0)), r

    (_, j_res), j_g = jax.value_and_grad(j_delivered, has_aux=True)(
        jnp.asarray(8.0, J64))

    out = physics2d.fresnel_intensity(rays, dtype=F64, device="cpu",
        verbose=False)
    fin = np.asarray(j_res.rays.state) == 1
    assert out["finished"] == fin.sum()
    close(out["power"], np.asarray(j_res.rays.fields["intensity"])[fin].sum()
          / rays)
    close(out["grad"], j_g)


# ----------------------------------------------------------------------
# spectrometer
# ----------------------------------------------------------------------

def test_spectrometer_landings_and_steps_match_jax():
    ex = load("spectrometer")
    lams = np.linspace(450.0, 650.0, 7)
    params = (1480.0, 2.3)
    j_y, j_state = ex.landings(jnp.asarray(params, J64),
                               jnp.asarray(lams), J64)
    landings = physics2d.spectrometer_problem(F64, "cpu")
    y, state, _ = landings(t64(params), t64(lams))
    close(y, j_y)
    assert np.array_equal(state.numpy(), np.asarray(j_state))

    # the example's first Adam steps on the anchor loss
    anchors = jnp.asarray([450.0, 650.0], J64)
    targets = jnp.asarray([-0.9, -2.1], J64)

    def j_loss(q):
        y, _ = ex.landings(jnp.stack([1000.0 * q[0], q[1]]), anchors, J64)
        return jnp.sum((y - targets) ** 2)

    vg = jax.jit(jax.value_and_grad(j_loss))
    tx = optax.adam(0.1)
    q = jnp.asarray([1.5, 2.5], J64)
    state = tx.init(q)
    j_losses = []
    for _ in range(4):
        v, g = vg(q)
        upd, state = tx.update(g, state, q)
        q = optax.apply_updates(q, upd)
        j_losses.append(float(v))
    _, opt = physics2d.spectrometer_design(landings, F64, "cpu")
    close(opt.run_phase(4), j_losses)
    close(opt.parameters[0], q)


def test_spectrometer_runs():
    out = physics2d.spectrometer(400, dtype=F64, device="cpu",
                                 verbose=False)
    assert out["anchor_loss"] < 1e-8 and out["band_rel_err"] <= 1e-6
    # the example's own run prints 747.79 nm and 1.1945
    assert (round(out["spacing"], 2), round(out["dist"], 4)) == (747.79,
                                                                 1.1945)


# ----------------------------------------------------------------------
# fresnel_rhomb
# ----------------------------------------------------------------------

def test_fresnel_rhomb_matches_jax():
    ex = load("fresnel_rhomb")
    j_mat = (j_mats.vacuum, j_mats.build_constant_material(1.5))

    def j_loss(theta):
        s = ex.traced_stokes(theta, j_mat, J64)
        return (s["S2"][0] / s["S0"][0]) ** 2

    vag = jax.jit(jax.value_and_grad(j_loss))
    stokes = physics2d.rhomb_problem(F64, "cpu")
    theta_j = jnp.asarray(0.80, J64)
    theta_t = torch.tensor(0.80, dtype=F64)
    for _ in range(3):
        v, g = vag(theta_j)
        leaf = theta_t.clone().requires_grad_(True)
        loss = physics2d.rhomb_loss(stokes, leaf)
        gt, = torch.autograd.grad(loss, leaf)
        close(loss, v)
        close(gt, g)
        theta_j = theta_j - 0.03 * g
        theta_t = (leaf - 0.03 * gt).detach()
    s_j = ex.traced_stokes(theta_j, j_mat, J64)
    s_t = stokes(theta_t)
    for k in ("S0", "S1", "S2", "S3"):
        close(s_t[k], s_j[k], atol=1e-15)

    out = physics2d.fresnel_rhomb(40, dtype=F64, device="cpu",
                                  verbose=False)
    theta = jnp.asarray(0.80, J64)
    for _ in range(40):
        theta = theta - 0.03 * vag(theta)[1]
    close(out["theta"], theta)


# ----------------------------------------------------------------------
# ar_coating
# ----------------------------------------------------------------------

def test_ar_coating_matches_jax(capsys):
    ex = load("ar_coating")
    d_j, _ = ex.design_coating(20)
    capsys.readouterr()
    d, r0, r1, r_qw, r_bare = physics2d.design_coating(20, F64, "cpu")
    close(d, [float(t) for _, t in d_j])
    lams = jnp.linspace(450.0, 650.0, 11)
    cosines = jnp.cos(jnp.linspace(0.0, math.radians(30.0), 5))
    close(r_bare, ex.band_mean_reflectance(jnp.zeros((0,)), (), lams,
                                           cosines))

    scene_j, mats_j = ex.build_lens(J64)
    rays_j = ex.fan_rays(128, J64)
    stack_j = [(n, jnp.asarray(float(t))) for n, t in d_j]
    res_j = j_trace(rays_j, scene_j, mats_j, JTraceConfig(max_bounces=3),
                    reaction=ex.thin_film_intensity_reaction(
                        [stack_j], {"arcs": np.asarray([0, 0])}))
    scene, materials = physics2d.coated_lens(F64, "cpu")
    res = physics2d.trace(
        physics2d.white_fan(128, F64, "cpu"), scene, materials,
        physics2d.TraceConfig(max_bounces=3),
        reaction=physics2d.thin_film_intensity_reaction(
            [[(physics2d.N_MGF2, d[0]), (physics2d.N_AL2O3, d[1])]],
            {"arcs": torch.tensor([0, 0])}))
    close(res.rays.p1, res_j.rays.p1)
    close(res.rays.fields["intensity"], res_j.rays.fields["intensity"])

    out = physics2d.ar_coating(60, 128, dtype=F64, device="cpu",
                               verbose=False)
    # the example's own run prints 117.43 bare and 126.61 coated
    assert (round(out["power_bare"], 2), round(out["power_coated"], 2)) == (
        117.43, 126.61)


