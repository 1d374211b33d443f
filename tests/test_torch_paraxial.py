"""The port's first- and third-order analysis (``paraxial.py``) against the
JAX package's on the CPU in float64, on three stacks made from numpy: the
Cooke triplet (dispersive glasses), an aspheric singlet with a4 terms, and
a folded stack of two mirrors around a refraction (signed indices).

Every function of the module and every property of ``ParaxialSystem``
within rtol 1e-10 (atol 1e-12), ``field_curves`` with its real rays too;
the gradient of the EFL with respect to the curvatures within rtol 1e-9;
``field_curves`` traces four rays a field (the JAX package five).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import paraxial as jp
from tensorflowraytrace_tpu import sequential as js
from tensorflowraytrace_tpu.ops import materials as jm
from tensorflowraytrace_tpu_torch import config, paraxial as tp
from tensorflowraytrace_tpu_torch import sequential as ts
from tensorflowraytrace_tpu_torch.ops import materials as tm
from tensorflowraytrace_tpu_torch.utils.convert import (
    asphere_stack_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64
RTOL, ATOL = 1e-10, 1e-12
WL, WL_S, WL_L = 587.6, 486.1, 656.3

J_MATERIALS = (jm.vacuum, jm.crown_glass, jm.flint_glass, jm.reflective)
T_MATERIALS = (tm.vacuum, tm.crown_glass, tm.flint_glass, tm.reflective)

STACKS = {
    "cooke": dict(vertex_z=[0.0, 0.55, 1.45, 1.85, 2.75, 3.15],
                  c=[0.32, -0.04, -0.30, 0.30, 0.04, -0.32],
                  k=[0.0] * 6, coeffs=[[0.0]] * 6,
                  mat_after=[1, 0, 2, 0, 1, 0], mirror=[False] * 6),
    "asphere": dict(vertex_z=[0.0, 0.4], c=[0.45, -0.1], k=[-0.6, 0.3],
                    coeffs=[[0.01], [-0.02]], mat_after=[1, 0],
                    mirror=[False, False]),
    # a concave mirror, a glass plate met on the way back, a plane mirror
    "mirror": dict(vertex_z=[0.0, -0.5, -0.8, -1.2],
                   c=[-0.2, 0.1, 0.0, 0.05], k=[0.0] * 4,
                   coeffs=[[0.0]] * 4, mat_after=[3, 1, 0, 3],
                   mirror=[True, False, False, True]),
}
STOP = {"cooke": 2, "asphere": 0, "mirror": 1}


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def stacks(name):
    s = {f: np.asarray(v) for f, v in STACKS[name].items()}
    s["aperture"] = np.full(len(s["c"]), np.inf)
    sj = js.AsphereStack.make(dtype=J64, **{f: jnp.asarray(v)
                                            for f, v in s.items()})
    return sj, asphere_stack_from_numpy(**s, dtype=F64, device="cpu")


def close(t, j, rtol=RTOL, what=""):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=ATOL,
                               err_msg=what)


SYSTEM_FIELDS = ("A", "B", "C", "D", "n_obj", "n_img", "z_front", "z_back",
                 "power", "efl", "back_focal_point", "front_focal_point",
                 "back_principal_plane", "front_principal_plane",
                 "back_nodal_point", "front_nodal_point")


@jax.jit
def j_system(sj):
    """Everything of the JAX package's first-order layer on one stack, one
    compile (eager, each scan and primitive compiles on its own)."""
    ps = jp.paraxial_system(sj, J_MATERIALS, WL)
    out = {f: getattr(ps, f) for f in SYSTEM_FIELDS}
    out["indices"] = jp._signed_indices(sj, J_MATERIALS, WL, 0)
    out["image"] = [ps.image_distance(z) for z in (-40.0, -7.5)]
    out["mag"] = [ps.magnification(z) for z in (-40.0, -7.5)]
    out["petzval"] = jp.petzval_sum(sj, J_MATERIALS, WL)
    return out


@pytest.mark.parametrize("name", sorted(STACKS))
def test_signed_indices_and_system(name):
    sj, st = stacks(name)
    want = j_system(sj)
    for a, b in zip(tp._signed_indices(st, T_MATERIALS, WL, 0),
                    want["indices"]):
        close(a, b, what="signed indices")
    pt = tp.paraxial_system(st, T_MATERIALS, WL)
    for f in SYSTEM_FIELDS:
        close(getattr(pt, f), want[f], what=f)
    for z, image, mag in zip((-40.0, -7.5), want["image"], want["mag"]):
        close(pt.image_distance(z), image, what="image")
        close(pt.magnification(z), mag, what="mag")
    close(tp.petzval_sum(st, T_MATERIALS, WL), want["petzval"],
          what="petzval")
    if name == "mirror":   # negative between the two mirrors, + after
        n_out = tp._signed_indices(st, T_MATERIALS, WL, 0)[1]
        assert (n_out[:-1] < 0).any() and float(pt.n_img) > 0


Y0 = np.asarray([0.1, -0.2, 0.3])
U0 = np.asarray([0.01, 0.0, -0.02])
TRACE_ARGS = ((0.2, 0.01), (Y0, U0), (0.1, U0))


@jax.jit
def j_traces(sj):
    return ([jp.paraxial_trace(jnp.asarray(y), jnp.asarray(u), sj,
                               J_MATERIALS, WL, z_start=-1.5)
             for y, u in TRACE_ARGS]
            + [jp.paraxial_trace(0.2, 0.0, sj, J_MATERIALS, WL)])


@pytest.mark.parametrize("name", sorted(STACKS))
def test_paraxial_trace(name):
    """Scalar, vector and mixed launches from z = -1.5, and a scalar one
    from the first vertex."""
    sj, st = stacks(name)
    got = [tp.paraxial_trace(*(torch.as_tensor(np.asarray(a)) for a in args),
                             st, T_MATERIALS, WL, z_start=-1.5)
           for args in TRACE_ARGS]
    got.append(tp.paraxial_trace(0.2, 0.0, st, T_MATERIALS, WL))
    for pair_t, pair_j in zip(got, j_traces(sj)):
        for a, b in zip(pair_t, pair_j):
            assert a.shape == b.shape
            close(a, b, what="paraxial_trace")


@jax.jit(static_argnums=(1, 2))
def j_stop_seidel(sj, stop_index, chromatic):
    ss = jp.solve_stop(sj, J_MATERIALS, WL, stop_index=stop_index,
                       aperture=0.3, field_angle=0.04, z_start=-1.0)
    return ss, jp.seidel_sums(sj, J_MATERIALS, WL, ss.marginal, ss.chief,
                              z_start=-1.0, chromatic=chromatic)


@pytest.mark.parametrize("name, chromatic", [
    ("asphere", None), ("cooke", (WL_S, WL_L)), ("mirror", (WL_S, WL_L))])
def test_solve_stop_and_seidel_sums(name, chromatic):
    sj, st = stacks(name)
    kw = dict(stop_index=STOP[name], aperture=0.3, field_angle=0.04,
              z_start=-1.0)
    ssj, sj_ = j_stop_seidel(sj, STOP[name], chromatic)
    sst = tp.solve_stop(st, T_MATERIALS, WL, **kw)
    for f in ("entrance_pupil", "exit_pupil"):
        close(getattr(sst, f), getattr(ssj, f), what=f)
    for a, b in zip(sst.marginal + sst.chief, ssj.marginal + ssj.chief):
        close(a, b, what="defining rays")
    st_ = tp.seidel_sums(st, T_MATERIALS, WL, sst.marginal, sst.chief,
                         z_start=-1.0, chromatic=chromatic)
    for f in ("S1", "S2", "S3", "S4", "S5", "C1", "C2", "H", "per_surface"):
        close(getattr(st_, f), getattr(sj_, f), what=f)
    assert st_.per_surface.shape == (len(STACKS[name]["c"]), 7)


@jax.jit
def j_color_beam(sj, wls):
    g = jp.gaussian_beam(sj, J_MATERIALS, 1064.0, 0.05, -20.0)
    return (jp.axial_color(sj, J_MATERIALS, wls),
            jp.lateral_color(sj, J_MATERIALS, wls, (0.05, 0.03), -1.0, 12.0),
            {f: getattr(g, f) for f in ("waist", "z_waist", "rayleigh",
                                        "divergence", "n_img")},
            g.width(25.0))


@pytest.mark.parametrize("name", ["cooke", "mirror"])
def test_color_and_gaussian_beam(name):
    sj, st = stacks(name)
    wls = [WL_S, WL, WL_L]
    axial, lateral, beam, width = j_color_beam(sj, jnp.asarray(wls))
    close(tp.axial_color(st, T_MATERIALS, wls), axial, what="axial")
    close(tp.lateral_color(st, T_MATERIALS, wls, (0.05, 0.03), -1.0, 12.0),
          lateral, what="lateral")
    gt = tp.gaussian_beam(st, T_MATERIALS, 1064.0, 0.05, -20.0)
    for f, v in beam.items():
        close(getattr(gt, f), v, what=f)
    close(gt.width(25.0), width, what="width")


def test_gaussian_beam_gradient_through_the_complex_parameter():
    """d(waist z)/d(c) and d(waist)/d(input waist) through ``q``."""
    s = {f: np.asarray(v) for f, v in STACKS["asphere"].items()}

    def j_fn(c, w0):
        sj = js.AsphereStack.make(vertex_z=s["vertex_z"], c=c, k=s["k"],
                                  coeffs=s["coeffs"], mat_after=s["mat_after"],
                                  dtype=J64)
        g = jp.gaussian_beam(sj, J_MATERIALS, 1064.0, w0, -20.0)
        return g.z_waist + 100.0 * g.waist

    gj = jax.jit(jax.grad(j_fn, argnums=(0, 1)))(jnp.asarray(s["c"]),
                                        jnp.asarray(0.05))
    c = torch.tensor(s["c"], dtype=F64, requires_grad=True)
    w0 = torch.tensor(0.05, dtype=F64, requires_grad=True)
    st = ts.AsphereStack.make(vertex_z=s["vertex_z"], c=c, k=s["k"],
                              coeffs=s["coeffs"], mat_after=s["mat_after"],
                              dtype=F64)
    g = tp.gaussian_beam(st, T_MATERIALS, 1064.0, w0, -20.0)
    gt = torch.autograd.grad(g.z_waist + 100.0 * g.waist, (c, w0))
    for a, b in zip(gt, gj):
        close(a, b, rtol=1e-9, what="gaussian beam gradient")


@pytest.mark.parametrize("name", ["cooke", "asphere"])
def test_field_curves_four_rays_a_field(name, monkeypatch):
    sj, st = stacks(name)
    fields = np.linspace(0.0, 0.05, 4)
    kw = dict(stop_index=STOP[name], aperture=0.3, z_start=-1.0, rho=0.1)
    fj = jax.jit(lambda sj, f: jp.field_curves(
        sj, J_MATERIALS, WL, field_angles=f, **kw))(sj, jnp.asarray(fields))
    traced = []
    real = tp.trace_sequential

    def counting(p, *a, **k):
        traced.append(p.shape[0])
        return real(p, *a, **k)

    monkeypatch.setattr(tp, "trace_sequential", counting)
    ft = tp.field_curves(st, T_MATERIALS, WL, field_angles=fields, **kw)
    assert traced == [4 * len(fields)]
    for f in ("field_angles", "z_image", "tangential", "sagittal",
              "chief_height", "paraxial_height", "distortion"):
        close(getattr(ft, f), getattr(fj, f), rtol=1e-9, what=f)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_efl_gradient(name):
    s = {f: np.asarray(v) for f, v in STACKS[name].items()}

    def j_efl(c):
        sj = js.AsphereStack.make(
            vertex_z=s["vertex_z"], c=c, k=s["k"], coeffs=s["coeffs"],
            mat_after=s["mat_after"], mirror=s["mirror"], dtype=J64)
        return jp.paraxial_system(sj, J_MATERIALS, WL).efl

    gj = jax.jit(jax.grad(j_efl))(jnp.asarray(s["c"]))
    c = torch.tensor(s["c"], dtype=F64, requires_grad=True)
    st = ts.AsphereStack.make(
        vertex_z=s["vertex_z"], c=c, k=s["k"], coeffs=s["coeffs"],
        mat_after=s["mat_after"], mirror=s["mirror"], dtype=F64)
    (gt,) = torch.autograd.grad(tp.paraxial_system(st, T_MATERIALS, WL).efl,
                                c)
    close(gt, gj, rtol=1e-9, what="d efl / d c")
