"""The port's analytic sequential tracer (``sequential.py``) against the
JAX package's on the CPU in float64: the same stacks and rays, made from
numpy, through both.

* ``trace_sequential`` on the Cooke triplet at 3 lines x 3 fields, an
  asphere stack with a4/a6 terms and a skew ray fan, a folded stack of two
  mirrors around a refraction, and the kill paths (vignetting, TIR, a
  missed surface, a refraction into the n = 0 sentinel): ``p``, ``d``,
  ``opl`` and ``n`` within atol 1e-12, ``alive`` exactly.
* the gradient of a scalar of the landings and path lengths with respect
  to ``c``, ``k``, ``coeffs``, ``vertex_z`` and ``image_z`` against
  ``jax.grad``: within rtol 1e-9 (atol 1e-12).
* ``collimated_bundle`` on both grids: within atol 1e-15.
* ``decenter=``, ``tilt=`` and ``dn=`` raise ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import sequential as js
from tensorflowraytrace_tpu.ops import materials as jm
from tensorflowraytrace_tpu_torch import config, sequential as ts
from tensorflowraytrace_tpu_torch.ops import materials as tm
from tensorflowraytrace_tpu_torch.utils.convert import (
    asphere_stack_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64
ATOL = 1e-12
GRAD_RTOL = 1e-9

# vacuum, glass 1.5, the reflective sentinel, crown, flint
J_MATERIALS = (jm.vacuum, jm.build_constant_material(1.5), jm.reflective,
               jm.crown_glass, jm.flint_glass)
T_MATERIALS = (tm.vacuum, tm.build_constant_material(1.5), tm.reflective,
               tm.crown_glass, tm.flint_glass)
FIELDS = ("vertex_z", "c", "k", "coeffs", "aperture", "mat_after", "mirror")


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def stack_np(vertex_z, c, k=0.0, coeffs=None, aperture=np.inf, mat_after=0,
             mirror=False):
    n = len(vertex_z)
    coeffs = np.zeros((n, 0)) if coeffs is None else np.asarray(coeffs,
                                                                 float)
    return {"vertex_z": np.asarray(vertex_z, float),
            "c": np.broadcast_to(np.asarray(c, float), (n,)),
            "k": np.broadcast_to(np.asarray(k, float), (n,)),
            "coeffs": coeffs,
            "aperture": np.broadcast_to(np.asarray(aperture, float), (n,)),
            "mat_after": np.broadcast_to(np.asarray(mat_after), (n,)),
            "mirror": np.broadcast_to(np.asarray(mirror, bool), (n,))}


def fan(n, half, z0, dy=0.0, dx=0.0, back=False):
    """A collimated fan along y at ``z0`` tilted by (dx, dy) (numpy)."""
    ys = np.linspace(-half, half, n)
    p = np.stack([0.3 * ys, ys, np.full(n, z0)], 1)
    d = np.tile([dx, dy, -1.0 if back else 1.0], (n, 1))
    return p, d


def cooke_case():
    """The Cooke triplet's start, 12 hex-pupil rays at 3 lines x 3 fields
    (the port's ``classical.cooke_bundles`` order)."""
    from tensorflowraytrace_tpu_torch import classical as cl
    p, d, wl, _, _ = cl.cooke_bundles(12, F64, "cpu")
    stack = stack_np(cl.COOKE_VERTEX_Z, cl.P_INIT,
                     aperture=cl.COOKE_APERTURES,
                     mat_after=[3, 0, 4, 0, 3, 0])   # crown, flint, crown
    return stack, p.numpy(), d.numpy(), wl.numpy(), 0, cl.COOKE_IMAGE_Z


def asphere_case():
    rng = np.random.default_rng(3)
    stack = stack_np([0.0, 0.35, 0.8], [0.6, -0.3, 0.2], k=[-0.7, 0.5, 0.0],
                     coeffs=[[0.02, -0.004], [0.0, 0.01], [-0.01, 0.0]],
                     mat_after=[1, 0, 3])
    n = 24
    p = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                  np.full(n, -1.0)], 1)
    d = np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n),
                  np.ones(n)], 1)
    return stack, p, d, 550.0, 0, 2.5


def mirror_case():
    """A parabolic mirror (the sentinel as ``mat_after``), a refraction
    into glass on the way back up, and a plane mirror folding the rays down
    again."""
    stack = stack_np([0.0, 0.5, 1.0], [0.31, 0.0, 0.0], k=[-1.0, 0.0, 0.0],
                     mat_after=[2, 1, 2], mirror=[True, False, True])
    p, d = fan(9, 0.6, 2.0, dy=0.02, back=True)
    return stack, p, d, 550.0, 0, 0.2


def vignetting_case():
    stack = stack_np([0.0], 0.1, aperture=0.5, mat_after=1)
    p, d = fan(9, 1.0, -1.0)
    return stack, p, d, 550.0, 0, None


def tir_case():
    """Glass -> vacuum at the critical angle +- 0.05 (start_mat 1)."""
    th = np.arcsin(1.0 / 1.5) + np.asarray([-0.05, 0.05, -0.2, 0.2])
    p = np.stack([np.zeros(4), np.zeros(4), np.full(4, -1.0)], 1)
    d = np.stack([np.zeros(4), np.sin(th), np.cos(th)], 1)
    return stack_np([0.0], 0.0, mat_after=0), p, d, 550.0, 1, None


def missed_case():
    """Rays outside a sphere's natural aperture and inside it."""
    stack = stack_np([0.0, 0.4], [2.0, -0.5], mat_after=[1, 0])
    p, d = fan(7, 0.9, -2.0)
    return stack, p, d, 550.0, 0, 3.0


def sentinel_case():
    """Refraction into the n = 0 sentinel without ``mirror``: every ray
    dies."""
    stack = stack_np([0.0, 1.0], [0.2, 0.0], mat_after=[2, 0])
    p, d = fan(5, 0.3, -1.0)
    return stack, p, d, 550.0, 0, None


CASES = {"cooke": cooke_case, "asphere": asphere_case, "mirror": mirror_case,
         "vignetting": vignetting_case, "tir": tir_case,
         "missed": missed_case, "sentinel": sentinel_case}


def torch_stack(s, **over):
    kw = {f: np.array(s[f]) for f in FIELDS}
    kw.update(over)
    return ts.AsphereStack.make(dtype=F64, device="cpu", **kw)


def j_trace(p, d, wl, fields, image_z, start_mat):
    """The JAX package's trace of a stack given as its seven field arrays."""
    stack = js.AsphereStack.make(dtype=J64, **dict(zip(FIELDS, fields)))
    return js.trace_sequential(p, d, wl, stack, J_MATERIALS,
                               image_z=image_z, start_mat=start_mat)


# jitted, so a case's shapes compile once (eager, the scan compiles anew
# at every call)
J_TRACE = jax.jit(j_trace, static_argnames=("start_mat",))


def j_loss(c, k, coeffs, vz, iz, rest, p, d, wl, w):
    """The sum of the live rays' weighted landings and path lengths."""
    aperture, mat_after, mirror = rest
    r = j_trace(p, d, wl, (vz, c, k, coeffs, aperture, mat_after, mirror),
                iz, 0)
    live = jnp.where(r.alive, 1.0, 0.0)
    return jnp.sum(live[:, None] * r.p * w) + jnp.sum(live * r.opl)


# one compile serves every gradient case of the same shapes
J_GRAD = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3, 4)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_sequential_matches_jax(name):
    s, p, d, wl, start, image_z = CASES[name]()
    rj = J_TRACE(jnp.asarray(p), jnp.asarray(d),
                 jnp.broadcast_to(jnp.asarray(wl, J64), (p.shape[0],)),
                 tuple(jnp.asarray(s[f]) for f in FIELDS),
                 None if image_z is None else jnp.asarray(image_z, J64),
                 start_mat=start)
    stack = asphere_stack_from_numpy(**s, dtype=F64, device="cpu")
    rt = ts.trace_sequential(torch.as_tensor(p), torch.as_tensor(d), wl,
                             stack, T_MATERIALS, image_z=image_z,
                             start_mat=start)
    np.testing.assert_array_equal(rt.alive.numpy(), np.asarray(rj.alive))
    for f in ("p", "d", "opl", "n"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_allclose(rt.landing.numpy(), np.asarray(rj.landing),
                               rtol=0, atol=ATOL)
    if name in ("cooke", "asphere", "mirror"):
        assert rt.alive.any(), "no ray survived: the case tests nothing"
    if name in ("vignetting", "tir", "missed"):
        assert rt.alive.any() and not rt.alive.all()
    if name == "sentinel":
        assert not rt.alive.any()


def grad_case(name):
    """The asphere stack or the folded mirror stack, both as 3 surfaces
    with a4 and a6 terms and 24 rays (one compile of ``J_GRAD``)."""
    s, p, d, wl, _, image_z = CASES[name]()
    if name == "mirror":
        s = dict(s, coeffs=np.asarray([[1e-3, -2e-4], [0.0, 0.0],
                                       [2e-3, 0.0]]))
        p, d = fan(24, 0.6, 2.0, dy=0.02, back=True)
    return s, p, d, np.full(p.shape[0], wl), image_z


@pytest.mark.parametrize("name", ["asphere", "mirror"])
def test_trace_sequential_gradients_match_jax(name):
    """d/d(c, k, coeffs, vertex_z, image_z) of the sum of the live rays'
    weighted landings and path lengths, against ``jax.grad``."""
    s, p, d, wl, image_z = grad_case(name)
    w = np.random.default_rng(11).normal(size=(p.shape[0], 3))
    names = ("c", "k", "coeffs", "vertex_z")
    rest = tuple(jnp.asarray(s[f]) for f in ("aperture", "mat_after",
                                             "mirror"))
    gj = J_GRAD(*(jnp.asarray(s[f]) for f in names),
                jnp.asarray(image_z, J64), rest, jnp.asarray(p),
                jnp.asarray(d), jnp.asarray(wl), jnp.asarray(w))

    leaves = [torch.tensor(s[f], dtype=F64, requires_grad=True)
              for f in names]
    leaves.append(torch.tensor(image_z, dtype=F64, requires_grad=True))
    c, k, coeffs, vz, iz = leaves
    r = ts.trace_sequential(
        torch.as_tensor(p), torch.as_tensor(d), torch.as_tensor(wl),
        torch_stack(s, c=c, k=k, coeffs=coeffs, vertex_z=vz), T_MATERIALS,
        image_z=iz)
    assert r.alive.any() and np.array_equal(
        r.alive.numpy(), np.asarray(J_TRACE(
            jnp.asarray(p), jnp.asarray(d), jnp.asarray(wl),
            tuple(jnp.asarray(s[f]) for f in FIELDS),
            jnp.asarray(image_z, J64), start_mat=0).alive))
    live = r.alive.to(F64)
    loss = (torch.sum(live[:, None] * r.p * torch.as_tensor(w))
            + torch.sum(live * r.opl))
    gt = torch.autograd.grad(loss, leaves)
    for f, a, b in zip(names + ("image_z",), gt, gj):
        assert np.isfinite(a.numpy()).all(), f
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=f)


@pytest.mark.parametrize("grid", ["line", "hex"])
def test_collimated_bundle_matches_jax(grid):
    pj, dj = js.collimated_bundle(17, 0.7, z_start=-1.5, field_angle=0.03,
                                  azimuth=0.4, grid=grid, dtype=J64)
    pt, dt = ts.collimated_bundle(17, 0.7, z_start=-1.5, field_angle=0.03,
                                  azimuth=0.4, grid=grid, dtype=F64)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-15)


def test_asphere_stack_defaults_match_jax():
    sj = js.AsphereStack.make(vertex_z=[0.0, 1.0], c=0.2, dtype=J64)
    st = ts.AsphereStack.make(vertex_z=[0.0, 1.0], c=0.2, dtype=F64)
    assert st.n_surfaces == sj.n_surfaces == 2
    for f in FIELDS:
        got, want = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert st.mat_after.dtype == torch.int32 and st.mirror.dtype == torch.bool


@pytest.mark.parametrize("knob", ["decenter", "tilt", "dn"])
def test_alignment_knobs_raise(knob):
    """The JAX package accepts these and ignores them; the port raises."""
    s, p, d, wl, start, image_z = vignetting_case()
    value = np.zeros((1,)) if knob == "dn" else np.zeros((1, 2))
    with pytest.raises(NotImplementedError, match=knob):
        ts.trace_sequential(torch.as_tensor(p), torch.as_tensor(d), wl,
                            torch_stack(s), T_MATERIALS,
                            **{knob: torch.as_tensor(value)})
