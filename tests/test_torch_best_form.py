"""The best-form singlet (``classical.best_form_singlet``: the lens design
of tests/test_lsq.py's ``TestLensDesign`` through the port's ``lm_solve``)
against the JAX package's ``lm_solve`` on the same merit, on the CPU in
float64: ``accepted`` exactly, ``cost_history`` and the curvatures within
rtol 1e-8 at every one of the 25 iterations.  It asserts what the JAX
solve meets (a step accepted, the cost below 1e-2 of the start, the EFL
within 1e-3 of 50) and not the thin-lens shape factor, which neither
solve reaches: the fixed x10 / x0.2 damping stalls in the merit valley.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowraytrace_tpu.lsq import lm_solve as j_lm_solve
from tensorflowraytrace_tpu.ops.materials import crown_glass, vacuum
from tensorflowraytrace_tpu.paraxial import paraxial_system
from tensorflowraytrace_tpu.sequential import (
    AsphereStack, collimated_bundle, trace_sequential,
)
from tensorflowraytrace_tpu_torch import classical, config
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

RTOL = 1e-8
STEPS = 25


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def j_stack(c):
    return AsphereStack.make(vertex_z=jnp.asarray([0.0, 3.0]), c=c,
                             aperture=jnp.asarray([8.0, 8.0]),
                             mat_after=jnp.asarray([1, 0]), dtype=jnp.float64)


def j_resid(c):
    """tests/test_lsq.py's ``TestLensDesign._resid``."""
    mats = [vacuum, crown_glass]
    stack = j_stack(c)
    ps = paraxial_system(stack, mats, classical.SINGLET_WL)
    p, d = collimated_bundle(15, 2.5, z_start=-5.0, dtype=jnp.float64)
    r = trace_sequential(p, d, classical.SINGLET_WL, stack, mats,
                         image_z=ps.back_focal_point)
    return jnp.concatenate([
        r.p[:, 1] * jnp.where(r.alive, 1.0, 0.0),
        jnp.atleast_1d(100.0 * (ps.efl - classical.SINGLET_EFL))])


def j_best_form(c0):
    """JAX's solve, its starting cost and its final EFL, under one jit:
    one compile (eager, the start's trace alone takes seconds)."""
    r = j_lm_solve(j_resid, c0, steps=STEPS)
    cost0 = 0.5 * jnp.sum(j_resid(c0) ** 2)
    efl = paraxial_system(j_stack(r.params), [vacuum, crown_glass],
                          classical.SINGLET_WL).efl
    return r, cost0, efl


def test_best_form_singlet_follows_the_jax_trajectory():
    rj, j_cost0, j_efl = jax.jit(j_best_form)(
        jnp.asarray(classical.SINGLET_C0))
    out = classical.best_form_singlet(steps=STEPS, device="cpu")
    rt = out["result"]
    np.testing.assert_array_equal(rt.accepted.numpy(),
                                  np.asarray(rj.accepted))
    np.testing.assert_allclose(rt.cost_history.numpy(),
                               np.asarray(rj.cost_history), rtol=RTOL)
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params),
                               rtol=RTOL)
    np.testing.assert_allclose(out["cost0"], float(j_cost0), rtol=1e-12)
    # what the JAX solve meets
    assert bool(rt.accepted.any())
    assert float(rt.cost) < out["cost0"] * 1e-2
    assert abs(out["efl"] - classical.SINGLET_EFL) < 1e-3
    np.testing.assert_allclose(out["efl"], float(j_efl), rtol=RTOL)
