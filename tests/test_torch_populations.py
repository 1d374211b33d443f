"""``populations.tolerancing`` against examples/tolerancing.py on the CPU
in float64 (``design_sweep``: tests/test_torch_design_sweep.py).

The JAX example ``jax.vmap``s its trace over the builds; the port traces
each build in turn.  Both sides run the example's flow at its CI size in
tests/test_examples.py's CASES (128 builds, 48 rays; the JAX side through
the example's ``rms_spot``, in float64): the spot and its gradient, the
nominal design, the sensitivities and the Monte-Carlo spots on JAX's own
normal draws (``jax.random.normal(PRNGKey(0))``, handed to the port),
within rtol 1e-9; the port's checks pass.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import config, populations
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
J64 = jnp.float64
RTOL = 1e-9
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True)
def on_cpu():
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


def test_tolerancing_matches_jax():
    ex = load("tolerancing")
    samples, n_rays = 128, 48
    materials = (j_mats.vacuum, j_mats.build_constant_material(ex.N_GLASS))
    ys = np.linspace(-ex.APERTURE, ex.APERTURE, n_rays)
    p0 = np.stack([np.full(n_rays, -1.0), ys], axis=1)
    rays = JRaySet.make(jnp.asarray(p0, J64), jnp.asarray(p0 + [1.0, 0.0],
                                                          J64), 550.0,
                        dtype=J64)
    spot = jax.jit(lambda p: ex.rms_spot(p, rays, materials, J64))
    g = jax.jit(jax.grad(spot))

    # one spot and gradient off the nominal
    t_spot = populations.tolerancing_problem(n_rays, F64, "cpu")
    probe = np.asarray([0.07, 0.09, 0.01])
    value, grad = populations._gradient(t_spot, torch.tensor(probe,
                                                             dtype=F64))
    close(value, spot(jnp.asarray(probe)))
    close(grad, g(jnp.asarray(probe)))

    # the example's flow: 400 design steps, sensitivities, Monte-Carlo
    params = jnp.asarray(populations.TOL_START, J64)
    mask = jnp.asarray([1.0, 1.0, 0.0], J64)
    for _ in range(populations.TOL_DESIGN_STEPS):
        params = params - 2e-3 * mask * g(params)
    sigmas = jnp.asarray([0.002 * float(params[0]),
                          0.002 * float(params[1]), 0.02], J64)
    normals = jax.random.normal(jax.random.PRNGKey(0), (samples, 3), J64)
    j_spots = np.asarray(jax.jit(jax.vmap(spot))(params + normals * sigmas))

    out = populations.tolerancing(samples, n_rays, normals=np.array(normals),
                                  dtype=F64, device="cpu", verbose=False)
    close(out["params"], params)
    close(out["nominal"], spot(params))
    close(out["sensitivities"], g(params), atol=1e-12)
    close(out["spots"], j_spots)
    assert out["yield"] == float(np.mean(j_spots <= 4.0 * float(
        spot(params)) + 0.01)) > 0.5


def test_tolerancing_draws_its_own_normals():
    """Without JAX's draws the Monte-Carlo draws from a seeded generator:
    the same generator state gives the same spots."""
    runs = [populations.tolerancing(
        16, 16, generator=torch.Generator().manual_seed(3), design_steps=3,
        dtype=F64, device="cpu", verbose=False)["spots"] for _ in range(2)]
    np.testing.assert_array_equal(*runs)
