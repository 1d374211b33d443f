"""``populations.design_sweep`` against examples/design_sweep.py on the CPU
in float64 (``tolerancing``: tests/test_torch_populations.py).

The JAX example ``jax.vmap``s its trace over the candidates; the port
traces each candidate in turn.  Both sides run the example's flow at its
CI size in tests/test_examples.py's CASES (8 candidates, 5 steps, the
best 2; the JAX side through the example's ``build_problem``, in
float64): one loss and gradient, the swept losses, the refined population
and the final pool, within rtol 1e-9; the port's check passes.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_design_sweep_matches_jax():
    ex = load("design_sweep")
    population, steps, top_k = 8, 5, 2
    loss = ex.build_problem(dtype=J64)
    t_loss = populations.sweep_problem(128, F64, "cpu")
    value, grad = populations._gradient(t_loss, torch.tensor(4.1, dtype=F64))
    j_value, j_grad = jax.value_and_grad(loss)(jnp.asarray(4.1, J64))
    close(value, j_value)
    close(grad, j_grad)

    # the example's main in float64
    radii = jnp.linspace(2.0, 12.0, population)
    losses = jax.jit(jax.vmap(loss))(radii)
    order = jnp.argsort(losses)
    params = radii[order[:top_k]]
    velocity = jnp.zeros_like(params)

    @jax.jit
    def step(params, velocity):
        g = jax.vmap(jax.grad(loss))(params)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        g = jnp.clip(g, -0.1, 0.1)
        velocity = 0.8 * velocity + g
        return params - (g + 0.8 * velocity), velocity

    for _ in range(steps):
        params, velocity = step(params, velocity)
    pool = jnp.concatenate([params, radii[order[:1]]])
    final = jax.jit(jax.vmap(loss))(pool)

    out = populations.design_sweep(population, steps, top_k, dtype=F64,
                                   device="cpu", verbose=False)
    close(out["radii"], radii)
    close(out["losses"], losses)
    close(out["pool"], pool)
    close(out["final"], final)
    best = int(jnp.argmin(final))
    assert out["best_radius"] == float(out["pool"][best])
    assert out["best_loss"] <= out["coarse_loss"] + 1e-9
