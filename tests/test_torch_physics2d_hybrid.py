"""``physics2d.hybrid_achromat`` against examples/hybrid_achromat.py on
the CPU in float64 (the other 2D reaction examples: tests/
test_torch_physics2d.py and test_torch_physics2d_designs.py).

The example's ``make_rays`` and ``trace_landings`` against the port's
problem on the same parameters, with and without the metasurface, and
the first Adam steps of its ``optimize`` (optax) against
``hybrid_design`` (``torch.optim.Adam`` through ``Optimizer(optax_tx=)``),
within rtol 1e-9; then the
whole example at its CI size (260 steps, 9 heights) with its check, its
spots held to those the example prints.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
# hybrid_achromat
# ----------------------------------------------------------------------

@pytest.mark.parametrize("use_meta", [False, True])
def test_hybrid_steps_match_jax(use_meta):
    ex = load("hybrid_achromat")
    j_rays, j_wl = ex.make_rays(5, J64)
    landings, rays = physics2d.hybrid_problem(5, F64, "cpu")
    close(rays.p0, j_rays.p0)
    close(rays.wavelength, j_wl)
    q0 = jnp.asarray([1.0 / 13.0, 0.3, -0.2], J64)
    j_y, _ = ex.trace_landings((q0[0], q0[1] * 1e-4, q0[2] * 1e-4), j_rays,
                               J64, use_meta=use_meta)
    y, _ = landings(physics2d.hybrid_params(t64(q0)), use_meta=use_meta)
    close(y, j_y)
    j_q = ex.optimize(j_rays, J64, use_meta, 4, q0=q0)
    opt = physics2d.hybrid_design(landings, use_meta, t64(q0), F64, "cpu")
    opt.run_phase(4)
    close(opt.parameters[0], j_q)


def test_hybrid_achromat_runs():
    out = physics2d.hybrid_achromat(260, 9, dtype=F64, device="cpu",
                                    verbose=False)
    assert out["gain"] > 2.0
    # the example's own run prints 0.0048 -> 0.0020
    assert (round(out["refractive_rms"], 4), round(out["hybrid_rms"], 4)) \
        == (0.0048, 0.0020)
