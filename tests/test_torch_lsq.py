"""The port's damped least squares (``lsq.lm_solve``) against the JAX
package's on the CPU in float64, iteration by iteration: the cases of
tests/test_lsq.py (linear least squares, Marquardt scaling, an insensitive
variable, Rosenbrock, tree parameters and residuals, extra arguments) and
a singular system, which ``torch.linalg.solve`` would raise on and both
solves reject.  ``cost_history`` within rtol 1e-9 (atol 1e-20),
``accepted`` exactly, the parameters, cost, damping and gradient norm
within rtol 1e-9 (atol 1e-12).  The best-form singlet is in
tests/test_torch_best_form.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import lsq as jl
from tensorflowraytrace_tpu_torch import config, lsq as tl
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F64 = torch.float64
RTOL = 1e-9

_RNG = np.random.default_rng(42)
A_LIN, B_LIN = _RNG.normal(size=(12, 3)), _RNG.normal(size=(12,))
SCALES = np.asarray([1.0, 1e-6])


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def t64(a):
    return torch.as_tensor(np.asarray(a, float))


# name: (JAX residual, port residual, start (numpy tree), extra args
# (numpy), keyword arguments)
CASES = {
    "linear": (lambda x: jnp.asarray(A_LIN) @ x - jnp.asarray(B_LIN),
               lambda x: t64(A_LIN) @ x - t64(B_LIN),
               np.zeros(3), (), {"steps": 6}),
    "marquardt_scaling": (
        lambda x: jnp.asarray(SCALES) * x - 1.0,
        lambda x: t64(SCALES) * x - 1.0,
        np.zeros(2), (), {"steps": 10, "marquardt": True}),
    "insensitive": (lambda x: jnp.atleast_1d(x[0] - 2.0),
                    lambda x: torch.atleast_1d(x[0] - 2.0),
                    np.zeros(2), (), {"steps": 8}),
    "rosenbrock": (
        lambda x: jnp.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)]),
        lambda x: torch.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)]),
        np.asarray([-1.2, 1.0]), (), {"steps": 60}),
    "tree": (
        lambda p: {"a": p["a"] - jnp.asarray([1.0, 2.0]),
                   "b": jnp.atleast_1d(p["b"] - 3.0)},
        lambda p: {"a": p["a"] - t64([1.0, 2.0]),
                   "b": torch.atleast_1d(p["b"] - 3.0)},
        {"b": np.asarray(0.0), "a": np.zeros(2)}, (), {"steps": 6}),
    "extra_args": (lambda x, a, b: a * x - b, lambda x, a, b: a * x - b,
                   np.zeros(2), (np.asarray([2.0, 4.0]),
                                 np.asarray([2.0, 8.0])), {"steps": 6}),
    # Levenberg without damping on a zero Jacobian column: J^T J is
    # singular at every iteration, so every step is rejected
    "singular": (lambda x: jnp.atleast_1d(x[0] - 2.0),
                 lambda x: torch.atleast_1d(x[0] - 2.0),
                 np.zeros(2), (), {"steps": 4, "marquardt": False,
                                   "init_damping": 0.0,
                                   "min_damping": 0.0}),
}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def close(t, j, what):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            close(t[k], j[k], f"{what}[{k}]")
        return
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL,
                               atol=1e-12, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lm_solve_matches_jax(name):
    j_fn, t_fn, start, args, kw = CASES[name]
    rj = jl.lm_solve(j_fn, tree_map(jnp.asarray, start),
                     *(jnp.asarray(a) for a in args), **kw)
    rt = tl.lm_solve(t_fn, tree_map(t64, start), *(t64(a) for a in args),
                     **kw)
    np.testing.assert_array_equal(rt.accepted.numpy(),
                                  np.asarray(rj.accepted))
    np.testing.assert_allclose(rt.cost_history.numpy(),
                               np.asarray(rj.cost_history), rtol=RTOL,
                               atol=1e-20)
    close(rt.params, rj.params, "params")
    for f in ("cost", "residual", "damping", "grad_norm"):
        close(getattr(rt, f), getattr(rj, f), f)
    assert rt.cost_history.shape == (kw["steps"],)
    if name == "singular":
        assert not rt.accepted.any()
    else:
        assert rt.accepted.any()


def test_singular_system_would_raise_in_torch_solve():
    """The normal matrix of the singular case: ``torch.linalg.solve``
    raises on it, where the JAX package's Cholesky solve returns NaN."""
    jm = torch.tensor([[1.0, 0.0]], dtype=F64)
    with pytest.raises(RuntimeError):
        torch.linalg.solve(jm.T @ jm, torch.ones(2, dtype=F64))
    _, info = torch.linalg.cholesky_ex(jm.T @ jm)
    assert int(info) != 0


def test_ravel_round_trip():
    """Trees flatten with dict keys sorted (as ``ravel_pytree``) and come
    back in their shapes and dtypes."""
    tree = {"b": (torch.ones(2, 2), torch.tensor(3.0, dtype=F64)),
            "a": [torch.arange(3, dtype=F64)]}
    flat, unravel = tl.ravel(tree)
    np.testing.assert_array_equal(flat.numpy(), [0, 1, 2, 1, 1, 1, 1, 3])
    back = unravel(flat)
    assert back["b"][0].shape == (2, 2) and back["b"][0].dtype == torch.float32
    assert back["b"][1].dtype == F64 and isinstance(back["a"], list)
    assert float(back["b"][1]) == 3.0
