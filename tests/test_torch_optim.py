"""Parity of the PyTorch port's optimizers and mesh tools with the JAX
package, on the CPU.

* The mesh's vertex-graph tools (update map, accumulator, smoother) are
  NumPy copies: equal to the JAX package's outputs exactly.
* ``Optimizer`` and ``CanyonOptimizer`` against the JAX package's on a small
  analytic loss in float64, 5 steps or more: per-step errors and final
  parameters within rtol 1e-12.  The two evaluate the same float64
  expressions in the same order; what is left is the summation order of the
  accumulator and smoother products (XLA's dot against PyTorch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import optim as j_optim
from tensorflowraytrace_tpu.models import mesh as j_mesh
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch import optim as t_optim
from tensorflowraytrace_tpu_torch.models import mesh as t_mesh
from tensorflowraytrace_tpu_torch.utils.convert import optimizer_state_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

RTOL, ATOL = 1e-12, 1e-14


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


# ----------------------------------------------------------------------
# mesh tools
# ----------------------------------------------------------------------

def meshes():
    return t_mesh.hexagonal_mesh(1.2, 3), j_mesh.hexagonal_mesh(1.2, 3)


def test_graph_helpers_match_jax():
    t, j = meshes()
    np.testing.assert_array_equal(t.unique_edges(), j.unique_edges())
    assert t.vertex_neighbors() == j.vertex_neighbors()
    top = t_mesh.get_closest_point(t, (0.3, -0.2, 0.0))
    assert top == j_mesh.get_closest_point(j, (0.3, -0.2, 0.0)) != 0
    assert t_mesh.find_generations(t, top) == j_mesh.find_generations(j, top)
    links = [{1, 2}, set(), {0}]
    np.testing.assert_array_equal(t_mesh.connections_to_array(links),
                                  j_mesh.connections_to_array(links))
    np.testing.assert_array_equal(t_mesh.gaussian_weights(1.5, 5),
                                  j_mesh.gaussian_weights(1.5, 5))


@pytest.mark.parametrize("active", [None, list(range(0, 37, 2))])
def test_parametrization_and_smoothing_match_jax(active):
    t, j = meshes()
    top = t_mesh.get_closest_point(t, (0, 0, 0))
    assert top == j_mesh.get_closest_point(j, (0, 0, 0))
    t_map, t_acc = t_mesh.mesh_parametrization_tools(t, top, active)
    j_map, j_acc = j_mesh.mesh_parametrization_tools(j, top, active)
    np.testing.assert_array_equal(t_map, j_map)
    np.testing.assert_array_equal(t_acc, j_acc)
    weights = [300, 50, 20, 10, 5]
    np.testing.assert_array_equal(t_mesh.mesh_smoothing_tool(t, weights, active),
                                  j_mesh.mesh_smoothing_tool(j, weights, active))


# ----------------------------------------------------------------------
# Optimizer
# ----------------------------------------------------------------------

N_PARAM = 7  # hexagonal_mesh(1.2, 1): one ring


def mesh_matrices():
    mesh = t_mesh.hexagonal_mesh(1.2, 1)
    _, acc = t_mesh.mesh_parametrization_tools(mesh, 0)
    return acc, t_mesh.mesh_smoothing_tool(mesh, [3.0, 2.0])


def make_loss(lib, rng_seed=5, nan_grad=False):
    """A small nonlinear loss of two 7-vectors, written once for jnp and
    once for torch.  ``nan_grad`` adds a term whose value is 0 but whose
    gradient is NaN at negative entries of ``b``."""
    rng = np.random.default_rng(rng_seed)
    target = rng.normal(0, 1, N_PARAM)
    weight = rng.uniform(0.5, 2.0, N_PARAM)
    if lib is jnp:
        target, weight = jnp.asarray(target), jnp.asarray(weight)
        where, sqrt = jnp.where, jnp.sqrt
    else:
        target, weight = torch.as_tensor(target), torch.as_tensor(weight)
        where, sqrt = torch.where, torch.sqrt

    def loss(params):
        a, b = params
        val = (lib.sum(weight * (a - target) ** 2 * (1.0 + 0.1 * a ** 2))
               + lib.sum(b ** 4) + lib.sum(a * b))
        if nan_grad:
            val = val + lib.sum(where(b > 100.0, sqrt(b), 0.0 * b))
        return val

    return loss


def initial(seed=9):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, N_PARAM), rng.normal(0, 1, N_PARAM)]


def close(t_params, j_params):
    for t, j in zip(t_params, j_params):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def routines():
    acc, smoother = mesh_matrices()
    return {
        "common_clip": (dict(learning_rate=0.3, grad_clip=0.05), [
            {"steps": 5, "learning_rate": 1.0, "momentum": 0.0}]),
        "individual_clip": (dict(learning_rate=0.3, clip_mode="individual",
                                 clip_scale=0.4, individual_lr=[1.0, 0.5]), [
            {"steps": 5, "learning_rate": (1.0, 0.2), "momentum": 0.5}]),
        "accumulator_smoother_ramp": (dict(learning_rate=0.05, grad_clip=0.2), [
            {"steps": 2, "learning_rate": 1.0, "momentum": 0.8,
             "accumulators": [acc] * 2, "smoothers": [smoother] * 2},
            {"steps": 3, "learning_rate": (0.8, 0.3), "momentum": 0.9,
             "accumulators": [acc, None], "smoothers": [None, smoother]}]),
    }


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("name", ["common_clip", "individual_clip",
                                  "accumulator_smoother_ramp", "nan_grad"])
def test_training_routine_matches_jax(name, chain):
    nan_grad = name == "nan_grad"
    kwargs, routine = routines()["common_clip" if nan_grad else name]
    p0 = initial()
    if nan_grad:
        p0[1][:3] = -np.abs(p0[1][:3])  # NaN gradients on these entries
    j_opt = j_optim.Optimizer(make_loss(jnp, nan_grad=nan_grad),
                              [jnp.asarray(p) for p in p0], pass_key=False,
                              **kwargs)
    j_err = j_opt.training_routine(routine, report_frequency=0,
                                   show_time=False)
    t_opt = t_optim.Optimizer(make_loss(torch, nan_grad=nan_grad), p0,
                              pass_key=False, **kwargs)
    t_err = t_opt.training_routine(routine, report_frequency=0,
                                   show_time=False, chain=chain)
    assert len(t_err) == len(j_err) == 5
    np.testing.assert_allclose(t_err, j_err, rtol=RTOL)
    close(t_opt.parameters, j_opt.parameters)
    if nan_grad:
        assert all(torch.isfinite(p).all() for p in t_opt.parameters)


def test_single_step_and_state_transfer_match_jax():
    """Two JAX steps, then the JAX state carried into the port's optimizer,
    then three more steps on each side with momentum and an accumulator."""
    acc, smoother = mesh_matrices()
    j_opt = j_optim.Optimizer(make_loss(jnp), [jnp.asarray(p) for p in initial()],
                              learning_rate=0.05, momentum=0.9, pass_key=False)
    for _ in range(2):
        j_opt.single_step([acc] * 2, smoothers=[smoother] * 2)
    t_opt = t_optim.Optimizer(make_loss(torch), initial(), learning_rate=0.05,
                              momentum=0.9, pass_key=False)
    optimizer_state_from_numpy(t_opt, [np.asarray(p) for p in j_opt.parameters],
                               [np.asarray(v) for v in j_opt._velocity])
    for lr in (1.0, 0.7, 0.4):
        j_err = j_opt.single_step([acc] * 2, lr_scale=lr, smoothers=[smoother] * 2)
        t_err = t_opt.single_step([acc] * 2, lr_scale=lr, smoothers=[smoother] * 2)
        np.testing.assert_allclose(t_err, j_err, rtol=RTOL)
    close(t_opt.parameters, j_opt.parameters)
    close(t_opt._velocity, j_opt._velocity)
    unsynced = t_opt.single_step(sync=False)
    assert isinstance(unsynced, torch.Tensor) and unsynced.dim() == 0


def test_pass_key_hands_the_generator_to_the_loss():
    seen = []

    def loss(params, generator):
        seen.append(generator)
        noise = torch.rand(N_PARAM, generator=generator, dtype=torch.float64)
        return torch.sum((params[0] - noise) ** 2)

    gen = torch.Generator().manual_seed(3)
    opt = t_optim.Optimizer(loss, [np.zeros(N_PARAM)], learning_rate=0.1,
                            generator=gen)
    errors = opt.run_phase(3)
    assert errors.shape == (3,) and seen == [gen] * 3
    # fresh draws every step: the three losses differ
    assert len(set(errors.tolist())) == 3


def test_smooth_matches_jax():
    _, smoother = mesh_matrices()
    p = initial()[0]
    np.testing.assert_allclose(
        t_optim.Optimizer.smooth(torch.as_tensor(p), smoother).numpy(),
        np.asarray(j_optim.Optimizer.smooth(jnp.asarray(p), smoother)),
        rtol=RTOL)


def test_unported_options_raise():
    # mesh= is ported (tests/test_torch_sharding.py); as in the JAX package
    # it needs pass_key=True
    with pytest.raises(ValueError, match="pass_key"):
        t_optim.Optimizer(make_loss(torch), initial(), mesh=object(),
                          pass_key=False)
    # optax_tx= is ported (tests/test_torch_optax.py): a torch optimizer
    # factory builds an optimizer
    opt = t_optim.Optimizer(make_loss(torch), initial(), pass_key=False,
                            optax_tx=lambda ps: torch.optim.SGD(ps, lr=0.1))
    assert isinstance(opt._tx, torch.optim.SGD)
    with pytest.raises(ValueError):
        t_optim.Optimizer(make_loss(torch), initial(), clip_mode="other")


# ----------------------------------------------------------------------
# CanyonOptimizer
# ----------------------------------------------------------------------

def test_canyon_optimizer_matches_jax():
    """Enough steps at a growing step size that some regress and are
    undone; both packages undo the same steps."""
    kw = dict(base_step_size=0.08, momentum=0.9, growth_factor=1.4,
              shrink_factor=0.5, pass_key=False)
    j_opt = j_optim.CanyonOptimizer(make_loss(jnp),
                                    [jnp.asarray(p) for p in initial()], **kw)
    t_opt = t_optim.CanyonOptimizer(make_loss(torch), initial(), **kw)
    j_err, t_err = j_opt.run(12), t_opt.run(12)
    np.testing.assert_allclose(t_err, j_err, rtol=RTOL)
    close(t_opt.parameters, j_opt.parameters)
    assert t_opt.step_size == j_opt.step_size
    undone = [i for i in range(1, 12) if t_err[i] == t_err[i - 1]]
    assert undone, "no step regressed; the undo path was not exercised"
