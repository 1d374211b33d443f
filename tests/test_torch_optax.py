"""``Optimizer(optax_tx=...)`` against the JAX package's optax path, on the
CPU in float64: the port's factory ``params -> torch.optim.Optimizer`` (or
``(optimizer, scheduler)``) against the JAX package's optax transform.

* ``torch.optim.SGD`` against ``optax.sgd``, ``torch.optim.Adam`` against
  ``optax.adam`` and Adam under a cosine ``LambdaLR`` against
  ``optax.adam(optax.cosine_decay_schedule(...))``: per-step errors and
  final parameters within rtol 1e-12 over 5 steps, with the common clip
  engaged, the individual clip under an lr ramp and individual rates, and
  accumulators and smoothers; a phase at lr_scale 0 leaves the parameters
  as they were.
* ``run_phase`` equals the same steps taken one by one, bit for bit.
* On a one-rank gloo group, ``Optimizer(mesh=...)`` with Adam equals the
  single process bit for bit and JAX within rtol 1e-12.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from test_torch_optim import close, initial, make_loss, mesh_matrices, routines
from tensorflowraytrace_tpu import optim as j_optim
from tensorflowraytrace_tpu_torch import config, streamed
from tensorflowraytrace_tpu_torch import optim as t_optim
from tensorflowraytrace_tpu_torch.parallel import sharding as t_par
from tensorflowraytrace_tpu_torch.scenes2d import cosine_decay
from tensorflowraytrace_tpu_torch.utils.convert import (
    optimizer_state_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

RTOL = 1e-12
STEPS = 5


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def transforms(name):
    """The JAX transform and the port's factory of one optimizer."""
    if name == "sgd":
        return optax.sgd(0.2), functools.partial(torch.optim.SGD, lr=0.2)
    if name == "adam":
        return optax.adam(0.1), functools.partial(torch.optim.Adam, lr=0.1)
    schedule = optax.cosine_decay_schedule(0.1, STEPS, alpha=0.1)
    return optax.adam(schedule), cosine_decay(0.1, STEPS, 0.1)


def pair(name, kwargs, pass_key=False):
    j_tx, t_tx = transforms(name)
    p0 = initial()
    j_opt = j_optim.Optimizer(make_loss(jnp), [jnp.asarray(p) for p in p0],
                              pass_key=pass_key, optax_tx=j_tx, **kwargs)
    t_opt = t_optim.Optimizer(make_loss(torch), p0, pass_key=pass_key,
                              optax_tx=t_tx, **kwargs)
    return j_opt, t_opt


CASES = [("sgd", "common_clip"), ("adam", "individual_clip"),
         ("adam_cosine", "accumulator_smoother_ramp"),
         ("adam", "zero_then_common")]


@pytest.mark.parametrize("tx,routine", CASES)
def test_optax_routine_matches_jax(tx, routine):
    if routine == "zero_then_common":
        kwargs, phases = routines()["common_clip"]
        phases = [{"steps": 1, "learning_rate": 0.0}, {"steps": STEPS - 1,
                                                       "learning_rate": 1.0}]
    else:
        kwargs, phases = routines()[routine]
    j_opt, t_opt = pair(tx, kwargs)
    j_err = j_opt.training_routine(phases, report_frequency=0,
                                   show_time=False)
    t_err = t_opt.training_routine(phases, report_frequency=0,
                                   show_time=False)
    assert len(t_err) == len(j_err) == STEPS
    np.testing.assert_allclose(t_err, j_err, rtol=RTOL)
    close(t_opt.parameters, j_opt.parameters)
    assert not np.allclose(t_opt.parameters[0].numpy(), initial()[0])
    if routine == "zero_then_common":
        assert t_err[1] == t_err[0]  # the lr_scale-0 step moved nothing


def test_clip_engages_on_the_raw_gradient():
    """With the common clip the raw gradient is clipped at grad_clip / s:
    the same run without a clip ends elsewhere (in both packages alike)."""
    kwargs, phases = routines()["common_clip"]
    clipped = pair("sgd", kwargs)[1]
    free = pair("sgd", dict(kwargs, grad_clip=math.inf))[1]
    for opt in (clipped, free):
        opt.run_phase(STEPS)
    assert not np.allclose(clipped.parameters[0].numpy(),
                           free.parameters[0].numpy())


def test_run_phase_equals_single_steps():
    acc, smoother = mesh_matrices()
    opts = [pair("adam_cosine", dict(learning_rate=0.3, grad_clip=0.2))[1]
            for _ in range(2)]
    a = opts[0].run_phase(STEPS, [acc] * 2, lr_scale=(1.0, 0.4),
                          smoothers=[smoother] * 2)
    b = [opts[1].single_step([acc] * 2, lr_scale=s, smoothers=[smoother] * 2)
         for s in np.linspace(1.0, 0.4, STEPS)]
    np.testing.assert_array_equal(a, b)
    for p, q in zip(*(o.parameters for o in opts)):
        assert torch.equal(p, q)


def test_optax_tx_rejects_other_factories_and_state_loads():
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        t_optim.Optimizer(make_loss(torch), initial(), pass_key=False,
                          optax_tx=lambda ps: None)
    opt = pair("adam", {})[1]
    with pytest.raises(ValueError, match="optax_tx"):
        optimizer_state_from_numpy(opt, initial(), initial())


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process."""
    t_par.init_multihost("gloo", init_method="tcp://localhost:"
                         f"{streamed.free_port()}", world_size=1, rank=0)
    try:
        yield t_par.ray_mesh()
    finally:
        dist.destroy_process_group()


def test_optax_mesh_step_matches_single_process_and_jax(one_rank_group):
    kwargs, phases = routines()["individual_clip"]
    j_opt, single = pair("adam", kwargs)
    loss = make_loss(torch)
    meshed = t_optim.Optimizer(lambda params, generator: loss(params),
                               initial(), mesh=one_rank_group,
                               optax_tx=transforms("adam")[1], **kwargs)
    j_err = j_opt.training_routine(phases, report_frequency=0,
                                   show_time=False)
    s_err = single.training_routine(phases, report_frequency=0,
                                    show_time=False)
    m_err = meshed.training_routine(phases, report_frequency=0,
                                    show_time=False)
    assert m_err == s_err
    for p, q in zip(meshed.parameters, single.parameters):
        assert torch.equal(p, q)
    np.testing.assert_allclose(m_err, j_err, rtol=RTOL)
    close(meshed.parameters, j_opt.parameters)
