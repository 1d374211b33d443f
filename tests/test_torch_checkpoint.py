"""Checkpoint and resume (``utils/checkpoint.py``) on the CPU, and a JAX
run resumed in the port (``utils/convert.checkpoint_state_from_numpy``).

* The built-in Nesterov stage and ``optax_tx=`` (Adam under a
  ``LambdaLR``) round trips through one ``torch.save`` file: the restored
  parameters, momentum, torch optimizer and scheduler state, generator
  state and iteration count equal the saved ones bit for bit, and the
  resumed steps equal the uninterrupted ones bit for bit; the JAX
  package's own round trip on the same quadratic gives the same errors
  (rtol 1e-12).
* ``facade.stepwise_optimize`` (examples/stepwise_optimize.py: the single
  arc, checkpointed every 10 steps, rebuilt, resumed) ends EXACT, with the
  built-in stage in float64 and with Adam in float32.
* A loss that draws from the optimizer's generator resumes on the same
  draws even after the global RNG has moved: the checkpoint restores the
  ``torch.Generator`` itself.
* A JAX single-arc run's ``checkpoint.state_dict`` resumed in the port:
  the next step's loss within 1e-12 of the JAX run's next step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import FINISHED as J_FINISHED
from tensorflowraytrace_tpu import ArcSet as JArcSet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu.models import distributions as j_dist
from tensorflowraytrace_tpu.models import sources as j_src
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.optim import Optimizer as JOptimizer
from tensorflowraytrace_tpu.utils import checkpoint as j_ckpt
from tensorflowraytrace_tpu_torch import config, facade, scenes2d
from tensorflowraytrace_tpu_torch.optim import Optimizer
from tensorflowraytrace_tpu_torch.utils import checkpoint as ckpt
from tensorflowraytrace_tpu_torch.utils.convert import (
    checkpoint_state_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

PI = math.pi
F64 = torch.float64


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def quadratic_loss(params, generator):
    return (torch.sum((params[0] - 3.0) ** 2)
            + torch.sum((params[1] + 1.0) ** 2))


def j_quadratic_loss(params, key):
    return jnp.sum((params[0] - 3.0) ** 2) + jnp.sum((params[1] + 1.0) ** 2)


def quadratic(fill, **kw):
    return Optimizer(quadratic_loss, [torch.full((4,), fill, dtype=F64),
                                      torch.full((2,), fill, dtype=F64)],
                     learning_rate=0.1, **kw)


def test_checkpoint_roundtrip(tmp_path):
    """The built-in stage: save after 5 steps, load into an optimizer
    built elsewhere, and both continue alike; the JAX package's round
    trip gives the same errors."""
    opt = quadratic(0.0)
    for _ in range(5):
        opt.single_step(None, momentum=0.5)
    path = str(tmp_path / "ckpt")
    assert ckpt.save_checkpoint(path, opt) == path
    saved = ckpt.state_dict(opt)

    opt2 = quadratic(1.0)
    ckpt.load_checkpoint(path, opt2)
    assert facade.states_equal(ckpt.state_dict(opt2), saved)
    assert opt2.iterations == opt.iterations == 5
    e1 = opt.single_step(None, momentum=0.5)
    e2 = opt2.single_step(None, momentum=0.5)
    assert e1 == e2
    for a, b in zip(opt.parameters, opt2.parameters):
        assert torch.equal(a, b)

    j_opt = JOptimizer(j_quadratic_loss, [jnp.zeros(4, jnp.float64),
                                          jnp.zeros(2, jnp.float64)],
                       learning_rate=0.1)
    for _ in range(5):
        j_opt.single_step(None, momentum=0.5)
    j_ckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), j_opt)
    j_opt2 = JOptimizer(j_quadratic_loss, [jnp.ones(4, jnp.float64),
                                           jnp.ones(2, jnp.float64)],
                        learning_rate=0.1)
    j_ckpt.load_checkpoint(str(tmp_path / "jax_ckpt"), j_opt2)
    np.testing.assert_allclose(e2, j_opt2.single_step(None, momentum=0.5),
                               rtol=1e-12)
    for a, b in zip(opt2.parameters, j_opt2.parameters):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_optax_checkpoint_roundtrip(tmp_path):
    """Adam under a LambdaLR: the torch optimizer's and the scheduler's
    state come back, and the resumed run continues bit for bit; the
    parameters are copied into the tensors Adam steps."""
    opt = quadratic(0.0, optax_tx=facade.adam_lambda(0.1, 0.9))
    for _ in range(5):
        opt.single_step(None)
    path = str(tmp_path / "ckpt_optax")
    ckpt.save_checkpoint(path, opt)
    saved = ckpt.state_dict(opt)

    opt2 = quadratic(1.0, optax_tx=facade.adam_lambda(0.1, 0.9))
    held = list(opt2.parameters)
    ckpt.load_checkpoint(path, opt2)
    assert all(a is b for a, b in zip(held, opt2.parameters))
    assert facade.states_equal(ckpt.state_dict(opt2), saved)
    assert opt2._scheduler.last_epoch == opt._scheduler.last_epoch == 5
    for _ in range(3):
        assert opt.single_step(None) == opt2.single_step(None)
    for a, b in zip(opt.parameters, opt2.parameters):
        assert torch.equal(a, b)

    # a checkpoint goes only into an optimizer built alike
    with pytest.raises(ValueError, match="optax_tx"):
        ckpt.load_checkpoint(path, quadratic(0.0))
    plain = str(tmp_path / "ckpt_plain")
    ckpt.save_checkpoint(plain, quadratic(0.0))
    with pytest.raises(ValueError, match="optax_tx"):
        ckpt.load_checkpoint(plain, quadratic(
            0.0, optax_tx=facade.adam_lambda()))


def test_checkpoint_file_loads_with_weights_only(tmp_path):
    """The file holds only what torch.load(weights_only=True) reads."""
    opt = quadratic(0.0, optax_tx=facade.adam_lambda())
    opt.single_step(None)
    path = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(path, opt)
    state = torch.load(path, weights_only=True)
    assert set(state) == {"parameters", "velocity", "generator",
                          "iterations", "tx", "scheduler"}


@pytest.mark.parametrize("dtype, optax", [(torch.float64, False),
                                          (torch.float32, True)])
def test_stepwise_resume_is_exact(tmp_path, dtype, optax):
    """examples/stepwise_optimize.py through the port: the restored state
    equals the saved one bit for bit, the first resumed step's loss equals
    the uninterrupted run's, and the final radius drifts by nothing."""
    out = facade.stepwise_optimize(
        str(tmp_path / "stepwise"), dtype=dtype, device="cpu",
        optax_tx=facade.adam_lambda() if optax else None)
    assert facade.states_equal(out["restored"], out["saved"])
    at = out["saved"]["iterations"]
    assert at == 20
    assert out["resumed_errors"][0] == out["errors"][at]
    assert out["resumed_errors"] == out["errors"][at:]
    assert out["drift"] == 0.0
    assert abs(out["param"] - 5.0) > 0.1
    assert out["errors"][-1] < 0.1 * out["errors"][0]


def test_generator_restored_though_the_global_rng_moved(tmp_path):
    """A loss that samples from the optimizer's generator: after a resume
    it draws what the uninterrupted run drew, though the global RNG was
    reseeded and drawn from in between."""
    def noisy_loss(params, generator):
        noise = torch.rand((3,), generator=generator, dtype=F64)
        return torch.sum((params[0] - noise) ** 2)

    def make():
        return Optimizer(noisy_loss, [torch.zeros(3, dtype=F64)],
                         learning_rate=0.1,
                         generator=torch.Generator().manual_seed(7))

    opt = make()
    for _ in range(4):
        opt.single_step(None, momentum=0.5)
    path = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(path, opt)
    saved = opt.generator.get_state()
    want = [opt.single_step(None, momentum=0.5) for _ in range(3)]

    torch.manual_seed(12345)
    torch.rand(100)
    resumed = make()
    resumed.single_step(None, momentum=0.5)  # moves its own generator too
    ckpt.load_checkpoint(path, resumed)
    assert torch.equal(resumed.generator.get_state(), saved)
    got = [resumed.single_step(None, momentum=0.5) for _ in range(3)]
    assert got == want
    assert torch.equal(resumed.generator.get_state(), opt.generator.get_state())


def jax_single_arc():
    """examples/stepwise_optimize.py's problem in the JAX package, float64:
    ``(loss, rays)``."""
    beam = j_dist.StaticUniformBeam(-1.5, 1.5, 10)
    angles = j_dist.StaticUniformAngularDistribution(0.0, 0.0, 1)
    source = j_src.AngularSource(2, (-1.0, 0.0), 0.0, angles, beam,
                                 list(scenes2d.RAINBOW_6))
    rays0 = source.sample(dtype=jnp.float64)
    target = JSegmentSet.make([[10.0, -5.0]], [[10.0, 5.0]],
                              dtype=jnp.float64)
    cfg = JTraceConfig(max_bounces=2)

    def loss(params, key):
        p = params[0][0]
        arc = JArcSet.make(jnp.stack([jnp.stack([p, jnp.zeros_like(p)])]),
                           3 * PI / 4, 5 * PI / 4, p, mat_in=1, mat_out=0,
                           dtype=jnp.float64)
        scene = JScene2D.build(optical_arcs=[arc], target_segments=[target])
        res = j_trace(rays0, scene, (j_mats.vacuum, j_mats.acrylic), cfg)
        fin = res.rays.state == J_FINISHED
        return jnp.sum(jnp.where(fin, res.rays.p1[:, 1] ** 2, 0.0))

    return loss


def test_jax_checkpoint_resumes_in_the_port():
    """A JAX single-arc run's checkpoint state, converted, resumes in the
    port: the next step's loss within 1e-12 of the JAX run's next step,
    its iteration count and momentum carried; the generator starts from
    the seed given (a threefry key has no torch.Generator counterpart)."""
    j_opt = JOptimizer(jax_single_arc(), [jnp.asarray([5.0], jnp.float64)],
                       learning_rate=1.0, grad_clip=0.1,
                       key=jax.random.PRNGKey(3))
    for _ in range(6):
        j_opt.single_step(None, momentum=0.8)
    state = checkpoint_state_from_numpy(j_ckpt.state_dict(j_opt),
                                        generator_seed=3, device="cpu")

    arc_loss, params = scenes2d.single_arc(dtype=F64, device="cpu")
    opt = Optimizer(lambda p, generator: arc_loss(p), params,
                    learning_rate=1.0, grad_clip=0.1)
    ckpt.restore_into(opt, state)
    assert opt.iterations == 6
    assert torch.equal(opt.generator.get_state(),
                       torch.Generator().manual_seed(3).get_state())
    got = opt.single_step(None, momentum=0.8)
    want = j_opt.single_step(None, momentum=0.8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(opt.parameters[0][0]),
                               float(j_opt.parameters[0][0]), rtol=1e-12)

    with pytest.raises(ValueError, match="Nesterov"):
        checkpoint_state_from_numpy(
            {"parameters": [np.zeros(2)], "velocity": [np.zeros(()),
                                                       np.zeros(2)],
             "iterations": np.asarray(1)}, generator_seed=0, device="cpu")
