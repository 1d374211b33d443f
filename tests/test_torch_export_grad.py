"""``utils/export.py``'s gradient program on the CPU: the file round trip
of tests/test_export.py.

``export.value_and_grad`` of the test's landing loss is exported as a joint
program, saved to a file, loaded and run: its value and gradient equal the
live ones bit for bit, and the live ones equal ``jax.value_and_grad`` of
the JAX package's loss on the same scene and rays in float64 within rtol
1e-12.  The loaded program checks its input's shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu_torch import TraceConfig, config, trace
from tensorflowraytrace_tpu_torch.utils import export as ex
from torch_export_common import F64, RTOL, jax_case, port_case
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def test_export_fn_file_round_trip(tmp_path):
    """A gradient program (the value and gradient of a landing loss)
    through the file path."""
    scene, rays, materials = port_case()
    cfg = TraceConfig(max_bounces=3)

    def loss(shift):
        r = dataclasses.replace(rays, p1=rays.p1 + shift)
        res = trace(r, scene, materials, cfg)
        fin = res.rays.state == 1
        return torch.sum(torch.where(fin, res.rays.p1[:, 1] ** 2, 0.0))

    vag = ex.value_and_grad(loss)
    path = str(tmp_path / "step.pt2")
    shift = torch.tensor([0.0, 0.1], dtype=F64)
    ex.save_exported(path, vag, shift)
    served = ex.load_exported(path)

    l_live, g_live = vag(shift)
    l_srv, g_srv = served(shift)
    assert torch.equal(l_live, l_srv) and torch.equal(g_live, g_srv)

    j_scene, j_rays, j_materials = jax_case()

    def j_loss(s):
        r = dataclasses.replace(j_rays, p1=j_rays.p1 + s)
        res = j_trace(r, j_scene, j_materials, JTraceConfig(max_bounces=3))
        fin = res.rays.state == 1
        return jnp.sum(jnp.where(fin, res.rays.p1[:, 1] ** 2, 0.0))

    l_jax, g_jax = jax.value_and_grad(j_loss)(jnp.asarray([0.0, 0.1]))
    np.testing.assert_allclose(float(l_live), float(l_jax), rtol=RTOL)
    np.testing.assert_allclose(g_live.numpy(), np.asarray(g_jax), rtol=RTOL)
    with pytest.raises(ValueError, match="exported for"):
        served(torch.zeros(3, dtype=F64))
