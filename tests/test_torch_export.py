"""``utils/export.py`` on the CPU: the forward cases of
tests/test_export.py (the gradient program: tests/test_torch_export_grad.py).

The trace is exported with ``torch.export``, saved, loaded and run: the
served result equals the port's live result bit for bit, and the port's
live result equals the JAX package's live one on the same scene and rays
in float64 (states exactly; end points within rtol 1e-12).  A program
called with another ray count raises; ``early_exit`` and another platform
are refused.
"""

import math

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu import trace as j_trace
from tensorflowraytrace_tpu_torch import RaySet, TraceConfig, config, trace
from tensorflowraytrace_tpu_torch.utils import export as ex
from torch_export_common import RTOL, jax_case, port_case
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def test_export_trace_round_trip():
    scene, rays, materials = port_case()
    cfg = TraceConfig(max_bounces=3)
    blob = ex.export_trace(scene, materials, cfg, rays)
    assert isinstance(blob, bytes) and len(blob) > 0

    live = trace(rays, scene, materials, cfg).rays
    served = ex.load_fn(blob)(rays)
    assert isinstance(served, RaySet)
    for a, b in ((live.state, served.state), (live.p0, served.p0),
                 (live.p1, served.p1), (live.wavelength, served.wavelength)):
        assert torch.equal(a, b)

    j_scene, j_rays, j_materials = jax_case()
    j_live = j_trace(j_rays, j_scene, j_materials,
                     JTraceConfig(max_bounces=3)).rays
    np.testing.assert_array_equal(live.state.numpy(), np.asarray(j_live.state))
    np.testing.assert_allclose(live.p1.numpy(), np.asarray(j_live.p1),
                               rtol=RTOL, atol=0)


def test_export_shape_mismatch_fails_loudly():
    """The artifact is shape-locked: the wrong ray count raises."""
    scene, rays, materials = port_case(16)
    blob = ex.export_trace(scene, materials, TraceConfig(max_bounces=2), rays)
    _, wrong, _ = port_case(8)
    with pytest.raises(Exception):
        ex.load_fn(blob)(wrong)


def test_export_refuses_what_it_cannot_export():
    scene, rays, materials = port_case(4)
    with pytest.raises(ValueError, match="early_exit"):
        ex.export_trace(scene, materials,
                        TraceConfig(max_bounces=2, early_exit=True), rays)
    with pytest.raises(NotImplementedError, match="own device"):
        ex.export_trace(scene, materials, TraceConfig(max_bounces=2), rays,
                        platforms=("cuda",))
    assert math.isfinite(float(trace(rays, scene, materials,
                                      TraceConfig(max_bounces=1)).rays.p1.sum()))
