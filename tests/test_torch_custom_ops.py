"""The kernels as ``tfrt_torch`` operators (``ops/custom_ops.py``) on the
CPU, where each runs its plain version.

* ``torch.library.opcheck`` of all ten operators and of the engine's
  gather (whose registered backward is K2's operator): the schema, the
  autograd registration, the fake implementation against the CPU one and
  the operator under AOT dispatch with dynamic shapes.
* ``engine.trace`` with ``use_kernel=True`` through the operators against
  the same trace with the wrappers replaced by their plain versions, bit
  for bit, in 2D (K5/K6, K7/K8, K9/K10) and 3D (K1, K3, K4), with the
  gradient through K2's operator against the plain segment sum.
* ``torch.func.grad_and_value`` of a landing loss through ``engine.trace``
  (the gather's ``setup_context`` form) against ``torch.autograd.grad``,
  bit for bit: the JAX package's ``trace`` goes through ``jax.grad``.

The operators' CUDA implementations run only on the card: chip_smoke.py
phase 21a runs ``opcheck`` there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.engine import TraceConfig, trace
from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import custom_ops
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk
from torch_export_common import scene_2d, scene_3d
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-6
F32 = torch.float32


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def op_inputs(kernel, rng):
    """Small float32 inputs of each operator: 300 rays against 600
    surfaces (three 256-chunks; two of K4's 512), some rays missing."""
    def t(a, dtype=F32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    n, m = 300, 600
    if kernel == "K2":
        return (t(rng.normal(size=(4, n))),
                t(rng.integers(0, 50, n), torch.int32), 50)
    if kernel in ("K1", "K3", "K4"):
        p0 = rng.uniform(-1, 1, (n, 3))
        p1 = p0 + rng.normal(size=(n, 3))
        vp = rng.uniform(-2, 2, (m, 3))
        return (t(p0), t(p1), t(vp), t(vp + rng.normal(0, 0.3, (m, 3))),
                t(vp + rng.normal(0, 0.3, (m, 3))), EPS, EPS, EPS)
    p0 = rng.uniform(-1, 1, (n, 2))
    p1 = p0 + rng.normal(size=(n, 2))
    if kernel in ("K5", "K7", "K9"):
        sp0 = rng.uniform(-3, 3, (m, 2))
        return (t(p0), t(p1), t(sp0), t(sp0 + rng.normal(0, 0.4, (m, 2))),
                EPS, EPS, EPS)
    a0 = rng.uniform(-np.pi, np.pi, m)
    return (t(p0), t(p1), t(rng.uniform(-3, 3, (m, 2))), t(a0),
            t(a0 + rng.uniform(0.1, 6.0, m)), t(rng.uniform(0.1, 0.5, m)),
            EPS, EPS)


@pytest.mark.parametrize("kernel", sorted(custom_ops.OPS,
                                          key=lambda k: int(k[1:])))
def test_opcheck(kernel):
    args = op_inputs(kernel, np.random.default_rng(int(kernel[1:])))
    torch.library.opcheck(custom_ops.OPS[kernel], args)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_opcheck_gather(use_kernel):
    """The engine's gather, whose registered backward is K2's operator
    under ``use_kernel``."""
    rng = np.random.default_rng(11)
    table = torch.as_tensor(rng.normal(size=(50, 7)), dtype=F32)
    idx = torch.as_tensor(rng.integers(0, 50, 300), dtype=torch.int32)
    torch.library.opcheck(custom_ops.gather_rows_t,
                          (table.requires_grad_(True), idx, use_kernel))


WRAPPERS = {
    tk: ("nearest_hit_triangles_kernel", "nearest_hit_triangles_culled_kernel",
         "nearest_hit_triangles_twolevel_kernel"),
    gk: ("nearest_hit_segments_kernel", "nearest_hit_segments_culled_kernel",
         "nearest_hit_segments_twolevel_kernel"),
    ak: ("nearest_hit_arcs_kernel", "nearest_hit_arcs_culled_kernel",
         "nearest_hit_arcs_twolevel_kernel"),
}


def plain_wrappers(monkeypatch):
    """Replace every wrapper by its plain version, bypassing the
    operators."""
    for mod, names in WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(mod, name,
                                getattr(mod, name.replace("_kernel", "_plain")))
    monkeypatch.setattr(sk, "segment_sum_kernel", sk.segment_sum_plain)


def landing_loss(shift, rays, scene, materials, cfg):
    moved = dataclasses.replace(rays, p1=rays.p1 + shift)
    res = trace(moved, scene, materials, cfg)
    landed = res.rays.state == 1
    return torch.sum(torch.where(landed, res.rays.p1[:, 1] ** 2, 0.0))


@pytest.mark.parametrize("make", [scene_2d, scene_3d], ids=["2d", "3d"])
@pytest.mark.parametrize("cull", [False, True, "grid"],
                         ids=["brute", "cull", "grid"])
def test_trace_through_the_operators_equals_the_plain_versions(
        make, cull, monkeypatch):
    rays, scene, materials = make()
    cfg = TraceConfig(max_bounces=4, use_kernel=True, cull=cull)
    shift = torch.zeros(rays.dim, dtype=F32)

    def run():
        x = shift.clone().requires_grad_(True)
        value = landing_loss(x, rays, scene, materials, cfg)
        (grad,) = torch.autograd.grad(value, x)
        return trace(rays, scene, materials, cfg).rays, value, grad

    got = run()
    plain_wrappers(monkeypatch)
    want = run()
    for a, b in ((got[0].state, want[0].state), (got[0].p0, want[0].p0),
                 (got[0].p1, want[0].p1), (got[1], want[1]),
                 (got[2], want[2])):
        assert torch.equal(a, b)
    assert int((got[0].state == 1).sum()) > 0


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["xla_path", "kernel_path"])
def test_func_grad_and_value_through_the_trace(use_kernel):
    rays, scene, materials = scene_2d()
    cfg = TraceConfig(max_bounces=3, use_kernel=use_kernel)
    shift = torch.tensor([0.0, 0.01], dtype=F32)

    def loss(x):
        return landing_loss(x, rays, scene, materials, cfg)

    grad, value = torch.func.grad_and_value(loss)(shift)
    x = shift.clone().requires_grad_(True)
    want = loss(x)
    (want_grad,) = torch.autograd.grad(want, x)
    assert torch.equal(value, want.detach())
    assert torch.equal(grad, want_grad)
    assert float(grad.abs().max()) > 0
