"""Shared inputs of the reaction parity tests (tests/test_torch_operations.py,
test_torch_thinfilm.py, test_torch_diffractive.py, test_torch_stochastic.py):
one projection and ray set made from the same numpy arrays for both
packages, and the comparison of a reaction's children and field updates.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu.engine import Projection as JProjection
from tensorflowraytrace_tpu.engine import TraceConfig as JTraceConfig
from tensorflowraytrace_tpu_torch import RaySet, TraceConfig, config
from tensorflowraytrace_tpu_torch.engine import Projection

F64 = torch.float64
RTOL = 1e-12
ATOL = 1e-13
M32 = 0xFFFFFFFF


@pytest.fixture
def on_cpu():
    """The port builds on CUDA by default; the tests ask for the CPU, on one
    thread: a trace issues thousands of small operations, which torch's
    thread pool slows by orders of magnitude when the test workers hold
    more threads than the machine has cores."""
    previous = config.set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_default_device(previous)


def unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def random_case(rng, n, dim, mirrors=True):
    """A projection's worth of numpy arrays: rays from p0 to their hit
    ``point`` on surfaces with random normals (3D vectors, 2D angles),
    indices from {1, 1.5, 1.33} and the 0 mirror sentinel on either side,
    so that refraction, TIR and mirrors from both sides all occur."""
    d = unit(rng.normal(size=(n, dim)))
    point = rng.uniform(-1, 1, (n, dim))
    p0 = point - rng.uniform(0.5, 2.0, (n, 1)) * d
    if dim == 3:
        norm = rng.normal(size=(n, 3)) * rng.uniform(0.5, 2.0, (n, 1))
    else:
        norm = rng.uniform(-math.pi, math.pi, n)
    choices = [1.0, 1.5, 1.33] + ([0.0] if mirrors else [])
    n_in = rng.choice(choices, n)
    n_out = rng.choice([1.0, 1.5, 1.33], n)
    return {"p0": p0, "point": point, "norm": norm, "n_in": n_in,
            "n_out": n_out, "surf_idx": rng.integers(0, 4, n),
            "kind": rng.integers(0, 2, n), "wavelength":
            rng.uniform(450.0, 650.0, n), "fields": {}}


def edge_case(dim):
    """Rays at the edges: grazing (nu == 0 exactly), normal incidence from
    either side, internal TIR, a mirror seen from outside and from inside,
    and exactly critical incidence."""
    if dim == 3:
        d = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 0, 1.0],
                      [math.sqrt(0.5), 0, math.sqrt(0.5)],
                      [0, 0.6, -0.8], [0, 0.6, 0.8],
                      [math.sqrt(1 - 1 / 2.25), 0, math.sqrt(1 / 2.25)]])
        norm = np.tile([[0.0, 0.0, 1.0]], (len(d), 1))
    else:
        d = np.array([[0.0, 1.0], [-1.0, 0], [1.0, 0],
                      [math.sqrt(0.5), math.sqrt(0.5)],
                      [-0.8, 0.6], [0.8, 0.6],
                      [math.sqrt(1 / 2.25), math.sqrt(1 - 1 / 2.25)]])
        norm = np.zeros(len(d))
    n = len(d)
    n_in = np.array([1.5, 1.5, 1.5, 1.5, 0.0, 0.0, 1.5])
    n_out = np.ones(n)
    point = np.zeros((n, dim))
    return {"p0": point - d, "point": point, "norm": norm, "n_in": n_in,
            "n_out": n_out, "surf_idx": np.arange(n) % 4,
            "kind": np.arange(n) % 2, "wavelength": np.full(n, 550.0),
            "fields": {}}


def concat_cases(*cases):
    out = {k: np.concatenate([c[k] for c in cases])
           for k in cases[0] if k != "fields"}
    out["fields"] = {k: np.concatenate([c["fields"][k] for c in cases])
                     for k in cases[0]["fields"]}
    return out


def with_fields(case, **fields):
    return dict(case, fields={**case["fields"], **fields})


def jax_inputs(case):
    dim = case["p0"].shape[1]
    n = len(case["p0"])
    proj = JProjection(
        hit_valid=jnp.ones(n, bool), point=jnp.asarray(case["point"]),
        norm=jnp.asarray(case["norm"]), n_in=jnp.asarray(case["n_in"]),
        n_out=jnp.asarray(case["n_out"]),
        category=jnp.zeros(n, jnp.int32),
        surf_idx=jnp.asarray(case["surf_idx"], jnp.int32),
        kind=jnp.asarray(case["kind"], jnp.int32), extras={}, dim=dim)
    rays = JRaySet.make(case["p0"], case["point"], case["wavelength"],
                        fields={k: jnp.asarray(v)
                                for k, v in case["fields"].items()},
                        dtype=jnp.float64)
    return proj, rays


def torch_inputs(case, requires_grad=()):
    """The port's projection and rays; the arrays named in
    ``requires_grad`` (``"p0"``, ``"point"``, ``"norm"``) are leaves."""
    dim = case["p0"].shape[1]
    n = len(case["p0"])

    def t(k):
        x = torch.as_tensor(case[k], dtype=F64)
        return x.requires_grad_(True) if k in requires_grad else x

    p0, point = t("p0"), t("point")
    proj = Projection(
        hit_valid=torch.ones(n, dtype=torch.bool), point=point,
        norm=t("norm"), n_in=t("n_in"), n_out=t("n_out"),
        category=torch.zeros(n, dtype=torch.int32),
        surf_idx=torch.as_tensor(case["surf_idx"], dtype=torch.int32),
        kind=torch.as_tensor(case["kind"], dtype=torch.int32), extras={},
        dim=dim)
    fields = {k: torch.as_tensor(np.asarray(v)) for k, v in
              case["fields"].items()}
    rays = RaySet.make(p0, point, case["wavelength"], fields=fields,
                       dtype=F64, device="cpu")
    rays = dataclasses.replace(rays, p0=p0, p1=point)
    return proj, rays


def run_both(case, j_reaction, t_reaction):
    """Both reactions on the same inputs, as the 3-tuple protocol:
    ``(jax (p0, p1, updates), torch (p0, p1, updates))``, numpy; the JAX
    reaction compiled."""
    jp, jr = jax_inputs(case)
    tp, tr = torch_inputs(case)
    jout = jax.jit(lambda p, r: j_reaction(p, r, JTraceConfig()))(jp, jr)
    tout = t_reaction(tp, tr, TraceConfig())

    def as_np(out):
        p0, p1 = out[:2]
        upd = dict(out[2]) if len(out) == 3 else {}
        return (np.asarray(p0 if not isinstance(p0, torch.Tensor)
                           else p0.detach()),
                np.asarray(p1 if not isinstance(p1, torch.Tensor)
                           else p1.detach()),
                {k: np.asarray(v if not isinstance(v, torch.Tensor)
                               else v.detach()) for k, v in upd.items()})

    return as_np(jout), as_np(tout)


def assert_same(j, t, rtol=RTOL, atol=ATOL):
    """Children and updates of :func:`run_both` equal within ``rtol``:
    the same update keys, bools and ints exactly."""
    np.testing.assert_allclose(t[0], j[0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(t[1], j[1], rtol=rtol, atol=atol)
    assert sorted(t[2]) == sorted(j[2])
    for k in j[2]:
        jv, tv = np.broadcast_to(j[2][k], np.shape(t[2][k])), t[2][k]
        if jv.dtype.kind in "biu":
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol,
                                       err_msg=k)


def jax_key(seed):
    """The JAX key whose words are the port's integer seed."""
    return jnp.asarray(np.array([seed >> 32, seed & M32], dtype=np.uint32))


def jax_draws(monkeypatch, operations):
    """Replace the port's stream with JAX's: ``fold_in(key, mix)`` per ray,
    a (3,) normal sliced to ``dim`` and a scalar uniform, as the JAX
    reactions draw them."""

    def keys(key, mix):
        m = jnp.asarray(mix.cpu().numpy().astype(np.uint32))
        return jax.vmap(jax.random.fold_in, (None, 0))(jax_key(key), m)

    def normal(key, mix, dim, dtype):
        g = jax.vmap(lambda k: jax.random.normal(k, (3,)))(keys(key, mix))
        return torch.as_tensor(np.array(g[:, :dim])).to(dtype)

    def uniform(key, mix, dtype):
        jdt = jnp.float64 if dtype == F64 else jnp.float32
        u = jax.vmap(lambda k: jax.random.uniform(k, (), jdt))(keys(key,
                                                                     mix))
        return torch.as_tensor(np.array(u)).to(dtype)

    monkeypatch.setattr(operations, "ray_normal", normal)
    monkeypatch.setattr(operations, "ray_uniform", uniform)
