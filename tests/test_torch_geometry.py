"""Parity of the PyTorch port's geometry, materials and quaternions with the
JAX package, in float64 on the CPU: the same numpy inputs go through both.

Tolerance: rtol 1e-12.  Both sides evaluate the same expressions in the same
order in IEEE float64; what is left is the last-bit difference between
XLA's and PyTorch's elementwise math functions (sqrt, rsqrt, pow, acos).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu.models import surfaces as j_surf
from tensorflowraytrace_tpu.ops import geometry as j_geo
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu.utils import quaternion as j_quat
from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.models import surfaces as t_surf
from tensorflowraytrace_tpu_torch.ops import geometry as t_geo
from tensorflowraytrace_tpu_torch.ops import materials as t_mats
from tensorflowraytrace_tpu_torch.utils import quaternion as t_quat

RTOL = 1e-12
MATERIALS = ["vacuum", "acrylic", "crown_glass", "flint_glass",
             "fused_silica", "polycarbonate", "reflective", "soda_lime"]


@pytest.fixture(autouse=True)
def on_cpu():
    """The port builds on CUDA by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def tri_inputs(rng, n, m):
    """N rays x M triangles as broadcastable (N, 1) / (1, M) columns."""
    p0 = rng.uniform(-2, 2, (n, 3))
    p1 = p0 + rng.normal(0, 1, (n, 3))
    c = rng.uniform(-1, 1, (m, 3))
    tri = [c + rng.normal(0, 0.8, (m, 3)) for _ in range(3)]
    # one triangle parallel to the first ray: exercises the safe divide
    d = p1[0] - p0[0]
    tri[1][0] = tri[0][0] + d
    tri[2][0] = tri[0][0] + np.cross(d, [0.3, -0.2, 0.9])
    ray_cols = [p[:, k:k + 1] for p in (p0, p1) for k in range(3)]
    tri_cols = [v[None, :, k] for v in tri for k in range(3)]
    return ray_cols + tri_cols


def test_raw_line_triangle_intersect_matches_jax(rng):
    cols = tri_inputs(rng, 40, 30)
    j_out = j_geo.raw_line_triangle_intersect(*[jnp.asarray(a) for a in cols])
    t_out = t_geo.raw_line_triangle_intersect(*[t64(a) for a in cols])
    valid = np.asarray(j_out[3])
    np.testing.assert_array_equal(t_out[3].numpy(), valid)
    assert not valid.all()  # the parallel case is masked
    for t, j in zip(t_out[:3] + t_out[4:], j_out[:3] + j_out[4:]):
        close(t, j)


def test_raw_line_triangle_intersect_explicit_epsilon(rng):
    cols = tri_inputs(rng, 12, 9)
    j_out = j_geo.raw_line_triangle_intersect(*[jnp.asarray(a) for a in cols],
                                              epsilon=0.5)
    t_out = t_geo.raw_line_triangle_intersect(*[t64(a) for a in cols],
                                              epsilon=0.5)
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3]))
    close(t_out[4], j_out[4])


def snell_inputs(rng, n):
    p0 = rng.normal(0, 1, (n, 3))
    p1 = p0 + rng.normal(0, 1, (n, 3))
    norm = rng.normal(0, 1, (n, 3))
    n_in = rng.choice([0.0, 1.0, 1.49, 1.7], n)
    n_out = rng.choice([0.0, 1.0, 1.33], n)
    # a degenerate (zero-length) ray and a zero normal: the safe units
    p1[0] = p0[0]
    norm[1] = 0.0
    return p0, p1, norm, n_in, n_out


def test_snell_3d_vec_matches_jax(rng):
    p0, p1, norm, n_in, n_out = snell_inputs(rng, 200)
    j_a, j_b = j_geo.snell_3d_vec(jnp.asarray(p0), jnp.asarray(p1),
                                  jnp.asarray(norm), jnp.asarray(n_in),
                                  jnp.asarray(n_out), 1.5)
    t_a, t_b = t_geo.snell_3d_vec(t64(p0), t64(p1), t64(norm), t64(n_in),
                                  t64(n_out), torch.tensor(1.5, dtype=torch.float64))
    close(t_a, j_a)
    close(t_b, j_b, atol=1e-14)
    assert np.isfinite(t_b.numpy()).all()


def test_snell_3d_vec_covers_tir_and_mirror(rng):
    """The inputs above reach every branch: refraction, TIR, mirror."""
    p0, p1, norm, n_in, n_out = snell_inputs(rng, 200)
    u = t_geo._safe_unit(t64(p1 - p0))
    n = t_geo._safe_unit(t64(norm))
    nu = (u * n).sum(-1, keepdim=True)
    eta = t_geo.select_eta(t64(n_in)[:, None], t64(n_out)[:, None], nu > 0)
    radicand = 1 - eta ** 2 + (eta * nu) ** 2
    assert (radicand < 0).any() and (radicand > 0).any()
    assert (t64(n_in) == 0).any()


def test_safe_unit_matches_jax(rng):
    v = rng.normal(0, 1, (50, 3))
    v[3] = 0.0
    v[4] = 1e-300
    close(t_geo._safe_unit(t64(v)), j_geo._safe_unit(jnp.asarray(v)))


def test_select_eta_matches_jax(rng):
    n_in = rng.choice([0.0, 1.0, 1.5], 64)
    n_out = rng.choice([0.0, 1.0, 1.33], 64)
    internal = rng.uniform(size=64) < 0.5
    close(t_geo.select_eta(t64(n_in), t64(n_out), torch.as_tensor(internal)),
          j_geo.select_eta(jnp.asarray(n_in), jnp.asarray(n_out),
                           jnp.asarray(internal)))


@pytest.mark.parametrize("name", MATERIALS)
def test_material_curve_matches_jax(name):
    wl = np.linspace(380.0, 900.0, 53)
    close(getattr(t_mats, name)(t64(wl)), getattr(j_mats, name)(jnp.asarray(wl)))


def test_constant_material_matches_jax():
    wl = np.linspace(400.0, 700.0, 7)
    close(t_mats.build_constant_material(1.62)(t64(wl)),
          j_mats.build_constant_material(1.62)(jnp.asarray(wl)))


def test_material_index_lookup_matches_jax(rng):
    names = ["vacuum", "acrylic", "reflective", "crown_glass"]
    wl = rng.uniform(400, 800, 300)
    # -1 and 4 are out of range: NaN, never material 0
    idx = rng.integers(-1, 5, 300).astype(np.int32)
    t = t_mats.material_index_lookup([getattr(t_mats, k) for k in names],
                                     t64(wl), torch.as_tensor(idx))
    j = j_mats.material_index_lookup([getattr(j_mats, k) for k in names],
                                     jnp.asarray(wl), jnp.asarray(idx))
    out_of_range = (idx < 0) | (idx >= len(names))
    assert out_of_range.any()
    assert np.isnan(t.numpy()[out_of_range]).all()
    close(t, j)  # assert_allclose treats NaN == NaN


def test_compute_face_normals_matches_jax(rng):
    vp, v1, v2 = (rng.normal(0, 1, (20, 3)) for _ in range(3))
    close(t_surf.compute_face_normals(t64(vp), t64(v1), t64(v2)),
          j_surf.compute_face_normals(jnp.asarray(vp), jnp.asarray(v1),
                                      jnp.asarray(v2)))


def test_triangle_set_make_matches_jax(rng):
    vp, v1, v2 = (rng.normal(0, 1, (6, 3)) for _ in range(3))
    j = j_surf.TriangleSet.make(vp, v1, v2, mat_in=2, mat_out=1,
                                dtype=jnp.float64)
    t = t_surf.TriangleSet.make(vp, v1, v2, mat_in=2, mat_out=1,
                                dtype=torch.float64)
    close(t.norm, j.norm)
    np.testing.assert_array_equal(t.mat_in.numpy(), np.asarray(j.mat_in))
    with pytest.raises(ValueError):
        t_surf.TriangleSet.make(vp, v1, v2, mat_in=1024)


def test_scene_build_orders_categories(rng):
    def tris(k):
        return t_surf.TriangleSet.make(*(rng.normal(0, 1, (k, 3))
                                         for _ in range(3)), dtype=torch.float64)

    scene = t_surf.Scene3D.build(optical=[tris(2)], stops=[tris(1)],
                                 targets=[tris(3), tris(1)])
    assert scene.triangles.category.tolist() == [0, 0, 1, 2, 2, 2, 2]
    with pytest.raises(ValueError):
        t_surf.Scene3D.build()


def quat_inputs(rng, n):
    q = rng.normal(0, 1, (n, 4))
    v = rng.normal(0, 1, (n, 3))
    return q, v


@pytest.mark.parametrize("fn", ["quat_multiply", "quat_conjugate",
                                "quat_normalize", "rotate_vector"])
def test_quaternion_matches_jax(rng, fn):
    q, v = quat_inputs(rng, 16)
    q2 = rng.normal(0, 1, (16, 4))
    args = {"quat_multiply": (q, q2), "quat_conjugate": (q,),
            "quat_normalize": (q,), "rotate_vector": (q, v)}[fn]
    close(getattr(t_quat, fn)(*[t64(a) for a in args]),
          getattr(j_quat, fn)(*[jnp.asarray(a) for a in args]))


def test_quat_from_u_to_v_matches_jax(rng):
    u = rng.normal(0, 1, (12, 3))
    v = rng.normal(0, 1, (12, 3))
    v[0] = u[0]          # parallel
    v[1] = -u[1]         # antiparallel
    v[2] = [-3.0, 0, 0]  # antiparallel to a u on the x axis
    u[2] = [1.0, 0, 0]
    t = t_quat.quat_from_u_to_v(t64(u), t64(v))
    close(t, j_quat.quat_from_u_to_v(jnp.asarray(u), jnp.asarray(v)),
          atol=1e-15)
    # and it does rotate u onto v
    rotated = t_quat.rotate_vector(t, t64(u / np.linalg.norm(u, axis=1,
                                                              keepdims=True)))
    np.testing.assert_allclose(
        rotated.numpy(), v / np.linalg.norm(v, axis=1, keepdims=True),
        atol=1e-12)
