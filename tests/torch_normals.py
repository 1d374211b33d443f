"""The port's face normals in float32, for tests that hold them exactly.

The port writes the cross product out (``surfaces.compute_face_normals``):
each product and difference rounded on its own, which a numpy float32
evaluation repeats, then the norm and the division of the JAX package's
``compute_face_normals``.  XLA fuses the JAX package's own cross product,
so its float32 normals differ from these in the last bits: tests hold the
port's float32 normals to JAX's own with ``assert_near_jax_normals``,
beside the exact check against ``written_out_normals``.
"""

import jax.numpy as jnp
import numpy as np

# A component of the cross product a x b rounds within about eps |a| |b|
# (eps of float32), which the normalisation divides by |a x b|: so a unit
# normal's components may lie NORMAL_EPS eps / sin(a, b) from JAX's.
NORMAL_EPS = 2


def written_out_normals(vp, v1, v2):
    """Unit normals normalize(cross(v1 - vp, v2 - v1)) of (M, 3) corners,
    the cross product written out in numpy, normalised by JAX."""
    vp, v1, v2 = (np.asarray(x) for x in (vp, v1, v2))
    a, b = v1 - vp, v2 - v1
    n = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                  a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                  a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=-1)
    n = jnp.asarray(n)
    return np.asarray(n / jnp.linalg.norm(n, axis=-1, keepdims=True))


def assert_near_jax_normals(got, want, vp, v1, v2):
    """Each component of the (M, 3) float32 normals ``got`` within
    ``NORMAL_EPS`` eps / sin(a, b) of JAX's ``want``, a = v1 - vp and b =
    v2 - v1 the corners' edges (the sine taken in float64)."""
    vp, v1, v2 = (np.asarray(x, np.float64) for x in (vp, v1, v2))
    a, b = v1 - vp, v2 - v1
    sin = (np.linalg.norm(np.cross(a, b), axis=-1)
           / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)))
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    limit = NORMAL_EPS * np.finfo(np.float32).eps / sin
    worst = float((gap.max(axis=-1) / limit).max())
    assert worst <= 1.0, f"normals {worst} times their limit from JAX's"
