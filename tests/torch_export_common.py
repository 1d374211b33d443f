"""The scene and rays of tests/test_export.py in the port and in the JAX
package, the small 2D and 3D scenes of the kernel paths, and the check of an exported trace through the ``tfrt_torch``
operators, for the export tests."""

import jax.numpy as jnp
import numpy as np
import torch

from tensorflowraytrace_tpu import RaySet as JRaySet
from tensorflowraytrace_tpu import Scene2D as JScene2D
from tensorflowraytrace_tpu import SegmentSet as JSegmentSet
from tensorflowraytrace_tpu.ops import materials as j_mats
from tensorflowraytrace_tpu_torch import (
    RaySet, Scene2D, SegmentSet, scenes2d, streamed,
)
from tensorflowraytrace_tpu_torch.engine import TraceConfig, trace
from tensorflowraytrace_tpu_torch.ops import materials as mats
from tensorflowraytrace_tpu_torch.utils import export as ex

F64 = torch.float64
RTOL = 1e-12


def ray_arrays(n):
    rng = np.random.default_rng(0)
    p0 = np.stack([np.zeros(n), rng.uniform(-2, 2, n)], axis=1)
    p1 = p0 + np.stack([np.ones(n), rng.uniform(-0.3, 0.3, n)], axis=1)
    return p0, p1


def port_case(n=16):
    glass = SegmentSet.make([[1.0, -4.0]], [[1.0, 4.0]], mat_in=1, mat_out=0,
                            dtype=F64)
    tgt = SegmentSet.make([[6.0, -8.0]], [[6.0, 8.0]], dtype=F64)
    scene = Scene2D.build(optical_segments=[glass], target_segments=[tgt])
    p0, p1 = ray_arrays(n)
    rays = RaySet.make(torch.as_tensor(p0), torch.as_tensor(p1), 575.0,
                       dtype=F64)
    return scene, rays, (mats.vacuum, mats.acrylic)


def jax_case(n=16):
    glass = JSegmentSet.make([[1.0, -4.0]], [[1.0, 4.0]], mat_in=1,
                             mat_out=0, dtype=jnp.float64)
    tgt = JSegmentSet.make([[6.0, -8.0]], [[6.0, 8.0]], dtype=jnp.float64)
    scene = JScene2D.build(optical_segments=[glass], target_segments=[tgt])
    p0, p1 = ray_arrays(n)
    rays = JRaySet.make(jnp.asarray(p0), jnp.asarray(p1), 575.0,
                        dtype=jnp.float64)
    return scene, rays, (j_mats.vacuum, j_mats.acrylic)


F32 = torch.float32


def scene_2d():
    rays, scene, materials = scenes2d.light_guide(512, 300, 64, dtype=F32,
                                                  device="cpu")
    return rays, scene, materials


def scene_3d():
    scene = streamed.long_guide_scene(12, 24, F32, "cpu")
    rays = streamed.entrance_block(torch.Generator().manual_seed(0), 512, F32,
                                   "cpu")
    return rays, scene, (mats.vacuum, mats.acrylic)


OPERATORS = {
    ("2d", False): ("segment_search", "arc_search"),
    ("2d", True): ("segment_search_culled", "arc_search_culled"),
    ("2d", "grid"): ("segment_search_twolevel", "arc_search_twolevel"),
    ("3d", False): ("triangle_search",),
    ("3d", True): ("triangle_search_culled",),
    ("3d", "grid"): ("triangle_search_twolevel",),
}


def check_exported_kernel_trace(dim, cull, rays, scene, materials):
    """Export a 2-bounce ``use_kernel=True`` trace under ``cull``, check
    that its graph calls the operators of ``OPERATORS[dim, cull]`` and that
    the loaded program equals the live trace bit for bit."""
    cfg = TraceConfig(max_bounces=2, use_kernel=True, cull=cull)
    blob = ex.export_trace(scene, materials, cfg, rays)
    served = ex.load_fn(blob)
    called = {node.target.name().split("::")[1].split(".")[0]
              for node in served.graph.nodes
              if node.op == "call_function"
              and isinstance(node.target, torch._ops.OpOverload)
              and node.target.namespace == "tfrt_torch"}
    # the searches, and the gather whose backward is K2
    assert called == set(OPERATORS[dim, cull]) | {"gather_rows_t"}
    got = served(rays)
    want = trace(rays, scene, materials, cfg).rays
    for a, b in ((got.state, want.state), (got.p0, want.p0),
                 (got.p1, want.p1)):
        assert torch.equal(a, b)
