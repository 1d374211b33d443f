"""The port's kernels as ``torch.library`` operators, namespace
``tfrt_torch``.

A kernel wrapper hands the kernel the tensors' data pointers through
``ctypes``.  A fake tensor, which ``torch.export`` traces with, has none, so
a trace that called the wrappers' launches directly could not be exported.
Each search and K2 is therefore an operator with three implementations:

- CPU: the plain PyTorch version beside the kernel;
- CUDA: the kernel module's ``*_cuda`` function, the wrapper body of
  before: the input checks, the preparation (tables, boxes, candidate
  lists, with the tunables read at call time) and the launch, which adds
  one to the kernel's launch count;
- fake: the outputs' shapes, dtypes and device, nothing computed.

The public wrappers (``nearest_hit_*_kernel``,
``segsum_kernels.segment_sum_kernel``) refuse devices other than the CPU
and CUDA and call the operators; an exported program calls the operators
by name.  Nothing falls back to the plain version on CUDA tensors.

| operator | kernel | wrapper |
|---|---|---|
| ``triangle_search`` | K1 ``csrc/triangle_search.cu`` | ``triangle_kernels.nearest_hit_triangles_kernel`` |
| ``triangle_search_culled`` | K3 | ``nearest_hit_triangles_culled_kernel`` |
| ``triangle_search_twolevel`` | K4 | ``nearest_hit_triangles_twolevel_kernel`` |
| ``segment_search`` | K5 | ``segment_kernels.nearest_hit_segments_kernel`` |
| ``segment_search_culled`` | K7 | ``nearest_hit_segments_culled_kernel`` |
| ``segment_search_twolevel`` | K9 | ``nearest_hit_segments_twolevel_kernel`` |
| ``arc_search`` | K6 | ``arc_kernels.nearest_hit_arcs_kernel`` |
| ``arc_search_culled`` | K8 | ``nearest_hit_arcs_culled_kernel`` |
| ``arc_search_twolevel`` | K10 | ``nearest_hit_arcs_twolevel_kernel`` |
| ``segment_sum`` | K2 ``csrc/segment_sum.cu`` | ``segsum_kernels.segment_sum_kernel`` |

A search returns ``(valid bool, idx int32, ray_u)`` per ray, and an arc
search ``branch bool`` after them; ``ray_u`` is in the rays' dtype, float32
or float64 on CUDA for every search.
``segment_sum`` returns the (m, k) sum in the cotangent's dtype, added in
the fixed order of ``segsum_kernels`` on either device, so the two give the
same bits.  Its gradient with respect to the cotangent is the gather ``g[idx].T`` (zero
where idx lies outside [0, m), which adds nothing), registered on the
operator, so that the histograms that bin through it
(``analysis.histogram2d``, ``soft_histogram2d``) pass a gradient to their
weights.  No search operator has a gradient.

One more operator, ``gather_rows_t``, is the engine's per-bounce gather
``table[idx].T`` (``engine._gather_rows_t``) with its backward registered:
K2's operator under ``use_kernel``, its plain version otherwise.

This module is imported by ``ops/__init__.py``, so importing any module of
the port registers the operators.
"""

from __future__ import annotations

import torch

from tensorflowraytrace_tpu_torch.ops import arc_kernels as ak
from tensorflowraytrace_tpu_torch.ops import segment_kernels as gk
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk
from tensorflowraytrace_tpu_torch.ops import triangle_kernels as tk

NAMESPACE = "tfrt_torch"

_TRIANGLES = ("Tensor p0, Tensor p1, Tensor vp, Tensor v1, Tensor v2, "
              "float intersect_eps, float size_eps, float ray_start_eps")
_SEGMENTS = ("Tensor p0, Tensor p1, Tensor sp0, Tensor sp1, "
             "float intersect_eps, float size_eps, float ray_start_eps")
_ARCS = ("Tensor p0, Tensor p1, Tensor center, Tensor angle_start, "
         "Tensor angle_end, Tensor radius, float intersect_eps, "
         "float ray_start_eps")
_HIT = "(Tensor, Tensor, Tensor)"
_ARC_HIT = "(Tensor, Tensor, Tensor, Tensor)"


def _fake_hit(p0, *_):
    n = p0.shape[0]
    return (p0.new_empty((n,), dtype=torch.bool),
            p0.new_empty((n,), dtype=torch.int32), p0.new_empty((n,)))


def _fake_arc_hit(p0, *_):
    return _fake_hit(p0) + (p0.new_empty((p0.shape[0],), dtype=torch.bool),)


def _fake_segment_sum(ct, idx, m):
    return ct.new_empty((m, ct.shape[0]))


def _define(name, schema, cpu, cuda, fake):
    """The operator ``tfrt_torch::name`` with its CPU, CUDA and fake
    implementations."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


triangle_search = _define(
    "triangle_search", f"({_TRIANGLES}) -> {_HIT}",
    tk.nearest_hit_triangles_plain, tk.triangle_search_cuda, _fake_hit)
triangle_search_culled = _define(
    "triangle_search_culled", f"({_TRIANGLES}) -> {_HIT}",
    tk.nearest_hit_triangles_culled_plain, tk.triangle_search_culled_cuda,
    _fake_hit)
triangle_search_twolevel = _define(
    "triangle_search_twolevel", f"({_TRIANGLES}) -> {_HIT}",
    tk.nearest_hit_triangles_twolevel_plain, tk.triangle_search_twolevel_cuda,
    _fake_hit)
segment_search = _define(
    "segment_search", f"({_SEGMENTS}) -> {_HIT}",
    gk.nearest_hit_segments_plain, gk.segment_search_cuda, _fake_hit)
segment_search_culled = _define(
    "segment_search_culled", f"({_SEGMENTS}) -> {_HIT}",
    gk.nearest_hit_segments_culled_plain, gk.segment_search_culled_cuda,
    _fake_hit)
segment_search_twolevel = _define(
    "segment_search_twolevel", f"({_SEGMENTS}) -> {_HIT}",
    gk.nearest_hit_segments_twolevel_plain, gk.segment_search_twolevel_cuda,
    _fake_hit)
arc_search = _define(
    "arc_search", f"({_ARCS}) -> {_ARC_HIT}",
    ak.nearest_hit_arcs_plain, ak.arc_search_cuda, _fake_arc_hit)
arc_search_culled = _define(
    "arc_search_culled", f"({_ARCS}) -> {_ARC_HIT}",
    ak.nearest_hit_arcs_culled_plain, ak.arc_search_culled_cuda,
    _fake_arc_hit)
arc_search_twolevel = _define(
    "arc_search_twolevel", f"({_ARCS}) -> {_ARC_HIT}",
    ak.nearest_hit_arcs_twolevel_plain, ak.arc_search_twolevel_cuda,
    _fake_arc_hit)
segment_sum = _define(
    "segment_sum", "(Tensor ct, Tensor idx, int m) -> Tensor",
    sk.segment_sum_plain, sk.segment_sum_cuda, _fake_segment_sum)


def _segment_sum_setup_context(ctx, inputs, output):
    _, idx, m = inputs
    ctx.save_for_backward(idx)
    ctx.m = m


def _segment_sum_backward(ctx, g):
    (idx,) = ctx.saved_tensors
    rows = idx.long()
    kept = (rows >= 0) & (rows < ctx.m)
    ct_grad = g[torch.where(kept, rows, 0)].T
    return torch.where(kept, ct_grad, 0.0), None, None


segment_sum.register_autograd(_segment_sum_backward,
                              setup_context=_segment_sum_setup_context)


def _gather_rows_t(table, idx, use_kernel):
    return table[idx.long()].T


def _fake_gather_rows_t(table, idx, use_kernel):
    return table.new_empty((idx.shape[0], table.shape[1])).T


def _gather_setup_context(ctx, inputs, output):
    table, idx, use_kernel = inputs
    ctx.save_for_backward(idx)
    ctx.m = table.shape[0]
    ctx.use_kernel = use_kernel


@torch.autograd.function.once_differentiable
def _gather_backward(ctx, ct):
    (idx,) = ctx.saved_tensors
    # the kernel's wrapper runs the plain version on CPU tensors
    segment_sum = (sk.segment_sum_kernel if ctx.use_kernel
                   else sk.segment_sum_plain)
    return segment_sum(ct, idx, ctx.m), None, None


# The engine's per-bounce gather, ``table[idx].T``, whose backward is K2's
# operator under ``use_kernel`` (its plain version otherwise).  An
# operator with its backward registered, not an autograd.Function: an
# exported gradient program traces an operator's registered backward, but
# derives a Function's from the ops of its forward, which would leave K2
# out.  torch.func transforms pass through it.
gather_rows_t = torch.library.custom_op(
    f"{NAMESPACE}::gather_rows_t", _gather_rows_t, mutates_args=(),
    schema="(Tensor table, Tensor idx, bool use_kernel) -> Tensor")
gather_rows_t.register_fake(_fake_gather_rows_t)
gather_rows_t.register_autograd(_gather_backward,
                                setup_context=_gather_setup_context)

# every operator by the kernel it launches on CUDA
OPS = {"K1": triangle_search, "K2": segment_sum, "K3": triangle_search_culled,
       "K4": triangle_search_twolevel, "K5": segment_search,
       "K6": arc_search, "K7": segment_search_culled,
       "K8": arc_search_culled, "K9": segment_search_twolevel,
       "K10": arc_search_twolevel}
