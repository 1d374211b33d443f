"""Data parallelism: the ray axis split over the ranks of a
``torch.distributed`` process group.

Counterpart of ``tensorflowraytrace_tpu/parallel/sharding.py``, in torch's
idiom: one process per device (``torchrun --nproc_per_node=<devices>``), so
the JAX package's mesh of D devices is D ranks here, and each function runs
on every rank with that rank's part.  The names are the JAX package's:

* rays are data-parallel: each rank holds one contiguous shard of the ray
  axis (``shard_rays``) or samples its own (``split_keys``,
  ``shard_rays_from_local``);
* scenes and parameters are small and replicated (``replicate``: a
  broadcast from rank 0);
* a training step's one collective is an all-reduce of one flat buffer that
  holds the loss and every gradient (``parallel_value_and_grad``,
  ``parallel_streamed_value_and_grad``, ``optim.Optimizer(mesh=...)``).

Collectives run over the group's backend: NCCL between CUDA devices, gloo
on the CPU (gloo also all-reduces and broadcasts CUDA tensors).
``parallel_psf`` sums the Huygens PSF's field over the ranks' rays with one
all-reduce of the (G, 2) field, after one of the phase reference's three
weighted sums.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from tensorflowraytrace_tpu_torch import config
from tensorflowraytrace_tpu_torch.engine import (
    TraceConfig, _blocks_value_and_grad, default_reaction, trace,
    trace_streamed,
)


@dataclass(frozen=True)
class RayMesh:
    """The ranks the ray axis is split over: a process group (None: the
    default group), this process's rank in it, its size, and the device
    this rank traces on."""

    group: object
    rank: int
    world_size: int
    device: torch.device


def init_multihost(backend: Optional[str] = None,
                   init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None, timeout=None) -> int:
    """Join this process to the default process group
    (``torch.distributed.init_process_group``) and return its rank.

    Given no arguments it reads the environment ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``); elsewhere pass ``init_method="tcp://host:port"``,
    ``world_size`` and ``rank``.  The backend is ``"nccl"`` when the port's
    default device is CUDA and ``"gloo"`` on the CPU, unless named.  Under
    NCCL this process's CUDA device becomes ``cuda:LOCAL_RANK``.  There is no
    fallback: NCCL without CUDA, or an NCCL failure, raises and never turns
    into gloo.  A group that is already initialised is kept."""
    if dist.is_initialized():
        return dist.get_rank()
    if backend is None:
        backend = "nccl" if config.default_device().type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_multihost(backend='nccl') needs CUDA, and no CUDA "
                "device is available; the port does not fall back to gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kwargs)
    return dist.get_rank()


def ray_mesh(device=None, group=None) -> RayMesh:
    """This process's :class:`RayMesh` over ``group`` (the default group),
    tracing on ``device``: by default ``cuda:LOCAL_RANK`` when the port's
    default device is CUDA, else the CPU.  Needs :func:`init_multihost`
    first."""
    if not dist.is_initialized():
        raise RuntimeError("ray_mesh needs a process group: call "
                           "init_multihost() on every rank first")
    if device is None:
        device = config.resolve_device(None)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return RayMesh(group=group, rank=dist.get_rank(group),
                   world_size=dist.get_world_size(group),
                   device=torch.device(device))


def _map_tensors(fn, tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
    """``tree`` with ``fn`` applied to every leaf: through dataclasses (a
    RaySet, a scene), dicts, lists and tuples."""
    if is_leaf(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(fn, getattr(tree, f.name), is_leaf)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v, is_leaf) for v in tree)
    return tree


def _source(mesh: RayMesh) -> int:
    """The global rank of the group's rank 0."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def _broadcast(a: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """A copy of rank 0's ``a`` on this rank's device."""
    out = a.detach().to(mesh.device).clone().contiguous()
    wire = out.to(torch.uint8) if out.dtype == torch.bool else out
    dist.broadcast(wire, _source(mesh), group=mesh.group)
    return wire.to(torch.bool) if out.dtype == torch.bool else wire


def shard_rays(rays, mesh: RayMesh):
    """This rank's contiguous shard of a RaySet that every rank holds whole
    (the JAX package's ``P("rays")``), on this rank's device.  Raises when
    the ray count is no multiple of the world size."""
    n = rays.n_rays
    if n % mesh.world_size:
        raise ValueError(f"shard_rays: {n} rays do not split evenly over "
                         f"{mesh.world_size} ranks")
    k = n // mesh.world_size
    start = mesh.rank * k
    return _map_tensors(lambda a: a[start:start + k].to(mesh.device), rays)


def shard_rays_from_local(local_rays, mesh: RayMesh):
    """This rank's own rays, sampled or loaded by it alone (the global count
    is the local count times the world size), on this rank's device.
    Checks that every rank holds the same count."""
    n = local_rays.n_rays
    bounds = torch.tensor([n, -n], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(bounds, op=dist.ReduceOp.MAX, group=mesh.group)
    most, fewest = int(bounds[0]), -int(bounds[1])
    if most != n or fewest != n:
        raise ValueError(f"shard_rays_from_local: the ranks hold between "
                         f"{fewest} and {most} rays; every rank must hold "
                         "the same count")
    return _map_tensors(lambda a: a.to(mesh.device), local_rays)


def replicate(tree, mesh: RayMesh):
    """Rank 0's copy of ``tree`` (a scene, parameters: tensors in
    dataclasses, dicts, lists, tuples) on every rank's device."""
    return _map_tensors(lambda a: _broadcast(a, mesh), tree)


def replicate_from_host(tree, mesh: RayMesh):
    """``replicate`` of host values (numpy arrays, numbers or tensors):
    each becomes a tensor on this rank's device, and rank 0's values reach
    every rank."""
    def is_leaf(x):
        return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int,
                              float, bool))

    def put(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return _broadcast(a, mesh)

    return _map_tensors(put, tree, is_leaf)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator in :func:`split_keys`; rank 0's
    is ``seed`` itself."""
    return (int(seed) << 32) + int(rank)


def split_keys(seed: int, mesh: RayMesh) -> torch.Generator:
    """This rank's own sampling generator on its device, seeded
    ``rank_seed(seed, rank)``: the counterpart of one PRNG key per
    device."""
    return torch.Generator(mesh.device).manual_seed(rank_seed(seed,
                                                              mesh.rank))


def all_reduce_flat(tensors, mesh: RayMesh):
    """Each of ``tensors`` summed over the ranks, by one all-reduce of one
    flat buffer in their promoted dtype; returned in their own dtypes."""
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _per_ray(leaf, n_local) -> bool:
    """Whether a fold leaf is per-ray: its first axis (or, for a per-bounce
    stack, its second) is the local ray count, as in the JAX package."""
    return ((leaf.ndim >= 1 and leaf.shape[0] == n_local)
            or (leaf.ndim >= 2 and leaf.shape[1] == n_local))


def _reduce_leaf(leaf, how, mesh: RayMesh):
    if callable(how):
        return how(leaf, mesh)
    if how == "none":
        # rank 0's value: returning each rank's own would present one
        # rank's partial accumulator as the global result
        return _broadcast(leaf, mesh)
    if how not in _REDUCE_OPS:
        raise ValueError(f"fold_reduce must be one of "
                         f"{sorted(_REDUCE_OPS) + ['none']} or a callable, "
                         f"got {how!r}")
    out = leaf.detach().clone()
    dist.all_reduce(out, op=_REDUCE_OPS[how], group=mesh.group)
    return out


def _reduce_fold(fold, n_local, fold_reduce, mesh: RayMesh):
    """Every fold leaf that is not per-ray reduced over the ranks by
    ``fold_reduce`` (one reduction for all, or a matching structure of
    them); per-ray leaves stay this rank's."""
    leaves, spec = pytree.tree_flatten(fold)
    if isinstance(fold_reduce, str) or callable(fold_reduce):
        hows = [fold_reduce] * len(leaves)
    else:
        hows = pytree.tree_flatten(fold_reduce)[0]
        if len(hows) != len(leaves):
            raise ValueError("fold_reduce must be one reduction or match the "
                             "fold's structure")
    return pytree.tree_unflatten(
        [leaf if _per_ray(leaf, n_local) else _reduce_leaf(leaf, how, mesh)
         for leaf, how in zip(leaves, hows)], spec)


def parallel_trace(rays, scene, materials=None,
                   cfg: TraceConfig = TraceConfig(),
                   mesh: Optional[RayMesh] = None, reaction=default_reaction,
                   fold_fn=None, fold_init=None, fold_reduce="sum"):
    """:func:`engine.trace` of this rank's shard of the rays (``rays``, as
    :func:`shard_rays` gives them) through the replicated scene.  The
    result's rays and history are this rank's shard.

    Each rank's fold covers its own rays.  Per-ray fold leaves (first axis,
    or second for a per-bounce stack, the local ray count) stay local;
    every other leaf is reduced over the ranks by ``fold_reduce``:
    ``"sum"`` (default: right for landing_sum_fold, histograms, counts),
    ``"max"``, ``"min"``, ``"none"`` (rank 0's value), a callable
    ``(leaf, mesh) -> leaf``, or a structure of those matching the fold.
    Under ``cfg.early_exit`` ``n_bounces`` is the depth over all ranks
    (a MAX).  The reductions are forward only: for gradients use
    :func:`parallel_value_and_grad`."""
    if mesh is None:
        mesh = ray_mesh()
    res = trace(rays, scene, materials, cfg, reaction, fold_fn=fold_fn,
                fold_init=fold_init)
    if cfg.early_exit:
        depth = torch.tensor(res.n_bounces, dtype=torch.int64,
                             device=mesh.device)
        dist.all_reduce(depth, op=dist.ReduceOp.MAX, group=mesh.group)
        res = dataclasses.replace(res, n_bounces=int(depth))
    if fold_fn is not None:
        res = dataclasses.replace(res, fold=_reduce_fold(
            res.fold, rays.n_rays, fold_reduce, mesh))
    return res


def parallel_value_and_grad(local_loss: Callable, mesh: RayMesh):
    """Data-parallel value and gradient: ``local_loss(params, generator) ->
    scalar`` is the loss of this rank's rays (typically sampled from this
    rank's generator, :func:`split_keys`).  Returns ``f(params, generator)
    -> (loss, grads)``, the loss and the gradients summed over the ranks by
    one all-reduce of one flat buffer; ``params`` is a list of tensors."""

    def run(params, generator):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = local_loss(leaves, generator)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss, *grads = all_reduce_flat([loss.detach(), *grads], mesh)
        return loss, grads

    return run


def parallel_trace_streamed(rays, scene, materials=None,
                            cfg: TraceConfig = TraceConfig(),
                            mesh: Optional[RayMesh] = None,
                            reaction=default_reaction,
                            fold_fn=None, fold_init=None,
                            block_size: int = 1 << 20, merge="sum",
                            fold_reduce="sum", remat_blocks: bool = True,
                            fold_fields: bool = False):
    """Streaming on every rank: each rank streams its shard of the rays
    (``rays``, as :func:`shard_rays` gives them) in blocks of
    ``block_size`` (:func:`engine.trace_streamed`), then the merged folds
    combine over the ranks.  ``merge`` is the blocks' merge on each rank;
    ``fold_reduce`` combines the fold leaves that are not per-ray over the
    ranks, as in :func:`parallel_trace`, and per-ray ("concat") leaves stay
    this rank's.  ``state_counts`` is always summed over the ranks, and
    ``n_rays`` is the global count."""
    if mesh is None:
        mesh = ray_mesh()
    n_local = rays.n_rays
    res = trace_streamed(rays, scene, materials, cfg, reaction,
                         fold_fn=fold_fn, fold_init=fold_init,
                         block_size=min(block_size, n_local), merge=merge,
                         remat_blocks=remat_blocks, fold_fields=fold_fields)
    counts = res.state_counts.clone()
    dist.all_reduce(counts, group=mesh.group)
    return dataclasses.replace(
        res, fold=_reduce_fold(res.fold, n_local, fold_reduce, mesh),
        state_counts=counts, n_rays=n_local * mesh.world_size)


def parallel_streamed_value_and_grad(block_loss: Callable, n_blocks: int,
                                     mesh: Optional[RayMesh] = None
                                     ) -> Callable:
    """:func:`engine.streamed_value_and_grad` over the ranks: rank r takes
    the blocks i = r, r + D, r + 2D, ... of the D ranks, so no block is
    traced twice and a rank may have none; each accumulates its blocks'
    value and gradients, and one all-reduce of one flat buffer sums them
    over the ranks.

    ``block_loss(params, i, *aux) -> scalar`` takes the GLOBAL block index
    ``i``, so the same code runs on one device and on many; ``aux`` passes
    through undifferentiated.  Returns ``fn(params, *aux) -> (value,
    grads)``, equal to the single-device result up to the order of
    summation; the value comes back in the parameters' dtype."""
    if n_blocks <= 0:
        raise ValueError(
            f"parallel_streamed_value_and_grad: n_blocks must be positive, "
            f"got {n_blocks} (a rays // block computation may have rounded "
            "to zero -- clamp with max(1, ...))")
    if mesh is None:
        mesh = ray_mesh()

    def run(params, *aux):
        value, grads = _blocks_value_and_grad(
            block_loss, range(mesh.rank, n_blocks, mesh.world_size), params,
            aux)
        dtype = functools.reduce(torch.promote_types,
                                 [g.dtype for g in grads])
        value = (torch.zeros((), dtype=dtype, device=grads[0].device)
                 if value is None else value.to(dtype))
        value, *grads = all_reduce_flat([value, *grads], mesh)
        return value, grads

    return run


def parallel_psf(mesh: RayMesh, wavelength, medium_n=1.0,
                 phase_reduction=True):
    """The ray-sharded Huygens-Fresnel PSF (:func:`analysis.huygens_psf`).
    Returns ``f(sources, opl, amplitudes, grid) -> (G,) PSF`` of this
    rank's shard of the rays and the replicated grid: each rank sums its
    own rays' (G, 2) field and one all-reduce adds the fields.  With
    ``phase_reduction`` the reference wavelet must be the same on every
    rank, so its weighted sums (the weight, the weighted sources and the
    weighted paths) are all-reduced first, in one buffer.  Forward only:
    the all-reduces record no gradient."""
    from tensorflowraytrace_tpu_torch.analysis import _wavelet_field

    def run(sources, opl, amplitudes, grid):
        dtype = sources.dtype
        k = 2.0 * math.pi / torch.as_tensor(wavelength, dtype=dtype,
                                            device=sources.device)
        origin = path_ref = None
        if phase_reduction:
            w = torch.abs(amplitudes)
            sw, so, sp = all_reduce_flat(
                [torch.sum(w), torch.sum(w[:, None] * sources, dim=0),
                 torch.sum(w * opl)], mesh)
            sw = torch.clamp(sw, min=torch.finfo(dtype).tiny)
            origin, path_ref = so / sw, sp / sw
        re, im = _wavelet_field(
            sources, opl, amplitudes, grid, k,
            torch.as_tensor(medium_n, dtype=dtype, device=sources.device),
            origin, path_ref)
        e_re, e_im = all_reduce_flat([re, im], mesh)
        return e_re * e_re + e_im * e_im

    return run
