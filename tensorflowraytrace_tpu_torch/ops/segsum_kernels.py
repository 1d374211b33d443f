"""K2 on Hopper: the segment sum, backward of the engine's row gather and
the histograms' binning.

``segment_sum_kernel(ct, idx, m)`` computes ``out[j] = sum over i with
idx[i] == j of ct[:, i]``: ``ct`` is the (k, N) float32 or float64
cotangent of the transposed gathered rows (or a histogram's weights as a
(1, N) row), ``idx`` the (N,) int32 row of each ray in [0, m), and the
result the (m, k) gradient of the table (or the flat histogram).  Its
gradient with respect to ``ct`` is the gather ``g[idx].T``, registered on
the operator.  On CUDA tensors it
launches the hand-written kernel in ``csrc/segment_sum.cu`` (port of
``_segsum_kernel`` in ``tensorflowraytrace_tpu/ops/pallas_kernels.py``) or
raises; it never falls back.  On CPU tensors it runs
``segment_sum_plain``.  The dispatch is that of the
``tfrt_torch::segment_sum`` operator (``ops/custom_ops.py``), so that an
exported gradient program launches the kernel.

The order of the adds is fixed by ``(ct, idx, m)`` alone: the rays are cut
into tiles of ``TILE`` consecutive rays (the Pallas kernel's ray block);
within a tile each row's contributions are added in ascending ray order
from +0, then each row's tile sums in ascending tile order from +0.  The
kernel and the plain version both add in that order, so they give the same
bits, and a training repeats itself bit for bit from run to run.

The kernel's workspace holds masks and counts of m N / 4096 bytes; where
that passes 256 MiB (a large histogram of many rays) the kernel sums the
rays in chunks of whole tiles, each continuing the rows' sums of the one
before, which keeps the order and the bits.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflowraytrace_tpu_torch.ops import cuda_build

# Launches of the CUDA kernel in this process.  The wrapper adds one where it
# launches and nowhere else; callers reset it to 0 to count a run.
LAUNCHES = 0

SOURCE = "segment_sum.cu"

# Rays a tile: the Pallas kernel's SEGSUM_RAY_BLOCK, and the kernel's kTile,
# which the launch checks.
TILE = 1024


# the kernel's instances by the cotangent's dtype
LAUNCH = {torch.float32: "segment_sum_launch",
          torch.float64: "segment_sum_launch_f64"}


def declare(lib):
    """``lib``, a build of ``SOURCE``, with its C signatures declared."""
    for name in LAUNCH.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    lib.segment_sum_workspace.argtypes = [ctypes.c_int] * 4
    lib.segment_sum_workspace.restype = ctypes.c_longlong
    return lib


def load_library():
    """The kernel library, built at first use, with its C signatures
    declared."""
    return declare(cuda_build.load(SOURCE))


def segment_sum_plain(ct, idx, m):
    """The plain PyTorch version, in ``ct``'s dtype and K2's order: one
    ``index_add_`` a tile of ``TILE`` rays into an (m, k) partial, which adds
    each row's rays in ascending order from +0, and the partials added into
    the result in tile order.  A row a tile misses adds +0 there, which
    changes no sum that starts at +0, so on a table of more rows than a tile
    (a histogram's bins) only the tile's own rows are added and cleared.
    On CUDA tensors it computes on the host and copies the result back
    (only the tests and the all-plain comparison paths call it there)."""
    if ct.device.type != "cpu":
        return segment_sum_plain(ct.cpu(), idx.cpu(), m).to(ct.device)
    k, n = ct.shape
    rows = idx.long()
    out = torch.zeros((m, k), dtype=ct.dtype)
    if n <= TILE:
        return out.index_add_(0, rows, ct.T)
    part = torch.zeros_like(out)
    for start in range(0, n, TILE):
        tile_rows = rows[start:start + TILE]
        part.index_add_(0, tile_rows, ct[:, start:start + TILE].T)
        if m > TILE:
            held = tile_rows.unique()
            out[held] += part[held]
            part[held] = 0
        else:
            out += part
            part.zero_()
    return out


def _check_cuda_inputs(ct, idx, m):
    if idx.device != ct.device:
        raise ValueError(f"idx is on {idx.device}, ct on {ct.device}")
    if ct.dtype not in LAUNCH:
        raise TypeError(f"the CUDA segment sum takes float32 or float64; ct "
                        f"is {ct.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if ct.dim() != 2 or idx.shape != (ct.shape[1],):
        raise ValueError(f"ct must be (k, N) and idx (N,), got "
                         f"{tuple(ct.shape)} and {tuple(idx.shape)}")
    k, n = ct.shape
    if m < 1 or k < 1:
        raise ValueError(f"the table needs at least one row and column, got "
                         f"m={m} k={k}")
    if max(k * n, m * k) >= 2 ** 31:
        raise ValueError("too many rays or rows for 32-bit indexing")


def segment_sum_kernel(ct, idx, m):
    """(m, k) segment sum of the (k, N) cotangent ``ct`` over ``idx``.

    CPU tensors go to the plain version.  CUDA tensors launch the kernel: it
    takes float32 or float64 ``ct`` (made contiguous in the (k, N) layout
    here) and int32 ``idx`` on one device, and raises on anything else.  An idx
    outside [0, m) adds nothing on the card, where the plain version
    raises.
    """
    if ct.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no segment sum for device {ct.device}")
    return torch.ops.tfrt_torch.segment_sum(ct, idx, int(m))


def launch(lib, ct, idx, m):
    """The (m, k) sum by the kernel of ``lib`` (``declare``) on checked,
    contiguous CUDA inputs with N >= 1, on the current stream, by the
    instance of ``ct``'s dtype; counts nothing."""
    k, n = ct.shape
    out = torch.empty((m, k), dtype=ct.dtype, device=ct.device)
    with torch.cuda.device(ct.device):
        work = torch.empty(
            lib.segment_sum_workspace(n, m, k, ct.element_size()),
            dtype=torch.uint8, device=ct.device)
        stream = torch.cuda.current_stream(ct.device).cuda_stream
        err = getattr(lib, LAUNCH[ct.dtype])(
            ct.data_ptr(), idx.data_ptr(), n, m, k, TILE, out.data_ptr(),
            work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    return out


def segment_sum_cuda(ct, idx, m):
    """K2's operator on CUDA tensors: the input checks and the launch."""
    global LAUNCHES
    _check_cuda_inputs(ct, idx, m)
    ct = ct.detach().contiguous()
    idx = idx.contiguous()
    if ct.shape[1] == 0:
        return torch.zeros((m, ct.shape[0]), dtype=ct.dtype,
                           device=ct.device)
    out = launch(load_library(), ct, idx, m)
    LAUNCHES += 1
    return out
