"""K2 on Hopper: the segment sum, backward of the engine's row gather.

``segment_sum_kernel(ct, idx, m)`` computes ``out[j] = sum over i with
idx[i] == j of ct[:, i]``: ``ct`` is the (k, N) float32 cotangent of the
transposed gathered rows, ``idx`` the (N,) int32 row of each ray in [0, m),
and the result the (m, k) gradient of the table.  On CUDA tensors it
launches the hand-written kernel in ``csrc/segment_sum.cu`` (port of
``_segsum_kernel`` in ``tensorflowraytrace_tpu/ops/pallas_kernels.py``) or
raises; it never falls back.  On CPU tensors it runs
``segment_sum_plain``, one ``index_add_``.

The kernel sums each warp's rays on one row with shuffles and the rest with
atomics, whose order changes from run to run: its result is not bitwise
reproducible, and it differs from the plain version by float32 rounding of
the partial sums.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflowraytrace_tpu_torch.ops import cuda_build

# Launches of the CUDA kernel in this process.  The wrapper adds one where it
# launches and nowhere else; callers reset it to 0 to count a run.
LAUNCHES = 0

SOURCE = "segment_sum.cu"


def load_library():
    """The kernel library, built at first use, with its C signatures
    declared."""
    lib = cuda_build.load(SOURCE)
    lib.segment_sum_launch.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.segment_sum_launch.restype = ctypes.c_int
    lib.segment_sum_branch.argtypes = [ctypes.c_int] * 2
    lib.segment_sum_branch.restype = ctypes.c_int
    return lib


def branch(m: int, k: int, device) -> str:
    """Which branch of the kernel an (m, k) table takes on ``device``:
    ``"shared"`` (a private table per block) or ``"global"``."""
    with torch.cuda.device(device):
        code = load_library().segment_sum_branch(m, k)
    return ("shared", "global")[code]


def segment_sum_plain(ct, idx, m):
    """The plain PyTorch version: ``zeros(m, k).index_add_(0, idx, ct.T)``
    in ``ct``'s dtype."""
    return torch.zeros((m, ct.shape[0]), dtype=ct.dtype,
                       device=ct.device).index_add_(0, idx.long(), ct.T)


def _check_cuda_inputs(ct, idx, m):
    if idx.device != ct.device:
        raise ValueError(f"idx is on {idx.device}, ct on {ct.device}")
    if ct.dtype != torch.float32:
        raise TypeError(f"the CUDA segment sum takes float32 only; ct is "
                        f"{ct.dtype}")
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
    takes float32 ``ct`` (made contiguous in the (k, N) layout here) and
    int32 ``idx`` on one device, and raises on anything else.  An idx
    outside [0, m) adds nothing on the card, where the plain version
    raises.
    """
    global LAUNCHES
    if ct.device.type == "cpu":
        return segment_sum_plain(ct, idx, m)
    if ct.device.type != "cuda":
        raise ValueError(f"no segment sum for device {ct.device}")
    _check_cuda_inputs(ct, idx, m)
    ct = ct.detach().contiguous()
    idx = idx.contiguous()
    k, n = ct.shape
    out = torch.zeros((m, k), dtype=torch.float32, device=ct.device)
    if n == 0:
        return out
    with torch.cuda.device(ct.device):
        stream = torch.cuda.current_stream(ct.device).cuda_stream
        err = load_library().segment_sum_launch(
            ct.data_ptr(), idx.data_ptr(), n, m, k, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
