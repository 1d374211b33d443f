"""The CUDA segment-sum kernel (K2) against its plain PyTorch version, on
the card.  The pytest form of phase 6 of chip_smoke.py.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_segsum_kernel.py -m cuda --noconftest
-o addopts="" -q``.

The kernel adds in the fixed order of its plain version (tiles of
``segsum_kernels.TILE`` rays, each row's rays in order within a tile, then
the tile sums in order), so it is held to the plain version bit for bit,
and two launches on the same inputs to each other (ten at the histogram
shape and in float64).  Its float32 distance to the float64 sum stays
within ``1e-5 S + 1e-7``, where ``S[j] = sum over idx[i] == j of
|ct[:, i]|`` bounds the rounding of any order of float32 additions.  The
float64 instance is held at every shape of the float32 cases and at the
caustic image's histogram shape (k = 1, 512 x 512 bins, 2^22 rays), and
past the workspace's limit, where the kernel sums its rays in chunks; the
histograms (``analysis.histogram2d``, ``soft_histogram2d``) launch it and
equal their CPU results bit for bit.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch.engine import _gather_rows_t
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

pytestmark = pytest.mark.cuda
K = 13


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def case(n, m, device, idx="random", seed=0, dtype=torch.float32, k=K):
    gen = torch.Generator(device).manual_seed(seed)
    ct = torch.randn((k, n), generator=gen, device=device, dtype=dtype)
    if idx == "random":
        ids = torch.randint(0, m, (n,), generator=gen, device=device)
    elif idx == "coherent":
        base = torch.randint(0, m - 40, (n // 100 + 1,), generator=gen,
                             device=device).repeat_interleave(100)[:n]
        ids = base + torch.randint(0, 40, (n,), generator=gen, device=device)
    else:  # every ray on one row
        ids = torch.full((n,), m // 2, device=device)
    return ct, ids.to(torch.int32)


def same_bits(a, b):
    raw = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(raw), b.view(raw))


def check(ct, idx, m, launches=2):
    before = sk.LAUNCHES
    got = sk.segment_sum_kernel(ct, idx, m)
    runs = [sk.segment_sum_kernel(ct, idx, m) for _ in range(launches - 1)]
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + launches
    assert got.shape == (m, ct.shape[0]) and got.dtype == ct.dtype
    plain = sk.segment_sum_plain(ct, idx, m)
    finite = torch.isfinite(plain)
    assert torch.equal(finite, torch.isfinite(got))
    assert torch.equal(torch.isnan(plain), torch.isnan(got))
    assert same_bits(got[finite], plain[finite])
    assert all(same_bits(got, r) for r in runs) or not bool(finite.all())
    if ct.dtype == torch.float32:
        ref64 = sk.segment_sum_plain(ct.double(), idx, m)
        bound = sk.segment_sum_plain(ct.double().abs(), idx, m) * 1e-5 + 1e-7
        assert bool(((got.double() - ref64).abs() <= bound)[finite].all())
    return got


SHAPES = [
    (2025, 770, "random"), (1 << 20, 770, "random"), (1 << 20, 4096, "random"),
    (5000, 16386, "random"), (5000, 16386, "coherent"), (1 << 20, 770, "same"),
    (1, 1, "random"), (1000, 333, "random"),
]


@pytest.mark.parametrize("n,m,idx", SHAPES)
def test_kernel_matches_float64(cuda, n, m, idx):
    check(*case(n, m, cuda, idx), m)


@pytest.mark.parametrize("n,m,idx", SHAPES)
def test_float64_instance_matches_plain(cuda, n, m, idx):
    check(*case(n, m, cuda, idx, dtype=torch.float64), m, launches=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_histogram_shape(cuda, dtype):
    """The caustic image's sum: 2^22 weights into 512 x 512 bins, the bins
    of a blurred spot (many rays a bin, some bins empty), ten launches."""
    n, m = 1 << 22, 512 * 512
    gen = torch.Generator(cuda).manual_seed(7)
    w = torch.rand((1, n), generator=gen, device=cuda, dtype=dtype)
    xy = (torch.randn((2, n), generator=gen, device=cuda) * 90 + 256).long()
    idx = (xy.clamp(0, 511) * torch.tensor([[512], [1]], device=cuda)).sum(0)
    check(w, idx.to(torch.int32), m, launches=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunks_past_the_mask_limit(cuda, dtype):
    """A table whose masks and counts would pass the kernel's 256 MiB
    (2^24 bins, 2^18 rays: m N / 4096 = 1 GiB) is summed in four chunks
    of 2^16 rays, each continuing the rows' sums of the one before: the
    same bits as the plain version, with half the rays on 1000 rows spread
    over the table, so that rows recur in every chunk.  The workspace stays
    within 256 MiB and 16 bytes a ray of a chunk and a row."""
    n, m = 1 << 18, 1 << 24
    gen = torch.Generator(cuda).manual_seed(3)
    w = torch.randn((1, n), generator=gen, device=cuda, dtype=dtype)
    spread = torch.randint(0, 1000, (n // 2,), generator=gen, device=cuda)
    idx = torch.cat([spread * (m // 1000),
                     torch.randint(0, m, (n - n // 2,), generator=gen,
                                   device=cuda)])
    idx = idx[torch.randperm(n, generator=gen, device=cuda)]
    check(w, idx.to(torch.int32), m, launches=3)
    lib = sk.load_library()
    for n_big, m_big in ((n, m), (1 << 22, 1 << 20)):
        chunk = max(1, (1 << 28) // (8 * m_big)) * 32 * sk.TILE
        assert lib.segment_sum_workspace(n_big, m_big, 1, 8) <= (
            (1 << 28) + 16 * min(chunk, n_big) + 16 * m_big)


def test_histograms_launch_the_kernel(cuda):
    """histogram2d and soft_histogram2d on CUDA tensors launch K2, once
    each, and equal the same histograms with K2's plain version swapped in
    bit for bit; their gradients reach the weights."""
    from tensorflowraytrace_tpu_torch import analysis

    gen = torch.Generator(cuda).manual_seed(1)
    x, y = torch.randn((2, 100_000), generator=gen, device=cuda) * 0.3
    w = torch.rand(100_000, generator=gen, device=cuda).requires_grad_(True)
    rng = ((-1.0, 1.0), (-1.0, 1.0))
    for fn in (analysis.histogram2d, analysis.soft_histogram2d):
        before = sk.LAUNCHES
        h = fn(x, y, rng, 64, 48, weights=w)
        assert sk.LAUNCHES == before + 1
        kernel, sk.segment_sum_kernel = (sk.segment_sum_kernel,
                                         sk.segment_sum_plain)
        try:
            h_plain = fn(x, y, rng, 64, 48, weights=w.detach())
        finally:
            sk.segment_sum_kernel = kernel
        assert sk.LAUNCHES == before + 1
        assert same_bits(h.detach(), h_plain)
        (g,) = torch.autograd.grad(torch.sum(h * h), w)
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_branches(cuda):
    """Small and large tables, k = 1 to 40 (past the 16 columns a tile
    stages at a time), and rays below, at and past a tile: every shape
    adds in the same order."""
    for n, m, k in ((1023, 770, 13), (1024, 770, 4), (1025, 16386, 13),
                    (70000, 3, 1), (9000, 100, 17), (5000, 64, 40)):
        gen = torch.Generator(cuda).manual_seed(n + m + k)
        ct = torch.randn((k, n), generator=gen, device=cuda)
        idx = torch.randint(0, m, (n,), generator=gen, device=cuda)
        check(ct, idx.to(torch.int32), m)


def test_ten_launches_are_identical(cuda):
    ct, idx = case(1 << 20, 770, cuda)
    first = sk.segment_sum_kernel(ct, idx, 770)
    for _ in range(9):
        assert same_bits(sk.segment_sum_kernel(ct, idx, 770), first)


def test_warp_lanes_split_over_two_and_three_rows(cuda):
    """Warps whose lanes share 2 rows in halves, 3 rows in runs of 11, or
    3 rows interleaved (lane % 3, lane 1 on lane 0's row, so that
    neighbouring lanes share a row and the groups are not contiguous):
    every group sums over several lanes.  The ray count is no multiple of
    a warp or of 4."""
    n = 4096 * 8 + 7
    ct, _ = case(n, 300, cuda)
    i = torch.arange(n, device=cuda)
    warp, lane = i // 32, i % 32
    interleaved = torch.where(lane == 1, 0, lane % 3)
    split = torch.where(warp % 3 == 0, lane // 16,
                        torch.where(warp % 3 == 1, lane // 11, interleaved))
    check(ct, ((warp % 50) * 3 + split).to(torch.int32), 300)


def test_shared_limit_and_one_row_past_it(cuda):
    """The tables either side of the old kernel's shared-memory limit at
    k = 13 (4470 rows of 52 bytes in 232,448), and rows out of range,
    which add nothing."""
    for m in (4470, 4471):
        check(*case(1 << 18, m, cuda), m)
    ct, idx = case(1 << 16, 500, cuda)
    idx[::7] = -1
    idx[3::7] = 500
    got = sk.segment_sum_kernel(ct, idx, 500)
    # the same tiles, with the dropped rays' cotangents +0 on row 0
    keep = (idx >= 0) & (idx < 500)
    want = sk.segment_sum_plain(torch.where(keep, ct, 0.0),
                                torch.where(keep, idx, 0), 500)
    assert same_bits(got, want)


def test_all_zero_and_nan_cotangents(cuda):
    """All-zero cotangents give +0 everywhere; a NaN reaches its row and
    column and no other, one_row's contention and the random case
    alike."""
    for m, idx in ((770, "same"), (770, "random")):
        ct, ids = case(1 << 16, m, cuda, idx)
        zero = sk.segment_sum_kernel(torch.zeros_like(ct), ids, m)
        assert torch.equal(zero, torch.zeros_like(zero))
        assert not bool(torch.signbit(zero).any())
        ct[2, 5] = float("nan")
        got = check(ct, ids, m)
        nan = torch.zeros_like(got, dtype=torch.bool)
        nan[int(ids[5]), 2] = True
        assert torch.equal(torch.isnan(got), nan)


def test_guide2d_backward_shape(cuda):
    """The 2D guide's arc gather backward: 512 rows, k = 4, most rays
    with a zero cotangent on the clamped last row."""
    gen = torch.Generator(cuda).manual_seed(3)
    n, m = 1 << 20, 512
    ct = torch.randn((4, n), generator=gen, device=cuda)
    hit = torch.rand((n,), generator=gen, device=cuda) < 0.1
    rows = torch.randint(0, m, (n,), generator=gen, device=cuda)
    ct[:, ~hit] = 0.0
    check(ct, torch.where(hit, rows, m - 1).to(torch.int32), m)


def test_zero_cotangents_sum_to_zero(cuda):
    ct, idx = case(4096, 770, cuda)
    ct[-1] = 0.0
    got = check(ct, idx, 770)
    assert bool((got[:, -1] == 0).all())
    unused = torch.ones(770, dtype=torch.bool, device=cuda)
    unused[idx.long()] = False
    assert bool((got[unused] == 0).all())


def test_gather_backward_launches_the_kernel(cuda):
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.normal(0, 1, (770, K)), dtype=torch.float32,
                            device=cuda)
    idx = torch.as_tensor(rng.integers(0, 770, 5000), dtype=torch.int32,
                          device=cuda)
    w = torch.as_tensor(rng.normal(0, 1, (K, 5000)), dtype=torch.float32,
                        device=cuda)
    grads = []
    for use_kernel in (True, False):
        t = table.clone().requires_grad_(True)
        before = sk.LAUNCHES
        torch.sum(w * _gather_rows_t(t, idx, use_kernel) ** 2).backward()
        assert sk.LAUNCHES == before + int(use_kernel)
        grads.append(t.grad)
    assert same_bits(grads[0], grads[1])


def test_kernel_refuses_what_it_cannot_take(cuda):
    ct, idx = case(64, 10, cuda)
    with pytest.raises(TypeError):
        sk.segment_sum_kernel(ct.half(), idx, 10)
    with pytest.raises(TypeError):
        sk.segment_sum_kernel(ct, idx.long(), 10)
    with pytest.raises(ValueError, match="is on"):
        sk.segment_sum_kernel(ct, idx.cpu(), 10)
    with pytest.raises(ValueError, match="must be"):
        sk.segment_sum_kernel(ct, idx[:10], 10)
