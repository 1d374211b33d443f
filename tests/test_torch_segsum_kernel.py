"""The CUDA segment-sum kernel (K2) against its plain PyTorch version, on
the card.  The pytest form of phase 6 of chip_smoke.py.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_segsum_kernel.py -m cuda --noconftest
-o addopts="" -q``.

The kernel adds in the fixed order of its plain version (tiles of
``segsum_kernels.TILE`` rays, each row's rays in order within a tile, then
the tile sums in order), so it is held to the plain version bit for bit,
and two launches on the same inputs to each other.  Its distance to the
float64 sum stays within ``1e-5 S + 1e-7``, where ``S[j] = sum over
idx[i] == j of |ct[:, i]|`` bounds the rounding of any order of float32
additions.
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


def case(n, m, device, idx="random", seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    ct = torch.randn((K, n), generator=gen, device=device)
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
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check(ct, idx, m):
    before = sk.LAUNCHES
    got = sk.segment_sum_kernel(ct, idx, m)
    again = sk.segment_sum_kernel(ct, idx, m)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 2
    assert got.shape == (m, ct.shape[0]) and got.dtype == torch.float32
    plain = sk.segment_sum_plain(ct, idx, m)
    finite = torch.isfinite(plain)
    assert torch.equal(finite, torch.isfinite(got))
    assert torch.equal(torch.isnan(plain), torch.isnan(got))
    assert same_bits(got[finite], plain[finite])
    assert same_bits(got, again) or not bool(finite.all())
    ref64 = sk.segment_sum_plain(ct.double(), idx, m)
    bound = sk.segment_sum_plain(ct.double().abs(), idx, m) * 1e-5 + 1e-7
    assert bool(((got.double() - ref64).abs() <= bound)[finite].all())
    return got


@pytest.mark.parametrize("n,m,idx", [
    (2025, 770, "random"), (1 << 20, 770, "random"), (1 << 20, 4096, "random"),
    (5000, 16386, "random"), (5000, 16386, "coherent"), (1 << 20, 770, "same"),
    (1, 1, "random"), (1000, 333, "random"),
])
def test_kernel_matches_float64(cuda, n, m, idx):
    check(*case(n, m, cuda, idx), m)


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
        sk.segment_sum_kernel(ct.double(), idx, 10)
    with pytest.raises(TypeError):
        sk.segment_sum_kernel(ct, idx.long(), 10)
    with pytest.raises(ValueError, match="is on"):
        sk.segment_sum_kernel(ct, idx.cpu(), 10)
    with pytest.raises(ValueError, match="must be"):
        sk.segment_sum_kernel(ct, idx[:10], 10)
