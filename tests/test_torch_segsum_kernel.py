"""The CUDA segment-sum kernel (K2) against its plain PyTorch version, on
the card.  The pytest form of phase 6 of chip_smoke.py.

Every test here needs an NVIDIA GPU with CUDA and nvcc: they are marked
``cuda`` and skip without one.  Run them on the card with
``python -m pytest tests/test_torch_segsum_kernel.py -m cuda --noconftest
-o addopts="" -q``.

The kernel adds in the fixed order of its plain version (tiles of
``segsum_kernels.TILE`` rays, each row's rays in order within a tile,
then the tile sums in order), so it is held to the plain version bit for
bit (every entry that is not NaN; NaN where the plain version has NaN),
and launches on the same inputs to each other bit for bit (ten at the
edges of its strategies, at the histogram shape and in float64).  Its
float32 distance to the float64 sum stays within ``1e-5 S + 1e-7``, where
``S[j] = sum over idx[i] == j of |ct[:, i]|`` bounds the rounding of any
order of float32 additions.  The edges: the rows' record counts either
side of where the row pass changes strategy (a warp's row against its
block's at ``WARP_IDS`` records, a warp's folds of 32 records, a block a
row against a warp a row at ``WARP_ROWS_MIN`` rows), the tile bitmap's
word boundary, a chunk's cap of ``CHUNK`` rays, a row in every tile of
2^22 rays, an idx out of range, ragged ray counts and -0.0, NaN and inf
cotangents.  The float64 instance is held at every shape of the float32
cases and at the caustic image's histogram shape (k = 1, 512 x 512 bins,
2^22 rays), and on a table of 2^24 rows (64-bit sort keys); the
histograms (``analysis.histogram2d``, ``soft_histogram2d``) launch it and
equal their CPU results bit for bit.  The workspace grows with the rays of
a chunk and the rows, not with their product.
"""

import numpy as np
import pytest
import torch

from tensorflowraytrace_tpu_torch.engine import _gather_rows_t
from tensorflowraytrace_tpu_torch.ops import segsum_kernels as sk

pytestmark = pytest.mark.cuda
K = 13
# csrc/segment_sum.cu's kWarpIds, kWarpRowsMin and kChunkTiles * kTile
WARP_IDS = 256
WARP_ROWS_MIN = 4096
CHUNK = 8192 * sk.TILE


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
    assert all(same_bits(got, r) for r in runs)
    plain = sk.segment_sum_plain(ct, idx, m)
    nan = torch.isnan(plain)
    assert torch.equal(nan, torch.isnan(got))
    assert same_bits(got[~nan], plain[~nan])
    finite = torch.isfinite(plain)
    if ct.dtype == torch.float32:
        ref64 = sk.segment_sum_plain(ct.double(), idx, m)
        bound = sk.segment_sum_plain(ct.double().abs(), idx, m) * 1e-5 + 1e-7
        assert bool(((got.double() - ref64).abs() <= bound)[finite].all())
    return got


def check_dropped(ct, idx, m, launches=10):
    """``check`` where idx may leave [0, m): the kernel drops those rays;
    the plain version, which raises on them, is given +0 cotangents on
    row 0 in their place (the same tiles, the same sums)."""
    before = sk.LAUNCHES
    got = sk.segment_sum_kernel(ct, idx, m)
    runs = [sk.segment_sum_kernel(ct, idx, m) for _ in range(launches - 1)]
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + launches
    assert all(same_bits(got, r) for r in runs)
    keep = (idx >= 0) & (idx < m)
    want = sk.segment_sum_plain(torch.where(keep, ct, 0.0),
                                torch.where(keep, idx, 0), m)
    assert same_bits(got, want)
    return got


def rows_in_tiles(n, m, counts, device, seed=0):
    """(N,) int32 rows of n rays: row ``r`` of ``counts`` in exactly
    ``counts[r]`` tiles (the first ray of each of its first tiles), every
    other ray on a random row not in ``counts``."""
    gen = torch.Generator(device).manual_seed(seed)
    free = torch.tensor(sorted(set(range(m)) - set(counts)), device=device)
    idx = free[torch.randint(0, len(free), (n,), generator=gen,
                             device=device)]
    for slot, (row, tiles) in enumerate(counts.items()):
        assert tiles * sk.TILE <= n
        idx[slot::sk.TILE][:tiles] = row
    return idx.to(torch.int32)


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
def test_large_table(cuda, dtype):
    """A table of 2^24 bins (past 2^22 rows the tile pass sorts 64-bit
    keys) and 2^18 rays, half of them on 1000 rows spread over the table,
    so that rows recur in most tiles: the same bits as the plain version."""
    n, m = 1 << 18, 1 << 24
    gen = torch.Generator(cuda).manual_seed(3)
    w = torch.randn((1, n), generator=gen, device=cuda, dtype=dtype)
    spread = torch.randint(0, 1000, (n // 2,), generator=gen, device=cuda)
    idx = torch.cat([spread * (m // 1000),
                     torch.randint(0, m, (n - n // 2,), generator=gen,
                                   device=cuda)])
    idx = idx[torch.randperm(n, generator=gen, device=cuda)]
    check(w, idx.to(torch.int32), m, launches=3)


def test_workspace_is_records_plus_rows(cuda):
    """The workspace holds (e k + 6) bytes a ray of a chunk, 4 bytes a
    tile, 8 bytes a row and 16 KiB, each of its eight parts rounded up to
    16 bytes, whatever m N is; the caustic image's histogram (2^22 rays,
    512 x 512 bins) needs under 64 MiB in both dtypes."""
    lib = sk.load_library()
    for n, m, k in ((1 << 18, 1 << 24, 1), (1 << 22, 1 << 20, 1),
                    (1 << 22, 512 * 512, 1), (1 << 20, 770, 13),
                    (CHUNK + 5000, 1000, 4), (1, 1, 13)):
        for e in (4, 8):
            rays = -(-min(n, CHUNK) // sk.TILE) * sk.TILE
            assert lib.segment_sum_workspace(n, m, k, e) <= (
                rays * (e * k + 6) + 4 * rays // sk.TILE + 8 * m + 4
                + (1 << 14) + 8 * 16)
    for e in (4, 8):
        assert lib.segment_sum_workspace(1 << 22, 512 * 512, 1, e) < 64 << 20


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [4000, 16384])
@pytest.mark.parametrize("k", [1, 5])
def test_record_counts_at_the_strategy_edges(cuda, dtype, m, k):
    """Rows held by 31-33 and 255-257 tiles (a warp's fold of 32 records at
    a time; a warp's row against its block's), below and past
    ``WARP_ROWS_MIN`` rows (a block a row against a warp a row), over 300
    tiles and a ragged last one; ten launches."""
    n = 300 * sk.TILE + 77
    counts = {11: 31, 12: 32, 13: 33, 20: WARP_IDS - 1, 21: WARP_IDS,
              22: WARP_IDS + 1, 30: 300}
    gen = torch.Generator(cuda).manual_seed(m + k)
    ct = torch.randn((k, n), generator=gen, device=cuda, dtype=dtype)
    check(ct, rows_in_tiles(n, m, counts, cuda), m, launches=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tiles", [32, 33])
def test_tile_bitmap_word_edge(cuda, dtype, tiles):
    """A row in every tile where the tiles fill one bitmap word, and one
    past it (33 tiles, the last one ray); both row passes."""
    n = (tiles - 1) * sk.TILE + (sk.TILE if tiles == 32 else 1)
    for m in (100, WARP_ROWS_MIN):
        gen = torch.Generator(cuda).manual_seed(tiles + m)
        ct = torch.randn((3, n), generator=gen, device=cuda, dtype=dtype)
        idx = torch.randint(0, m, (n,), generator=gen, device=cuda)
        idx[::sk.TILE] = 7
        check(ct, idx.to(torch.int32), m, launches=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1000, 16384])
def test_chunk_cap(cuda, dtype, m):
    """Past a chunk's cap: ``CHUNK`` + 3 tiles + 5 rays, a row in every
    tile (one chunk's bitmap full), summed in two chunks, the second
    continuing every row's sum; ten launches."""
    n = CHUNK + 3 * sk.TILE + 5
    gen = torch.Generator(cuda).manual_seed(m)
    ct = torch.randn((1, n), generator=gen, device=cuda, dtype=dtype)
    idx = torch.randint(0, m, (n,), generator=gen, device=cuda)
    idx[5::sk.TILE] = m - 1
    check(ct, idx.to(torch.int32), m, launches=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,k", [(770, 13), (512 * 512, 1)])
def test_row_in_every_tile_of_2_22_rays(cuda, dtype, m, k):
    """One row in all 4096 tiles of 2^22 rays (4096 records: a block's
    row in either row pass), the rest random; ten launches."""
    n = 1 << 22
    gen = torch.Generator(cuda).manual_seed(k)
    ct = torch.randn((k, n), generator=gen, device=cuda, dtype=dtype)
    idx = torch.randint(0, m, (n,), generator=gen, device=cuda)
    idx[sk.TILE // 2::sk.TILE] = 3
    check(ct, idx.to(torch.int32), m, launches=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [500, WARP_ROWS_MIN])
def test_out_of_range_rows_are_dropped(cuda, dtype, m):
    """Rays below 0 and at or past m add nothing, in the middle of tiles
    and on a ragged last tile (n % 1024 != 0); a tile of dropped rays
    only; ten launches."""
    n = (1 << 16) + 333
    gen = torch.Generator(cuda).manual_seed(m)
    ct = torch.randn((4, n), generator=gen, device=cuda, dtype=dtype)
    idx = torch.randint(0, m, (n,), generator=gen, device=cuda)
    idx[::7] = -1
    idx[3::7] = m
    idx[5::11] = 2 ** 31 - 1
    idx[sk.TILE:2 * sk.TILE] = -5
    check_dropped(ct, idx.to(torch.int32), m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [90, WARP_ROWS_MIN])
def test_negative_zero_nan_and_inf(cuda, dtype, m):
    """-0.0 cotangents (a row of -0 alone sums to +0), +inf and -inf (NaN
    where a row meets both) and NaN, on a ragged ray count; each entry
    that is not NaN bit for bit, NaN where the plain version has it; ten
    launches."""
    n = 5 * sk.TILE + 17
    gen = torch.Generator(cuda).manual_seed(m)
    ct = torch.randn((4, n), generator=gen, device=cuda, dtype=dtype)
    idx = torch.randint(0, m, (n,), generator=gen, device=cuda).int()
    idx[[100, 2000]] = 8
    idx[[300, 301]] = 9
    idx[4000] = 10
    ct[:, ::3] = -0.0
    ct[:, idx == 7] = -0.0
    ct[1, 100] = float("inf")
    ct[1, 2000] = float("inf")
    ct[2, 300] = float("inf")
    ct[2, 301] = -float("inf")
    ct[3, 4000] = float("nan")
    got = check(ct, idx, m, launches=10)
    assert not bool(torch.signbit(got[7]).any())
    assert float(got[8, 1]) == float("inf")
    assert bool(torch.isnan(got[9, 2])) and bool(torch.isnan(got[10, 3]))


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
    check_dropped(ct, idx, 500, launches=2)


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
