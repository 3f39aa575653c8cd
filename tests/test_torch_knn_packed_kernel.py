"""The flat packed kNN kernel's launch geometry and the exactness of its
filtered selection, on the CPU. ``launch_geometry`` and ``smem_bytes`` are
pure Python; the kernel (``csrc/knn_packed.cu``) is held against the plain
version on the card (``tests/test_torch_cuda.py``).

The filter is what the kernel's speed rests on: a warp keeps each of its
queries' top keys in one list, visits the tiles of rows from the block's
own outward, takes a tile's keys 32 at a time and lets in only those above
the query's k-th key so far. The k-th largest key of any subset of a
query's rows is at most its final k-th key, so the lists must give the
plain selection whatever the shape, block size and visiting order."""

import re

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.knn_packed import (
    FUSED_TILE_ROWS,
    QUERIES_PER_BLOCK,
    SMALL_GRID,
    SMEM_LIMIT,
    THREADS,
    TILE_ROWS,
    knn_packed_plain,
    launch_geometry,
    packed_geometry,
    packed_keys,
    smem_bytes,
)

WIDTHS = (4, 8, 16, 32, 64)
INT_MIN = -(2 ** 31)


def _outward(t0: int, tiles: int) -> list[int]:
    """csrc/knn_packed.cu::outward: t0, t0 + 1, t0 - 1, t0 + 2, ..., then the
    rest of the longer side."""
    lo, hi = t0, tiles - 1 - t0
    m = min(lo, hi)
    order = []
    for i in range(tiles):
        if i <= 2 * m:
            order.append(t0 + (i + 1) // 2 if i % 2 else t0 - i // 2)
        else:
            order.append(t0 - (i - m) if lo > hi else t0 + (i - m))
    return order


def model_packed(x, k, qb, queries=None):
    """The kernel's selection in numpy: per block of ``qb`` queries the
    tiles of 256 rows from the block's own outward, each taken
    32 keys at a time; a key enters a query's list (its top keys) only
    above the list's k-th key as the batch begins. Returns (B, M, k)
    int32."""
    b, n, _ = x.shape
    q = x if queries is None else queries
    m = q.shape[1]
    n_pad, idx_bits = packed_geometry(n)
    keys = packed_keys(x, q, n_pad, idx_bits).numpy().astype(np.int64)  # (B, M, n_pad)
    tr = TILE_ROWS
    tiles = -(-n // tr)
    out = np.zeros((b, m, k), np.int64)
    for q0 in range(0, m, qb):
        kq = keys[:, q0:q0 + qb]
        top = np.full(kq.shape[:2] + (k,), INT_MIN, np.int64)
        t0 = min(tiles - 1, (q0 + qb // 2) * n // m // tr)
        for t in _outward(t0, tiles):
            for j in range(t * tr, min(t * tr + tr, n), 32):
                batch = kq[..., j:min(j + 32, n)]
                batch = np.where(batch > top[..., k - 1:], batch, INT_MIN)  # the filter
                top = -np.sort(-np.concatenate([top, batch], -1), -1)[..., :k]
        out[:, q0:q0 + qb] = n_pad - 1 - (top & ((1 << idx_bits) - 1))
    return torch.from_numpy(out).to(torch.int32)


@pytest.mark.parametrize("seed", range(25))
def test_filtered_selection_is_the_plain_selection(seed):
    """Random shapes (self-kNN and queries, ragged N, k up to 64, both block
    sizes) on small integers, where scores tie everywhere and only the
    keys' low bits order them."""
    rng = np.random.default_rng(seed)
    n, c = int(rng.integers(200, 1400)), int(rng.choice([3, 4, 8]))
    k = int(rng.integers(1, min(64, n) + 1))
    qb = int(rng.choice([64, 32]))
    x = torch.from_numpy(rng.integers(0, 8, (2, n, c)).astype(np.float32))
    if rng.integers(0, 2):  # x-sorted rows, as the model's points
        x = x.gather(1, x[..., :1].argsort(dim=1, stable=True).expand(-1, -1, c))
    q = (None if rng.integers(0, 2)
         else torch.from_numpy(rng.integers(0, 8, (2, int(rng.integers(1, 300)), c))
                               .astype(np.float32)))
    assert torch.equal(model_packed(x, k, qb, queries=q), knn_packed_plain(x, k, queries=q))


@pytest.mark.parametrize("cv", WIDTHS)
def test_launch_geometry_fits_every_shape_the_replaced_kernel_took(cv):
    """k <= 64 at any N <= 32768 and any M: the shared memory depends on
    the width only (the lists live in registers), and the fused kernel's
    two block sizes take the same."""
    for b, m in ((8, 7000), (1, 1001), (8, 200), (8, 1000), (1, 32768)):
        qb = launch_geometry(cv, b, m)
        assert qb == (32 if cv <= 8 and b * -(-m // 64) < SMALL_GRID else 64)
    assert smem_bytes(cv) <= SMEM_LIMIT
    assert TILE_ROWS * QUERIES_PER_BLOCK == 64 * THREADS  # 8 x 8 dots a thread
    assert FUSED_TILE_ROWS == TILE_ROWS  # the model's tiles are both kernels'
    assert packed_geometry(32768) == (32768, 15)


def score_bound(kth: int, idx_bits: int) -> float:
    """``csrc/knn_packed.cu::score_bound`` in Python: the float32 below which
    a score's packed key is below the key ``kth`` (its monotone int is
    below twice the key's score bits); -inf where there is none (an empty
    list, or no float counterpart). May be NaN, which drops nothing."""
    hi = kth & ~((1 << idx_bits) - 1)
    if kth == INT_MIN or hi <= -0x3FFFFFFF:
        return float("-inf")
    m = 2 * hi
    bits = m if m >= 0 else (0x80000000 | -m) - (1 << 32)
    return float(np.array(bits, np.int32).view(np.float32))


def test_score_bound_drops_only_keys_below_the_kth():
    """The fused kernel's prefilter: a score below ``score_bound(kth)`` has a
    packed key below ``kth`` whatever its index bits, on scores of every
    sign and size (zeros, infinities, NaN) and k-th keys made from them."""
    rng = np.random.default_rng(11)
    mags = 10.0 ** rng.uniform(-40, 38.5, 4000)
    scores = np.concatenate([rng.choice([-1.0, 1.0], 4000) * mags,
                             [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45]])
    scores = torch.from_numpy(scores.astype(np.float32))
    bits = scores.view(torch.int32)
    mono = torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))
    for idx_bits in (13, 15):
        keep = ~((1 << idx_bits) - 1)
        keys = ((mono >> 1) & keep).to(torch.int64)
        for kth in list(keys[rng.integers(0, len(keys), 200)].tolist()) + [INT_MIN]:
            kth = kth | int(rng.integers(0, 1 << idx_bits))  # any row's low bits
            kth = kth - (1 << 32) if kth >= 1 << 31 else kth
            bound = score_bound(kth, idx_bits)
            below = (scores < bound).numpy()
            # a dropped score's key, with the largest index bits, is below kth
            assert ((keys[below] | ((1 << idx_bits) - 1)) < kth).all(), (kth, bound)
            # and it is tight: its own monotone int is twice kth's score bits
            if kth != INT_MIN and not np.isnan(bound) and np.isfinite(bound):
                b_bits = int(np.array(bound, np.float32).view(np.int32))
                b_mono = b_bits if b_bits >= 0 else -(b_bits & 0x7FFFFFFF)
                assert b_mono == 2 * (kth & keep)


def test_smem_bytes_mirrors_the_source():
    src = (_build.CSRC / "knn_packed.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kThreads"]) == THREADS and int(const["kQB"]) == QUERIES_PER_BLOCK
    assert "kTileRows = 64 * kThreads / kQB;" in src and "kKeyStride = kTileRows + 8;" in src
    # C=64 (row stride 17 float4), 64 queries: queries + 256 rows, norms, the
    # key tile of 264 ints a query
    assert smem_bytes(64) == 16 * 320 * 17 + 4 * 256 + 4 * 64 * 264 == 155648
    # C <= 8: the fused kernel's two tiles of 256 rows (stride 1 float4 at C=4,
    # 3 at C=8) and their norms
    assert "constexpr int kFusedTileRows = 256;" in src
    assert smem_bytes(4) == 2 * 256 * (16 + 4) == 10240
    assert smem_bytes(8) == 2 * 256 * (16 * 3 + 4)
    # the packed forward's shapes: 64-query blocks
    assert launch_geometry(64, 8, 7000) == launch_geometry(4, 8, 7000) == 64
