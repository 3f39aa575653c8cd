"""The exact banded kNN kernel's launch geometry and the exactness of its
decomposition, on the CPU. ``launch_geometry`` and ``smem_bytes`` are pure
Python; the kernel (``csrc/knn_exact_banded.cu``) is held against the plain
version on the card (``tests/test_torch_cuda.py``).

The decomposition is what the kernel rests on: each (query, window) list
takes its window's rows in ascending order and admits a candidate only
where its key is strictly above the list's cap-th (so among equal keys the
lower row stays ahead), lists may be built from any split of a window's
rows into parts and joined in (key desc, row asc) order, and the merge
pops the largest key, then the lowest row among the heads holding it. On
integer-valued inputs keys repeat everywhere; the model must give the
plain version's indices, k-th keys and overflow flags, short windows and
padding rows included."""

import re

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels import knn_exact_banded as keb
from dgcnn_tpu_torch.kernels.knn_banded import band_starts
from dgcnn_tpu_torch.kernels.knn_exact_banded import (
    FUSED_QUERIES_PER_BLOCK,
    FUSED_TILE_ROWS,
    MAX_WINDOWS,
    QUERIES_PER_BLOCK,
    SMEM_LIMIT,
    TILE_ROWS,
    exact_query_tile,
    knn_exact_banded_raw_plain,
    launch_block,
    launch_geometry,
    smem_bytes,
)

WIDTHS = (4, 8, 16, 32, 64)
INT_MIN = -(2 ** 31)


def _insert_lists(keys, rows, cap):
    """The kernel's list insertion over candidates in the given order:
    ``keys`` (Q, L, n) int64 and ``rows`` (n,) in-window rows; returns the
    (Q, L, cap) keys and rows, empty slots (INT_MIN, row 0)."""
    q, lists, n = keys.shape
    tk = np.full((q, lists, cap), INT_MIN, np.int64)
    ts = np.zeros((q, lists, cap), np.int64)
    for j in range(n):
        v = keys[..., j]
        ck, cs = v.copy(), np.full((q, lists), rows[j], np.int64)
        for i in range(cap):  # from the first strictly smaller key on, all move down
            sw = v > tk[..., i]
            k0, s0 = tk[..., i].copy(), ts[..., i].copy()
            tk[..., i] = np.where(sw, ck, k0)
            ts[..., i] = np.where(sw, cs, s0)
            ck, cs = np.where(sw, k0, ck), np.where(sw, s0, cs)
    return tk, ts


def _lex_top(keys, rows, count):
    """The ``count`` first (key, row) pairs in (key desc, row asc) order along
    the last axis."""
    order = np.lexsort((rows, -keys), axis=-1)[..., :count]
    return np.take_along_axis(keys, order, -1), np.take_along_axis(rows, order, -1)


def model_raw(x, k, *, band, n_win, cap, query_tile, parts=1, rng=None):
    """The kernel's selection in numpy: per query tile the band's keys (the
    plain version's arithmetic), per window the rows split into ``parts``
    (random, each in ascending order) whose lists are built by insertion
    and joined by (key desc, row asc), then the lexicographic merge pop by
    pop. Returns (idx, kth, ovf) as the kernel does."""
    b, n, _ = x.shape
    n_pad = -(-n // 128) * 128
    qt = query_tile
    xf = x.float()
    cn = (xf * xf).sum(-1)
    xp = torch.nn.functional.pad(xf, (0, 0, 0, n_pad - n))
    cnp = torch.nn.functional.pad(cn, (0, n_pad - n))
    w_sz = band // n_win
    keys, starts = [], []  # every query tile's band keys, stacked: (B * queries, band)
    for i, s0 in enumerate(band_starts(-(-n // qt) * qt, qt, n_pad, band)):
        q = xf[:, i * qt:(i + 1) * qt]
        sc = 2.0 * torch.matmul(q, xp[:, s0:s0 + band].transpose(1, 2)) - cnp[:, None, s0:s0 + band]
        if s0 + band > n:
            sc[..., n - s0:] = float("-inf")
        keys.append(keb._key(sc).numpy().astype(np.int64))
        starts.append(np.full(q.shape[1], s0))
    m = sum(kk.shape[1] for kk in keys)
    key = np.concatenate(keys, 1).reshape(b * m, w_sz, n_win).transpose(0, 2, 1)  # (Q, w, s)
    start = np.tile(np.concatenate(starts), b)
    owner = (rng.integers(0, parts, w_sz) if rng is not None and parts > 1
             else np.zeros(w_sz, np.int64))
    part_k, part_s = [], []
    for p in range(parts):
        sel = np.flatnonzero(owner == p)  # ascending rows of part p
        tk, ts = _insert_lists(key[..., sel], sel, cap)
        part_k.append(tk)
        part_s.append(ts)
    lk, ls = _lex_top(np.concatenate(part_k, -1), np.concatenate(part_s, -1), cap)
    rows = ls * n_win + np.arange(n_win)[None, :, None]  # band rows
    cap_max = lk[..., cap - 1].max(-1)
    # the merge: pop the largest key, then the lowest row holding it
    heads = np.zeros((b * m, n_win), np.int64)
    idx = np.zeros((b * m, k), np.int64)
    kth = np.zeros(b * m, np.int64)
    qi = np.arange(b * m)
    for t in range(k):
        at = np.minimum(heads, cap - 1)[..., None]
        hk = np.where(heads < cap, np.take_along_axis(lk, at, -1)[..., 0], INT_MIN)
        hr = np.take_along_axis(rows, at, -1)[..., 0]
        bk = hk.max(-1)
        br = np.where(hk == bk[:, None], hr, np.iinfo(np.int64).max).min(-1)
        heads[qi, np.argmax((hk == bk[:, None]) & (hr == br[:, None]), -1)] += 1
        idx[:, t], kth = start + br, bk
    as_t = lambda a: torch.from_numpy(a.reshape(b, m, *a.shape[1:])[:, :n]).to(torch.int32)  # noqa: E731
    return as_t(idx), as_t(kth), as_t((cap_max >= kth).astype(np.int64))


def _random_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(300, 1300))
    n_pad = -(-n // 128) * 128
    c = int(rng.choice([3, 4, 8]))
    n_win = int(rng.choice([16, 32, 64]))
    cap = int(rng.choice([4, 8]))
    bands = [bd for bd in range(128, n_pad + 1, 128) if bd % n_win == 0]
    band = int(rng.choice(bands))
    qt = int(rng.choice([q for q in (32, 64, 128, 256) if q <= band]))
    k = int(min(n_win * cap, band, n, rng.integers(4, 31)))
    sort = bool(rng.integers(0, 2))
    x = rng.integers(0, 8, (2, n, c)).astype(np.float32)
    if sort:
        x = np.take_along_axis(x, np.argsort(x[..., 0], 1, kind="stable")[..., None], 1)
    return (torch.from_numpy(np.ascontiguousarray(x)), k,
            dict(band=band, n_win=n_win, cap=cap, query_tile=qt), rng)


@pytest.mark.parametrize("seed", range(25))
def test_split_lists_and_lexicographic_merge_are_the_plain_selection(seed):
    """Random shapes on integers (ties everywhere), windows shorter than cap
    (band / n_win < cap) and padding rows included: lists built over any
    split of each window's rows, joined and merged by (key desc, row asc),
    give the plain version's three outputs."""
    x, k, kw, rng = _random_case(seed)
    want = knn_exact_banded_raw_plain(x, k, **kw)
    got = model_raw(x, k, parts=int(rng.integers(1, 4)), rng=rng, **kw)
    for name, g, w in zip(("idx", "kth", "ovf"), got, want):
        assert torch.equal(g, w), (name, kw, k)


def test_model_covers_short_windows_and_padding_rows():
    """The edge cases the kernel must reproduce bit for bit: windows of 2
    rows under cap 8 (their empty slots hold (INT_MIN, the first row)) and a
    band whose last rows are padding (their keys, of -inf, enter lists)."""
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 4, (1, 1000, 3)).astype(np.float32))
    for kw in (dict(band=128, n_win=64, cap=8, query_tile=128),
               dict(band=1024, n_win=64, cap=4, query_tile=64)):
        want = knn_exact_banded_raw_plain(x, 20, **kw)
        got = model_raw(x, 20, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (want[1] > INT_MIN).all()


@pytest.mark.parametrize("cv", WIDTHS)
@pytest.mark.parametrize("cap", [4, 8])
def test_launch_geometry_fits_wherever_the_replaced_kernel_did(cv, cap):
    """Every (n_win <= 64, query tile a multiple of 32) that the replaced
    kernel took fits; the geometry does not depend on the band, so a
    launch valid at ``band`` is valid at ``n_pad`` (the device flag's full
    width) for every N <= 32768."""
    for n_win in (1, 2, 4, 8, 16, 32, 64):
        assert smem_bytes(cv, n_win, cap) <= SMEM_LIMIT
        for qt in range(32, 513, 32):
            qb = launch_geometry(cv, n_win, cap, qt)
            assert qb == launch_block(cv) and qt % qb == 0
            assert qb == (FUSED_QUERIES_PER_BLOCK if cv <= 8 else QUERIES_PER_BLOCK)
    for n in (130, 1001, 4500, 7000, 16385, 32768):
        n_pad = -(-n // 128) * 128
        assert n_pad // 64 <= 65536 and n_pad % 64 == 0  # rows a window as uint16


def test_wrapper_query_tiles_are_multiples_of_the_block():
    """``exact_query_tile`` (clamped to the band by the wrapper) is always a
    multiple of the kernel's 32-query block (and of the fused kernel's 16),
    so a block's queries share one band start."""
    for n in (200, 1001, 4500, 7000, 16385, 32768, 50000):
        n_pad = -(-n // 128) * 128
        for band in (128, 512, 2048, 4096, n_pad):
            for n_win, cap in ((16, 8), (64, 8), (64, 4)):
                qt = min(exact_query_tile(n_pad, band, n_win, cap), band)
                assert qt % QUERIES_PER_BLOCK == 0 and qt % FUSED_QUERIES_PER_BLOCK == 0


def test_launch_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 32"):
        launch_geometry(4, 64, 8, 48)
    with pytest.raises(ValueError, match="n_win <= 64"):
        launch_geometry(4, 128, 8, 256)


def test_smem_bytes_mirrors_the_source():
    """The Python constants are the kernel's, and the production shapes'
    shared memory is the source's formula evaluated by hand."""
    src = (_build.CSRC / "knn_exact_banded.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kQB"]) == QUERIES_PER_BLOCK
    assert 8 * int(const["kTX"]) == TILE_ROWS and int(const["kSlots"]) == MAX_WINDOWS
    assert int(const["kFQB"]) == FUSED_QUERIES_PER_BLOCK
    assert int(const["kFJT"]) * int(const["kSlots"]) == FUSED_TILE_ROWS
    assert "kFThreads = kFQB * kSlots / kFQM;" in src
    assert "kTileRows + 8" in src and "6 * (size_t)(fused ? kFQB : kQB) * n_win * (cap + 1)" in src
    assert "2 * (size_t)kFTileRows * (16 * xs4 + 4)" in src
    # C=64 (row stride 17 float4): queries + 512 rows, norms, the key tile
    assert smem_bytes(64, 64, 8) == 16 * 544 * 17 + 4 * 512 + 4 * 32 * 520 == 216576
    # C=4 (the fused kernel, 16 queries): the lists (keys and uint16 rows, 9
    # slots) outweigh the two tiles of 1024 rows (stride 1 float4) and norms
    assert smem_bytes(4, 64, 8) == 6 * 16 * 64 * 9 == 55296
    assert smem_bytes(4, 16, 4) == 2 * 1024 * (16 + 4) == 40960  # the staging, past the lists
    assert smem_bytes(8, 64, 8) == 2 * 1024 * (16 * 3 + 4) == 106496  # stride 3 at C=8
    assert launch_geometry(64, 64, 8, 256) == 32 and launch_geometry(4, 64, 8, 256) == 16
