"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips (with its reason) where no CUDA device
is visible, as on a CPU-only machine. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels.edgeconv_fused import (
    edgeconv_fused_extrema,
    edgeconv_fused_extrema_plain,
    edgeconv_fused_stage,
    edgeconv_fused_stage_bf16,
    edgeconv_fused_stage_plain,
    edgeconv_fused_stage_tf32,
    edgeconv_fused_stage_tf32_plain,
    fold_bn,
    launch_extrema,
    launch_geometry_bf16,
    launch_stage,
    launch_stage_bf16,
    launch_stage_tf32,
    stage_bf16_tolerance,
    stage_tf32_tolerance,
)
from dgcnn_tpu_torch.kernels.knn_approx import knn_approx
from dgcnn_tpu_torch.kernels.knn_banded import (
    knn_banded,
    probe_rows,
    knn_banded_raw,
    knn_banded_raw_plain,
    knn_feature_banded,
)
from dgcnn_tpu_torch.kernels.knn_capped import (
    capped_geometry,
    knn_capped,
    knn_capped_plain,
    launch_geometry,
)
from dgcnn_tpu_torch.kernels.knn_capped import launch_kernel as knn_capped_launch
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact, knn_exact_plain
from dgcnn_tpu_torch.kernels.knn_exact import launch_kernel as knn_exact_launch
from dgcnn_tpu_torch.kernels.knn_exact_banded import (
    knn_exact_banded,
    knn_exact_banded_raw,
    knn_exact_banded_raw_plain,
)
from dgcnn_tpu_torch.kernels.knn_packed import knn_packed, knn_packed_plain
from dgcnn_tpu_torch.kernels.knn_packed import launch_kernel as knn_packed_launch
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn
from dgcnn_tpu_torch.ops.knn import approx_reduction_size, knn
from dgcnn_tpu_torch.ops.edgeconv import lrelu
from torch_port_helpers import random_bn, replay_knn, sorted_blocks

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("c", [3, 4, 64])
def test_knn_kernel_equals_plain_on_integer_inputs(dev, c):
    x, = _on(dev, np.random.default_rng(c).integers(0, 16, (2, 1500, c)).astype(np.float32))
    before = knn_capped.launches
    got = knn_capped(x, 20)
    torch.cuda.synchronize()
    assert knn_capped.launches == before + 1
    assert torch.equal(got, knn_capped_plain(x, 20))  # exact dots: equal


def test_knn_kernel_queries_and_window128(dev):
    rng = np.random.default_rng(1)
    x, q = _on(dev, rng.integers(0, 16, (2, 700, 4)).astype(np.float32),
               rng.integers(0, 16, (2, 90, 4)).astype(np.float32))
    got = knn_capped(x, 10, window=128, cap=4, queries=q)
    assert torch.equal(got, knn_capped_plain(x, 10, window=128, cap=4, queries=q))


def test_knn_kernel_agrees_on_floats(dev):
    x, = _on(dev, sorted_blocks(2, 3000, seed=2))
    # FP32 sum order differs from cuBLAS's: near-tied keys may swap
    assert (knn_capped(x, 30) == knn_capped_plain(x, 30)).float().mean() >= 0.999


def test_knn_kernel_refuses_unported_cases(dev):
    # n_win*cap < k: the capped wrapper takes the flat packed kernel
    small, = _on(dev, np.random.default_rng(4).integers(0, 16, (1, 200, 3)).astype(np.float32))
    before = knn_packed.launches
    got = knn_capped(small, 20)
    assert knn_packed.launches == before + 1
    assert torch.equal(got, knn_packed_plain(small, 20))
    # past 15 index bits the capped wrapper takes the exact kernel
    x, = _on(dev, np.random.default_rng(5).integers(0, 64, (1, 40000, 3)).astype(np.float32))
    before = knn_exact.launches
    got = knn_capped(x, 20)
    assert knn_exact.launches == before + 1
    assert torch.equal(got, knn_exact_plain(x, 20))


# the capped kernel's shapes: (c, b, n, m, window, cap) — m None: self-kNN.
# The default path's self-kNN (C=4 stage 1, C=64 stages 2-3) and its
# recall-guard probes (64 and 256 rows of probe_rows), ragged probes, the
# JAX tests' window 128 with cap 4, one small cloud, and the widest index
# field (15 bits, 118 windows: four groups of windows even for a self-kNN)
CAPPED_CASES = [
    (4, 8, 7000, None, 256, 8), (64, 8, 7000, None, 256, 8),
    (64, 8, 7000, 64, 256, 8), (64, 8, 7000, 256, 256, 8), (64, 8, 7000, 200, 256, 8),
    (4, 8, 7000, 64, 256, 8), (3, 2, 4500, None, 128, 4), (64, 2, 4500, 100, 128, 4),
    (4, 1, 1001, None, 256, 8), (64, 1, 1001, None, 256, 8),
    (4, 1, 30000, None, 256, 8), (64, 1, 30000, 256, 256, 8),
]


def _capped_queries(x, m):
    if m is None:
        return None
    n = x.shape[1]
    rows = probe_rows(n, m, x.device) if m in (64, 256) else torch.arange(m, device=x.device) * (n // m)
    return x[:, rows].contiguous()


@pytest.mark.parametrize("c, b, n, m, window, cap", CAPPED_CASES)
def test_capped_kernel_shapes_equal_plain_on_integer_inputs(dev, c, b, n, m, window, cap):
    x, = _on(dev, np.random.default_rng(c + n).integers(0, 16, (b, n, c)).astype(np.float32))
    q = _capped_queries(x, m)
    before = knn_capped.launches
    got = knn_capped(x, 30, window=window, cap=cap, queries=q)
    torch.cuda.synchronize()
    assert knn_capped.launches == before + 1
    assert torch.equal(got, knn_capped_plain(x, 30, window=window, cap=cap, queries=q))


@pytest.mark.parametrize("c, m", [(64, None), (64, 64), (64, 256), (4, None), (4, 200)])
def test_capped_kernel_geometries_agree_bit_for_bit_on_floats(dev, c, m):
    """Every launch geometry returns the same indices, bit for bit, on
    floats too: the keys are unique and each dot is one fmaf chain."""
    rng = np.random.default_rng(c)
    x, = _on(dev, sorted_blocks(8, 7000, seed=4) if c == 4
             else rng.standard_normal((8, 7000, 64)).astype(np.float32))
    q = x if m is None else _capped_queries(x, m)
    cn, qn = (x * x).sum(-1), (q * q).sum(-1)
    n_pad, n_win, _ = capped_geometry(7000, 256)
    shipped = launch_geometry(c, 8, q.shape[1], n_pad, n_win, 8)
    want = knn_capped_launch(x, q, cn, qn, 30, window=256, cap=8, geometry=shipped)
    if c > 8:
        others = [(qb, g, 256 // g, 1) for qb in (64, 32) for g in (1, 4, 7, 28)]
    else:
        others = [(4 * min(256 // g, 16), g, jt, nbuf) for g in (1, 4, 14, 28)
                  for jt, nbuf in ((16, 2), (3, 1))]
    for geometry in others:
        got = knn_capped_launch(x, q, cn, qn, 30, window=256, cap=8, geometry=geometry)
        assert torch.equal(got, want), geometry


BANDED_CASES = [  # (c, b, n, band, n_win, cap, qt)
    (4, 8, 7000, 2048, 64, 6, 512),   # stage 1 of the default path
    (64, 8, 7000, 4096, 64, 6, 384),  # stages 2-3
    (3, 2, 4500, 512, 16, 8, 128),    # the JAX tests' window geometry
    (4, 1, 7000, 2048, 64, 6, 512),
    (8, 1, 4500, 1024, 32, 4, 32),    # 32-query blocks
    (16, 1, 7000, 2048, 16, 8, 128),
    (32, 8, 4500, 1024, 64, 4, 384),
    (64, 2, 4500, 4096, 32, 8, 512),
    (5, 1, 4500, 256, 64, 6, 128),    # 4 rows per window < cap
    (4, 1, 4500, 1536, 128, 4, 256),  # two rounds of 64 windows
    (64, 1, 4500, 384, 192, 8, 384),  # the smallest launch geometry
    (32, 1, 4500, 1024, 64, 6, 160),  # two-phase kernel, 32-query blocks
    (64, 1, 4500, 1536, 96, 4, 384),  # two-phase kernel, two rounds of windows
]


@pytest.mark.parametrize("c, b, n, band, n_win, cap, qt", BANDED_CASES)
def test_banded_kernel_equals_plain_on_integer_inputs(dev, c, b, n, band, n_win, cap, qt):
    x, = _on(dev, np.random.default_rng(c + n).integers(0, 16, (b, n, c)).astype(np.float32))
    kw = dict(band=band, n_win=n_win, cap=cap, query_tile=qt)
    before = knn_banded_raw.launches
    idx, key = knn_banded_raw(x, 30, **kw)
    torch.cuda.synchronize()
    assert knn_banded_raw.launches == before + 1
    want_idx, want_key = knn_banded_raw_plain(x, 30, **kw)
    assert torch.equal(idx, want_idx) and torch.equal(key, want_key)


@pytest.mark.parametrize("c, band, qt", [(4, 2048, 512), (64, 4096, 384)])
def test_banded_kernel_agrees_with_plain_on_floats(dev, c, band, qt):
    """The production shapes on floats: cuBLAS sums the plain version's dots
    in another order, so near-tied keys may swap; the swapped neighbours'
    distances agree to the packed keys' resolution (2^-8 relative)."""
    rng = np.random.default_rng(c)
    x, = _on(dev, sorted_blocks(8, 7000, seed=3) if c == 4
             else rng.standard_normal((8, 7000, 64)).astype(np.float32))
    kw = dict(band=band, n_win=64, cap=6, query_tile=qt)
    idx, _ = knn_banded_raw(x, 30, **kw)
    want, _ = knn_banded_raw_plain(x, 30, **kw)
    assert (idx == want).float().mean() >= 0.999

    def d2(i):
        nb = torch.gather(x, 1, i.long().reshape(8, -1, 1).expand(-1, -1, c)).reshape(8, 7000, 30, c)
        return ((nb - x[:, :, None]) ** 2).sum(-1)

    rel = ((d2(idx) - d2(want)).abs() / d2(want).abs().clamp_min(1e-6)).max()
    assert rel <= 2.0 ** -8


@pytest.mark.parametrize("m", [256, None])
def test_exact_kernel_equals_plain_on_integer_inputs(dev, m):
    rng = np.random.default_rng(6)
    x, = _on(dev, rng.integers(0, 16, (2, 3000, 4)).astype(np.float32))
    q = None if m is None else _on(dev, rng.integers(0, 16, (2, m, 4)).astype(np.float32))[0]
    for k in (30, 40):  # one and two register slots per lane
        assert torch.equal(knn_exact(x, k, queries=q), knn_exact_plain(x, k, queries=q))


# (b, n, m, k): the repair's shape, a self-kNN (m None), one chunk, ragged
# n, k over one lane slot, k = 1 and k = 64
EXACT_CASES = [(8, 7000, 256, 30), (1, 4500, None, 30), (2, 20, 7, 5), (1, 1001, 300, 40),
               (3, 777, 50, 64), (2, 129, 129, 1)]


def _exact_prepared(x, q):
    cn = (x * x).sum(-1).contiguous()
    return torch.nn.functional.pad(x, (0, 4 - x.shape[-1])).contiguous(), \
        torch.nn.functional.pad(q, (0, 4 - q.shape[-1])).contiguous(), cn


@pytest.mark.parametrize("b, n, m, k", EXACT_CASES)
def test_exact_kernel_slices_and_hints_equal_plain_on_integers(dev, b, n, m, k):
    """Every split (1, 2, 4, 8 warps a query) with and without the row
    hint, on integers in [0, 16) (ties everywhere): the plain version's
    indices, bit for bit; the wrapper's own geometry too."""
    rng = np.random.default_rng(n + k)
    x, = _on(dev, np.sort(rng.integers(0, 16, (b, n, 3)).astype(np.float32), axis=1))
    rows = (torch.arange(n, device=dev).expand(b, n) if m is None else
            torch.from_numpy(rng.integers(0, n, (b, m))).to(dev))
    q = x if m is None else x.gather(1, rows[..., None].expand(-1, -1, 3)).contiguous()
    want = knn_exact_plain(x, k, queries=None if m is None else q)
    xp, qp, cn = _exact_prepared(x, q)
    for slices in (1, 2, 4, 8):
        for hint in (None, rows):
            got = knn_exact_launch(xp, qp, cn, k, rows=hint, slices=slices)
            assert torch.equal(got, want), (slices, hint is not None)
    got = knn_exact(x, k, queries=None if m is None else q, query_rows=rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("data", ["blocks", "offset", "features"])
def test_exact_kernel_slices_and_hints_agree_bit_for_bit_on_floats(dev, data):
    """On floats every split (C=4) and hint gives the same indices bit for
    bit (the same scores, a total order). At C=4 (the cloud kernel, pruning
    where channel 0 is sorted: x-sorted blocks, and the same blocks moved
    to x ~ 10^4 where the scores round coarsely) they are also those of
    the kernel that reads rows from L2 and walks every row: the same
    points with 12 zero channels (the same FMA chain) and the same norms,
    for these queries and for the self-kNN."""
    rng = np.random.default_rng(len(data))
    if data == "features":
        pts = rng.standard_normal((2, 3000, 64)).astype(np.float32)
    else:
        pts = sorted_blocks(2, 3000, seed=3)
        if data == "offset":
            pts[..., 0] += 1e4
    x, = _on(dev, pts)
    c = x.shape[-1]
    rows = torch.from_numpy(rng.integers(0, 3000, (2, 256))).to(dev)
    q = x.gather(1, rows[..., None].expand(-1, -1, c)).contiguous()
    cn = (x * x).sum(-1).contiguous()
    want = knn_exact_launch(x, q, cn, 30)
    for slices in (1, 2, 4, 8) if c == 4 else (1,):  # C=64: a warp a query
        for hint in (None, rows, rows.flip(1)):
            assert torch.equal(knn_exact_launch(x, q, cn, 30, rows=hint, slices=slices), want)
    assert torch.equal(knn_exact(x, 30, queries=q, query_rows=rows), want)
    if c == 64:
        with pytest.raises(RuntimeError, match="knn_exact"):
            knn_exact_launch(x, q, cn, 30, slices=2)
    if c == 4:  # the same norms: (x * x).sum(-1) of the 4 channels
        x16, q16 = (torch.nn.functional.pad(t, (0, 12)).contiguous() for t in (x, q))
        assert torch.equal(knn_exact_launch(x16, q16, cn, 30), want)
        assert torch.equal(knn_exact_launch(x16, x16, cn, 30), knn_exact_launch(x, x, cn, 30))


def test_predicates_skip_the_kernels(dev):
    """A False predicate leaves the output buffer as the allocator hands
    it back: here the block just filled with -7 and freed."""
    x, = _on(dev, np.random.default_rng(7).integers(0, 16, (1, 3000, 4)).astype(np.float32))
    no = torch.zeros((), dtype=torch.bool, device=dev)
    for fn in (lambda p: knn_capped(x, 20, pred=p), lambda p: knn_exact(x, 20, pred=p),
               lambda p: knn_banded_raw(x, 20, band=2048, n_win=64, cap=6,
                                        query_tile=512, pred=p)[0],
               lambda p: knn_exact_banded_raw(x, 20, band=2048, n_win=64, cap=8,
                                              query_tile=256, pred=p)[0],
               lambda p: knn_packed(x, 20, pred=p)):
        out = fn(None)
        out.fill_(-7)
        del out
        skipped = fn(no)
        torch.cuda.synchronize()
        assert (skipped == -7).all()


def _grid(seed, b, n, c):
    """x-sorted points on a 1/64 grid: exact dots in any order."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 1, (b, n, c)) * np.array([30.0] + [4.0] * (c - 1)) * 64) / 64
    x = x.astype(np.float32)
    return np.take_along_axis(x, np.argsort(x[..., 0], 1, kind="stable")[..., None], 1)


@pytest.mark.parametrize("c, k, band, n_win, cap, qt", [
    (4, 30, 2048, 64, 8, 256),   # the parity mode's stage 1
    (64, 30, 4608, 64, 8, 256),  # its stages 2-3: full width (n_pad of 4500 rows)
    (3, 20, 512, 16, 4, 128),    # cap 4: windows overflow
])
def test_exact_banded_kernel_equals_plain_on_the_grid(dev, c, k, band, n_win, cap, qt):
    x, = _on(dev, _grid(c, 2, 4500, c))
    kw = dict(band=band, n_win=n_win, cap=cap, query_tile=qt)
    before = knn_exact_banded_raw.launches
    got = knn_exact_banded_raw(x, k, **kw)
    torch.cuda.synchronize()
    assert knn_exact_banded_raw.launches == before + 1
    want = knn_exact_banded_raw_plain(x, k, **kw)
    for g, w in zip(got, want):  # indices, k-th keys, overflow flags
        assert torch.equal(g, w)
    full = knn_exact_banded_raw(x, k, banded=torch.zeros((), dtype=torch.bool, device=dev), **kw)
    want_full = knn_exact_banded_raw_plain(x, k, **{**kw, "band": 4608})
    assert all(torch.equal(g, w) for g, w in zip(full, want_full))


def test_exact_banded_kernel_full_width_is_the_flat_kernel_on_floats(dev):
    """At full width a row without a window overflow holds the exact
    top-k; both kernels score with csrc/knn_common.cuh, so there the raw
    kernel's indices are the flat exact kernel's bit for bit on floats."""
    f, = _on(dev, np.random.default_rng(14).standard_normal((2, 4500, 64)).astype(np.float32))
    idx, _, ovf = knn_exact_banded_raw(f, 30, band=4608, n_win=64, cap=8, query_tile=256)
    ok = ovf == 0
    assert ok.any()
    assert torch.equal(idx[ok], knn_exact(f, 30)[ok])


@pytest.mark.parametrize("c", [3, 4, 64])
def test_packed_kernel_equals_plain_on_integer_inputs(dev, c):
    rng = np.random.default_rng(c)
    x, q = _on(dev, rng.integers(0, 16, (2, 3000, c)).astype(np.float32),
               rng.integers(0, 16, (2, 90, c)).astype(np.float32))
    before = knn_packed.launches
    assert torch.equal(knn_packed(x, 30), knn_packed_plain(x, 30))
    assert torch.equal(knn_packed(x, 40, queries=q), knn_packed_plain(x, 40, queries=q))
    assert knn_packed.launches == before + 2


# the exact banded kernel's shapes: (c, b, n, band, n_win, cap, qt, k) — the
# parity forward's stage 1 (C=4, band 2048) and stages 2-3 (C=64, full
# width), cap 4, 16 / 32 / 48 windows, query tiles 64 and 512, ragged N
# (4500: padding rows in the last band; 1001), one cloud, windows shorter
# than cap, k = 20 and 40
EXACT_BANDED_CASES = [
    (4, 8, 7000, 2048, 64, 8, 256, 30), (64, 8, 7000, 7040, 64, 8, 256, 30),
    (4, 8, 7000, 2048, 64, 4, 256, 30), (4, 2, 7000, 1024, 16, 8, 256, 30),
    (4, 2, 7000, 2048, 64, 8, 64, 20), (4, 2, 7000, 2048, 64, 8, 512, 40),
    (64, 2, 4500, 4608, 64, 8, 256, 30), (3, 1, 1001, 512, 16, 8, 128, 30),
    (8, 1, 4500, 256, 64, 8, 128, 30), (32, 2, 4500, 4608, 64, 4, 256, 30),
    (8, 1, 4500, 128, 32, 8, 128, 20),  # 32 windows of 4 rows (< cap)
    (4, 1, 4500, 384, 48, 8, 128, 30),  # 48 windows: 16 of a j-step's 64 slots idle
]


@pytest.mark.parametrize("c, b, n, band, n_win, cap, qt, k", EXACT_BANDED_CASES)
def test_exact_banded_kernel_shapes_equal_plain_on_integer_inputs(dev, c, b, n, band, n_win,
                                                                  cap, qt, k):
    """Integers in [0, 16): keys repeat everywhere, so the (key, row) order
    decides; all three outputs equal the plain version's, and a launch
    whose ``banded`` flag reads False equals the plain version at full
    width."""
    x, = _on(dev, np.random.default_rng(c + n + band).integers(0, 16, (b, n, c))
             .astype(np.float32))
    kw = dict(band=band, n_win=n_win, cap=cap, query_tile=qt)
    got = knn_exact_banded_raw(x, k, **kw)
    want = knn_exact_banded_raw_plain(x, k, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    n_pad = -(-n // 128) * 128
    full = knn_exact_banded_raw(x, k, banded=torch.zeros((), dtype=torch.bool, device=dev), **kw)
    want_full = knn_exact_banded_raw_plain(x, k, **{**kw, "band": n_pad})
    assert all(torch.equal(g, w) for g, w in zip(full, want_full))


# the packed kernel's shapes: (c, b, n, m, k) — m None: self-kNN. The packed
# forward's stage 1 (C=4) and stages 2-3 (C=64), 1000 queries, k = 20, 40,
# 64, ragged N, one cloud, 15 index bits
PACKED_CASES = [
    (4, 8, 7000, None, 30), (64, 8, 7000, None, 30), (64, 8, 7000, 1000, 30),
    (4, 2, 7000, None, 20), (4, 2, 7000, None, 40), (64, 2, 7000, 300, 64),
    (64, 2, 4500, None, 30), (3, 1, 1001, None, 30), (4, 1, 30000, None, 30),
]


@pytest.mark.parametrize("c, b, n, m, k", PACKED_CASES)
def test_packed_kernel_shapes_equal_plain_on_integer_inputs(dev, c, b, n, m, k):
    rng = np.random.default_rng(c + n + k)
    x, = _on(dev, rng.integers(0, 64 if n > 8192 else 16, (b, n, c)).astype(np.float32))
    q = None if m is None else x[:, torch.randperm(n, device=dev)[:m]].contiguous()
    before = knn_packed.launches
    got = knn_packed(x, k, queries=q)
    torch.cuda.synchronize()
    assert knn_packed.launches == before + 1
    assert torch.equal(got, knn_packed_plain(x, k, queries=q))


@pytest.mark.parametrize("c, m, k", [(64, None, 30), (4, None, 30), (64, 1000, 40),
                                     (4, 200, 64)])
def test_packed_kernel_geometries_agree_bit_for_bit_on_floats(dev, c, m, k):
    """The fused kernel's two block sizes (64 and 32 queries, C <= 8)
    return the same indices, bit for bit, on floats too: the keys are
    unique and each dot is one fmaf chain; the two-phase kernel (C >= 16)
    takes 64 only and refuses 32; a False predicate leaves the output as
    it was."""
    rng = np.random.default_rng(c + k)
    x, = _on(dev, sorted_blocks(8, 7000, seed=5) if c == 4
             else rng.standard_normal((8, 7000, 64)).astype(np.float32))
    q = x if m is None else x[:, torch.randperm(7000, device=dev)[:m]].contiguous()
    cn, qn = (x * x).sum(-1), (q * q).sum(-1)
    want = knn_packed_launch(x, q, cn, qn, k, qb=64)
    other = 32 if c <= 8 else 64
    if c > 8:
        with pytest.raises(RuntimeError, match="CUDA error"):
            knn_packed_launch(x, q, cn, qn, k, qb=32)
    assert torch.equal(knn_packed_launch(x, q, cn, qn, k, qb=other), want)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = knn_packed_launch(x, q, cn, qn, k, qb=other)
    out.fill_(-7)
    del out
    skipped = knn_packed_launch(x, q, cn, qn, k, qb=other, pred=no)
    torch.cuda.synchronize()
    assert (skipped == -7).all()


def test_parity_wrapper_equals_the_flat_exact_kernel(dev):
    """On float inputs the parity wrapper on the card is bit for bit the
    flat exact kernel on the card: both compute the score of
    csrc/knn_common.cuh."""
    pts = sorted_blocks(2, 4500, seed=11)
    pts[1, ::97, 1] += 400.0  # far-off rows fail the certificate: repaired
    x, = _on(dev, pts)
    assert torch.equal(knn_exact_banded(x, 30, band=2048), knn_exact(x, 30))
    shuffled = x[:, torch.randperm(4500, device=dev)]  # unsorted: full width
    assert torch.equal(knn_exact_banded(shuffled, 30, band=2048), knn_exact(shuffled, 30))
    f, = _on(dev, np.random.default_rng(12).standard_normal((2, 4500, 64)).astype(np.float32))
    assert torch.equal(knn_exact_banded(f, 30, band=0), knn_exact(f, 30))


@pytest.mark.parametrize("impl", ["pallas", "pallas_packed"])
def test_parity_and_packed_models_on_cuda_match_cpu_plain_versions(dev, impl):
    cfg = DGCNNConfig(k=30, emb_dims=64, knn_impl=impl)
    model = init_dgcnn(cfg, torch.Generator().manual_seed(5))
    x = torch.from_numpy(sorted_blocks(2, 3000, seed=14))
    with torch.no_grad():
        want = torch.softmax(model(x), -1)
        got = torch.softmax(model.to(dev)(x.to(dev)), -1).cpu()
    assert (got - want).abs().max().item() <= 1e-3


def test_banded_wrappers_on_the_card(dev):
    rng = np.random.default_rng(8)
    pts = sorted_blocks(2, 4000, seed=8)
    pts[1, ::97, 1] += 400.0  # far-off rows fail the certificate
    x, = _on(dev, pts)
    got = knn_banded(x, 30, band=2048, n_win=64, cap=6, capped_cap=8)
    raw, _ = knn_banded_raw_plain(x, 30, band=2048, n_win=64, cap=6, query_tile=512)
    fixed = (got != raw).any(-1)
    assert fixed[1].any()  # repaired rows equal the exact kNN
    assert torch.equal(got[fixed], knn_exact_plain(x, 30)[fixed])
    shuffled = x[:, torch.randperm(4000, device=dev)]  # unsorted: capped
    assert torch.equal(knn_banded(shuffled, 30, band=2048, n_win=64, cap=6, capped_cap=8),
                       knn_capped(shuffled, 30))
    f, = _on(dev, rng.integers(0, 31, (2, 4000, 64)).astype(np.float32))
    idx, tripped = knn_feature_banded(
        f, 30, sorted_ok=torch.ones((), dtype=torch.bool, device=dev), band=2048,
        n_win=64, cap=6, capped_cap=8, guard_ok=True, with_flag=True)
    assert bool(tripped) and torch.equal(idx, knn_capped(f, 30))


def _stage_inputs(dev, n=1200, k=30):
    rng = np.random.default_rng(3)
    table, bvec = _on(dev, *rng.standard_normal((2, 2, n, 64)).astype(np.float32))
    idx = knn_capped(table, k)
    w2, = _on(dev, rng.uniform(-0.125, 0.125, (64, 64)).astype(np.float32))
    bns = [random_bn(rng, 64) for _ in range(3)]
    folded = [fold_bn(*_on(dev, b["gamma"], b["beta"], b["mean"], b["var"])) for b in bns]
    gamma, = _on(dev, bns[2]["gamma"])
    return table, idx, bvec, w2, folded, gamma


def test_fused_stage_kernel_equals_plain(dev):
    table, idx, bvec, w2, ((sa, ta), (sb, tb), _), _ = _stage_inputs(dev)
    got = edgeconv_fused_stage(table, idx, bvec, w2, sa, ta, sb, tb)
    want = edgeconv_fused_stage_plain(table, idx, bvec, w2, sa, ta, sb, tb)
    # the 64-long dot: sequential FMA in the kernel, cuBLAS's order in plain
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# (b, n, k): k padded within one unit of 32 rows, exactly one unit, two
# units, k = 1; ragged n
STAGE_SHAPES = [(2, 1200, 30), (1, 1001, 20), (1, 1001, 32), (1, 1001, 40), (3, 77, 1)]
# (warps, nbuf, grid): the shipped geometry first; grid 0 is the persistent
# grid, 3 blocks walk many queries per warp
STAGE_GEOMETRIES = [(12, 2, 0), (12, 1, 0), (8, 2, 0), (10, 2, 0), (4, 1, 0), (1, 1, 0),
                    (12, 2, 3)]


@pytest.mark.parametrize("b, n, k", STAGE_SHAPES)
def test_fused_stage_kernel_geometries(dev, b, n, k):
    """Every launch geometry gives the same outputs, bit for bit, within
    1e-5 of the plain version, with indices outside [0, n) clamped and a
    zero BN_b scale (its lane takes the per-row epilogue)."""
    rng = np.random.default_rng(k)
    table, bvec = _on(dev, *rng.standard_normal((2, b, n, 64)).astype(np.float32))
    idx, = _on(dev, rng.integers(-2, n + 2, (b, n, k)).astype(np.int32))
    w2, = _on(dev, rng.uniform(-0.125, 0.125, (64, 64)).astype(np.float32))
    (sa, ta), (sb, tb) = [fold_bn(*_on(dev, v["gamma"], v["beta"], v["mean"], v["var"]))
                          for v in (random_bn(rng, 64), random_bn(rng, 64))]
    sb[1] = 0.0
    vectors = [sa, ta, sb, tb]
    want = edgeconv_fused_stage_plain(table, idx, bvec, w2, *vectors)
    got = [launch_stage(table, idx, bvec, w2, vectors, g[:2], g[2]) for g in STAGE_GEOMETRIES]
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)
    for g, out in zip(STAGE_GEOMETRIES, got):
        assert torch.equal(out, got[0]), g
    before = edgeconv_fused_stage.launches
    assert torch.equal(edgeconv_fused_stage(table, idx, bvec, w2, *vectors), got[0])
    assert edgeconv_fused_stage.launches == before + 1


def _assert_bf16_close(got, table, idx, bvec, w2, sa, ta, sb, tb):
    """The bf16 kernel within :func:`stage_bf16_tolerance` of its plain
    version (the FP32 sums' orders differ), and far from the FP32 stage."""
    want = edgeconv_fused_stage_plain(table, idx, bvec, w2, sa, ta, sb, tb, bf16_mm=True)
    tol = stage_bf16_tolerance(table, idx, bvec, w2, sa, ta, sb)
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()
    f32 = edgeconv_fused_stage_plain(table, idx, bvec, w2, sa, ta, sb, tb)
    assert (got - f32).abs().max().item() > 1e-3


def test_fused_stage_bf16_kernel_equals_plain(dev):
    table, idx, bvec, w2, ((sa, ta), (sb, tb), _), _ = _stage_inputs(dev)
    before = (edgeconv_fused_stage.launches, edgeconv_fused_stage_bf16.launches)
    got = edgeconv_fused_stage(table, idx, bvec, w2, sa, ta, sb, tb, bf16_mm=True)
    assert (edgeconv_fused_stage.launches, edgeconv_fused_stage_bf16.launches) == (
        before[0], before[1] + 1)
    _assert_bf16_close(got, table, idx, bvec, w2, sa, ta, sb, tb)


# (b, n, k): k = 1, within one unit of 32 rows, one unit exactly, one row
# past it, two units; ragged n; n smaller than a block's range at the
# production geometry (8 clouds of 50 queries: blocks span clouds)
BF16_SHAPES = [(2, 1200, 30), (1, 1001, 1), (1, 1001, 20), (1, 1001, 32), (1, 1001, 33),
               (1, 1001, 40), (1, 1001, 64), (8, 50, 30), (3, 77, 1)]
# (warps, queries a block), beside the wrapper's: 1 and 3 warps, one query
# a block, ranges of 7 and 64, one block for every query
BF16_GEOMETRIES = [(1, 0), (3, 0), (8, 1), (8, 7), (8, 64), (8, 1 << 30)]


def _bf16_operands(dev, b, n, k, seed):
    rng = np.random.default_rng(seed)
    table, bvec = _on(dev, *rng.standard_normal((2, b, n, 64)).astype(np.float32))
    idx, = _on(dev, rng.integers(-2, n + 2, (b, n, k)).astype(np.int32))  # uniform, clamped
    w2, = _on(dev, rng.uniform(-0.125, 0.125, (64, 64)).astype(np.float32))
    (sa, ta), (sb, tb) = [fold_bn(*_on(dev, v["gamma"], v["beta"], v["mean"], v["var"]))
                          for v in (random_bn(rng, 64), random_bn(rng, 64))]
    return table, idx, bvec, w2, [sa, ta, sb, tb]


@pytest.mark.parametrize("b, n, k", BF16_SHAPES)
def test_fused_stage_bf16_kernel_geometries(dev, b, n, k):
    """Every launch geometry of the bf16 kernel gives the same outputs, bit
    for bit (a unit's products are summed in one order whichever warp takes
    it), within the tolerance of the plain version, on uniform indices with
    some outside [0, n) (clamped), BN_b scales of both signs and a zero
    one (the warp then applies BN_b to every row before the max)."""
    table, idx, bvec, w2, vectors = _bf16_operands(dev, b, n, k, 100 + k)
    for zero in (False, True):
        if zero:
            vectors[2] = vectors[2].clone()
            vectors[2][1] = 0.0
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        shipped = launch_geometry_bf16(b, n, k, sms)
        got = [launch_stage_bf16(table, idx, bvec, w2, vectors, g)
               for g in [shipped, *((w, p or shipped[1]) for w, p in BF16_GEOMETRIES)]]
        _assert_bf16_close(got[0], table, idx, bvec, w2, *vectors)
        for g, out in zip(BF16_GEOMETRIES, got[1:]):
            assert torch.equal(out, got[0]), (zero, g)
        assert torch.equal(edgeconv_fused_stage_bf16(table, idx, bvec, w2, *vectors), got[0])


def test_fused_stage_bf16_kernel_non_finite_scales(dev):
    """Channels whose BN_b is not finite take BN_b and the LeakyReLU on every
    row and fmaxf skips NaN rows, as in the kernel this one replaced: an
    infinite scale gives +inf where some row's product has the scale's
    sign (-inf where none has), a NaN scale -inf, an infinite shift +inf;
    every other channel stays within the tolerance of the plain version."""
    table, idx, bvec, w2, (sa, ta, sb, tb) = _bf16_operands(dev, 2, 1200, 30, 7)
    sb, tb = sb.clone(), tb.clone()
    sb[3], sb[9], sb[5], tb[7] = float("inf"), float("-inf"), float("nan"), float("inf")
    got = edgeconv_fused_stage_bf16(table, idx, bvec, w2, sa, ta, sb, tb)
    regular = [c for c in range(64) if c not in (3, 5, 7, 9)]
    want = edgeconv_fused_stage_plain(table, idx, bvec, w2, sa, ta, sb, tb, bf16_mm=True)
    tol = stage_bf16_tolerance(table, idx, bvec, w2, sa, ta, sb)
    assert ((got - want).abs()[..., regular] <= tol[..., regular]).all()
    # the rows' products (bf16 operands, FP32 sums): their signs decide
    clamped = idx.clamp(0, 1199).long()
    e = torch.stack([table[i][clamped[i]] for i in range(2)]) + bvec[:, :, None, :]
    e = lrelu((e.double() * sa.double() + ta.double()).float())
    h = torch.matmul(e.to(torch.bfloat16).float(), w2.to(torch.bfloat16).float())
    inf = torch.full_like(got[..., 3], float("inf"))
    assert torch.equal(got[..., 3], torch.where((h[..., 3] > 0).any(-1), inf, -inf))
    assert torch.equal(got[..., 9], torch.where((h[..., 9] < 0).any(-1), inf, -inf))
    assert torch.equal(got[..., 5], -inf)
    assert torch.equal(got[..., 7], inf)


def test_fused_stage_bf16_kernel_refuses_out_of_range_geometries(dev):
    """The launcher refuses (cudaErrorInvalidValue) 0 or more than 8 warps a
    block and ranges below one query; the wrapper's geometry is in range."""
    table, idx, bvec, w2, vectors = _bf16_operands(dev, 1, 1001, 30, 3)
    for geometry in ((0, 10), (9, 10), (16, 10), (8, 0), (8, -1)):
        with pytest.raises(RuntimeError, match="edgeconv_fused_stage_bf16"):
            launch_stage_bf16(table, idx, bvec, w2, vectors, geometry)
    warps, per = launch_geometry_bf16(1, 1001, 30)
    assert 1 <= warps <= 8 and per >= 1


def _assert_tf32_close(got, table, idx, bvec, w2, sa, ta, sb, tb):
    """The TF32 kernel within :func:`stage_tf32_tolerance` of its plain
    version (the FP32 sums' orders differ), and far from the FP32 stage."""
    want = edgeconv_fused_stage_tf32_plain(table, idx, bvec, w2, sa, ta, sb, tb)
    tol = stage_tf32_tolerance(table, idx, bvec, w2, sa, ta, sb, tb)
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()
    f32 = edgeconv_fused_stage_plain(table, idx, bvec, w2, sa, ta, sb, tb)
    assert (got - f32).abs().max().item() > 1e-4


@pytest.mark.parametrize("b, n, k", BF16_SHAPES)
def test_fused_stage_tf32_kernel_geometries(dev, b, n, k):
    """The TF32 kernel through the stage wrapper (counted there, not as the
    FP32 kernel) and at row 12's other geometries (1 and 3 warps, one query
    a block, ranges of 7 and 64, one block for all): the same outputs bit
    for bit, within the tolerance of the plain version, at k = 1, 20, 32,
    33, 40 and 64 and on clouds smaller than a block's range, on uniform
    indices with some outside [0, n) (clamped), with a zero BN_b scale too
    (the warp then applies BN_b to every row before the max)."""
    table, idx, bvec, w2, vectors = _bf16_operands(dev, b, n, k, 200 + k)
    for zero in (False, True):
        if zero:
            vectors[2] = vectors[2].clone()
            vectors[2][1] = 0.0
        before = (edgeconv_fused_stage.launches, edgeconv_fused_stage_tf32.launches)
        got = edgeconv_fused_stage(table, idx, bvec, w2, *vectors, tf32_mm=True)
        assert (edgeconv_fused_stage.launches, edgeconv_fused_stage_tf32.launches) == (
            before[0], before[1] + 1)
        _assert_tf32_close(got, table, idx, bvec, w2, *vectors)
        per = launch_geometry_bf16(b, n, k, torch.cuda.get_device_properties(dev)
                                   .multi_processor_count)[1]
        for g in BF16_GEOMETRIES:
            g = (g[0], g[1] or per)
            assert torch.equal(launch_stage_tf32(table, idx, bvec, w2, vectors, g), got), g
    for geometry in ((0, 10), (9, 10), (16, 10), (8, 0), (8, -1)):
        with pytest.raises(RuntimeError, match="edgeconv_fused_stage_tf32"):
            launch_stage_tf32(table, idx, bvec, w2, vectors, geometry)


@pytest.mark.parametrize("signs", ["negative", "positive", "mixed"])
def test_fused_stage_tf32_kernel_bn_b_paths_agree(dev, signs):
    """BN_b's scales all negative (every W2 column loaded negated, the max
    taken before BN_b on -h), all positive, or of both signs: within the
    tolerance of the plain version; and a zero scale in one channel, which
    sends the whole warp down the per-row path (BN_b and the LeakyReLU on
    every row, then the max), leaves the other 63 channels' outputs equal
    bit for bit (the maps are monotone, and so is their rounding)."""
    table, idx, bvec, w2, (sa, ta, sb, tb) = _bf16_operands(dev, 2, 1200, 30, 9)
    if signs != "mixed":
        sb = sb.abs() if signs == "positive" else -sb.abs()
    got = edgeconv_fused_stage_tf32(table, idx, bvec, w2, sa, ta, sb, tb)
    _assert_tf32_close(got, table, idx, bvec, w2, sa, ta, sb, tb)
    zero = sb.clone()
    zero[17] = 0.0
    per_row = edgeconv_fused_stage_tf32(table, idx, bvec, w2, sa, ta, zero, tb)
    rest = [c for c in range(64) if c != 17]
    assert torch.equal(per_row[..., rest], got[..., rest])
    assert torch.equal(per_row[..., 17], lrelu(tb[17]).expand_as(per_row[..., 17]))


def test_fused_stage_tf32_kernel_nan_in_w2(dev):
    """A NaN in W2 makes its output channel's products NaN on every row, and
    fmaxf skips NaN rows: that channel's output is -inf, whether its column
    is flipped or not (the plain version's amax gives NaN there); the
    other channels stay within the tolerance. The NaNs carry their payload
    in the 13 low bits alone, which the tensor cores do not read: the
    kernel makes them the canonical NaN before rounding, else they would
    multiply as inf."""
    table, idx, bvec, w2, (sa, ta, sb, tb) = _bf16_operands(dev, 2, 1200, 33, 10)
    flipped = int(torch.nonzero(sb < 0)[0])
    kept = int(torch.nonzero(sb > 0)[0])
    w2 = w2.clone()
    bits = w2.view(torch.int32)  # the NaNs' bits set as integers: no float conversion
    bits[5, flipped], bits[40, kept] = 0x7F800001, 0x7F800FFF
    assert torch.isnan(w2[5, flipped]) and torch.isnan(w2[40, kept])
    got = edgeconv_fused_stage_tf32(table, idx, bvec, w2, sa, ta, sb, tb)
    for c in (flipped, kept):
        assert torch.equal(got[..., c], torch.full_like(got[..., c], float("-inf")))
    rest = [c for c in range(64) if c not in (flipped, kept)]
    want = edgeconv_fused_stage_tf32_plain(table, idx, bvec, w2, sa, ta, sb, tb)
    tol = stage_tf32_tolerance(table, idx, bvec, w2, sa, ta, sb, tb)
    assert ((got - want).abs()[..., rest] <= tol[..., rest]).all()


def test_fused_stage_tf32_kernel_is_exact_on_integers(dev):
    """Integer rows, W2 and BN_a (e = 5m, so lrelu(-5m) = -m): TF32 holds
    every operand and every partial sum is exact, so the kernel equals its
    plain version and the FP32 stage bit for bit."""
    rng = np.random.default_rng(11)
    table, bvec = _on(dev, *rng.integers(-3, 4, (2, 2, 900, 64)).astype(np.float32))
    idx, = _on(dev, rng.integers(0, 900, (2, 900, 40)).astype(np.int32))
    w2, = _on(dev, rng.integers(-3, 4, (64, 64)).astype(np.float32))
    sa, = _on(dev, rng.choice([-5.0, 5.0], 64).astype(np.float32))
    ta, = _on(dev, 5.0 * rng.integers(-2, 3, 64).astype(np.float32))
    sb, tb = fold_bn(*_on(dev, *random_bn(rng, 64).values()))
    got = edgeconv_fused_stage_tf32(table, idx, bvec, w2, sa, ta, sb, tb)
    assert torch.equal(got, edgeconv_fused_stage_tf32_plain(table, idx, bvec, w2, sa, ta, sb, tb))
    assert torch.equal(got, edgeconv_fused_stage_plain(table, idx, bvec, w2, sa, ta, sb, tb))


def test_fused_stage_tf32_kernel_non_finite_scales(dev):
    """Non-finite BN_b channels as in the bf16 kernel's test: an infinite
    scale gives +inf where some row's TF32 product has the scale's sign, a
    NaN scale -inf, an infinite shift +inf; the rest within the tolerance."""
    table, idx, bvec, w2, (sa, ta, sb, tb) = _bf16_operands(dev, 2, 1200, 30, 8)
    sb, tb = sb.clone(), tb.clone()
    sb[3], sb[9], sb[5], tb[7] = float("inf"), float("-inf"), float("nan"), float("inf")
    got = edgeconv_fused_stage_tf32(table, idx, bvec, w2, sa, ta, sb, tb)
    regular = [c for c in range(64) if c not in (3, 5, 7, 9)]
    want = edgeconv_fused_stage_tf32_plain(table, idx, bvec, w2, sa, ta, sb, tb)
    tol = stage_tf32_tolerance(table, idx, bvec, w2, sa, ta, sb, tb)
    assert ((got - want).abs()[..., regular] <= tol[..., regular]).all()
    from dgcnn_tpu_torch.ops.matmul import round_tf32

    clamped = idx.clamp(0, 1199).long()
    e = torch.stack([table[i][clamped[i]] for i in range(2)]) + bvec[:, :, None, :]
    h = torch.matmul(round_tf32(lrelu(e * sa + ta)), round_tf32(w2))
    inf = torch.full_like(got[..., 3], float("inf"))
    assert torch.equal(got[..., 3], torch.where((h[..., 3] > 0).any(-1), inf, -inf))
    assert torch.equal(got[..., 9], torch.where((h[..., 9] < 0).any(-1), inf, -inf))
    assert torch.equal(got[..., 5], -inf)
    assert torch.equal(got[..., 7], inf)


def test_tf32_products_leave_the_flag_off(dev):
    """The TF32 product enables cuBLAS's TF32 for its one call: the flag is
    off before and after, also after a product that raises inside the
    scope; its result is the FP32 product of the rounded operands up to
    sum order, and a kNN score product after it stays FP32."""
    from dgcnn_tpu_torch.ops.matmul import mm, round_tf32

    flag = torch.backends.cuda.matmul
    rng = np.random.default_rng(6)
    x, w = _on(dev, rng.standard_normal((4096, 64)).astype(np.float32),
               rng.standard_normal((64, 48)).astype(np.float32))
    assert flag.allow_tf32 is False
    got = mm(x, w, "tf32")
    assert flag.allow_tf32 is False
    want = round_tf32(x).double() @ round_tf32(w).double()
    assert ((got.double() - want).abs() <= 1e-5 * (x.abs() @ w.abs()).double() + 1e-6).all()
    with pytest.raises(RuntimeError):
        mm(x, torch.ones(3, 2, device=dev), "tf32")  # the shapes do not match
    assert flag.allow_tf32 is False
    exact = (x.double() @ w.double())
    assert ((x @ w).double() - exact).abs().max() < ((got.double() - exact).abs().max())


# SHA-256 of the stage kernels' outputs on chip_smoke.stage_cases (float32
# bytes), written by the first bf16 design (warps a grid apart, cp.async
# staging) and the FP32 stage and extrema kernels beside it: the bf16
# redesign must give the first design's bits, and the other two kernels
# must not move. The forward-dependent stage-3 case is held across trees
# by scripts/torch_edgeconv_bf16.py instead.
STAGE_DIGESTS = {
    "capped C=64": (
        "42f5116ec9ab114febe1064801752facbd5e11fae04432f4323b476431281c26",
        "fbeed3574b2945e71dc615b42af641e7e506c1eddadbd927c3c05207339853bc",
        "9be4f18d54d50d288a7fa0a9fc8b127352d1dd59d409ff9f322fee96509fa1a7"),
    "banded stage 1 (blocks, band 2048)": (
        "80b035922c34996e5784cf8e742fb39f1408d7c4a849e30159568bcc47779fdd",
        "efbbd9b50bc540641122ab505b0283b75e5bd0507872fc4959b611d18304454c",
        "dec901cc31338374e44634dfa310e384eeb32da2620fe149c78ba8adee6db6bd"),
    "banded stage 2 (C=64, band 4096)": (
        "284892d46a16588e53c8019fcbaf3aea29f6de647b33e24a4d2c75767cfb3f4a",
        "77f23dac40b883a6fd76df1305156cda68dcffca89120d3de29f98ddca0d58a9",
        "84d17407b3268447b35d935664f009860f30125a65019d4f069ea85484c1ec45"),
    "ragged B=1 N=1001 k=20": (
        "ab64f900a0a094aa237b211fd57bcd7bef57790cddc0e56786cc29f92e42c438",
        "7324853d1bde98e9490aa7a9d95c6f2ae3e829291a9b264ee96e373cfd11307c",
        "b4b1d05661218b544f0a37c1c582f564aed09cce7185890e7100a5e87878b970"),
    "ragged B=1 N=1001 k=30": (
        "3cbe8ce4a7afbc2ed22a3943218082040089b2b8b9880158415064aa651b88a7",
        "d2309f820f2423b1ba2cb3e603124ef52dd20d07e9b2d3830a608eaff8ee75ce",
        "f2e7ac891845f86d85a9b4414aa1953755f8a597d302239ff4e21fa05224fc78"),
    "ragged B=1 N=1001 k=40": (
        "cba5a75bac6e05d136eec04fdd33a89c8f0e48726d55232daf540a4f3a6f328c",
        "4d68813cccb6f2ed92ba8fa1ec78350718d30fb6173ebae8c29e77b0dad0520a",
        "09c0c9fd9ead00eb73eb1f61c1f3aeac160a603e3ebf11188fa8282027c03fac"),
}


@pytest.mark.parametrize("case", list(STAGE_DIGESTS))
def test_stage_kernels_give_the_first_design_bits(dev, case):
    import hashlib
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_digests", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    inputs = cs.stage_cases(dev)[case]
    a, ex = cs.stage_args(inputs), cs.extrema_args(inputs)
    got = (edgeconv_fused_stage_bf16(*a), edgeconv_fused_stage(*a), edgeconv_fused_extrema(*ex))
    digests = tuple(hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
                    for t in got)
    assert digests == STAGE_DIGESTS[case]


# SHA-256 of the TF32 stage kernel's outputs on the same cases, written by
# its first design (each lane's W2 fragments read per n-tile in the source,
# the activations rounded by the integer rule, BN_a in registers): every
# later design must give its bits (the same products, each accumulator's
# k-steps in the same order).
TF32_STAGE_DIGESTS = {
    "capped C=64": "84a2c236ac9b74eb35ed89323cfd254cca182a5f7e348e642d7aff49551f082f",
    "banded stage 1 (blocks, band 2048)":
        "f4c4fffa1d140ce3f17726821b27f19f0a6e670b364979a18532ab82f2721d6d",
    "banded stage 2 (C=64, band 4096)":
        "1833b3da02e520e3928f87a828d9a55920d642f959f2ef156b3326aefab0d0eb",
    "ragged B=1 N=1001 k=20": "a1327b535f1d942a9ca5de142dbe1af74333f4c031b21859e0a64c20a42cd9d0",
    "ragged B=1 N=1001 k=30": "ae1841e4d35c30c3191f748877ec0d725ad8bce5c62631d862342df06e580912",
    "ragged B=1 N=1001 k=40": "0d3cdf4d2aaa041f6b2bf5e01da6a349b99fb6639d4fff019b2b2ec2fc38dfd8",
}


@pytest.mark.parametrize("case", list(TF32_STAGE_DIGESTS))
def test_tf32_stage_kernel_gives_the_first_design_bits(dev, case):
    import hashlib
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tf32_digests", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    got = edgeconv_fused_stage_tf32(*cs.stage_args(cs.stage_cases(dev)[case]))
    digest = hashlib.sha256(got.contiguous().cpu().numpy().tobytes()).hexdigest()
    assert digest == TF32_STAGE_DIGESTS[case]


def test_bf16_model_on_cuda_matches_cpu_plain_versions(dev):
    """The bf16 serving configuration on the card (two bf16 stage launches,
    no FP32 stage launch) against the CPU plain versions, probabilities
    within the north star's 1e-3."""
    cfg = DGCNNConfig(k=30, emb_dims=64, compute_dtype="bfloat16")
    model = init_dgcnn(cfg, torch.Generator().manual_seed(1))
    plain = init_dgcnn(DGCNNConfig(k=30, emb_dims=64, compute_dtype="bfloat16",
                                   knn_impl="pallas_capped"))
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(sorted_blocks(2, 5000, seed=9))
    with torch.no_grad():
        want = torch.softmax(plain(x), -1)
        before = (edgeconv_fused_stage.launches, edgeconv_fused_stage_bf16.launches)
        got = torch.softmax(model.to(dev)(x.to(dev)), -1).cpu()
    assert (edgeconv_fused_stage.launches, edgeconv_fused_stage_bf16.launches) == (
        before[0], before[1] + 2)
    assert (got - want).abs().max().item() <= 1e-3


def test_fused_extrema_kernel_equals_plain(dev):
    table, idx, bvec, _, (_, _, (s, t)), gamma = _stage_inputs(dev)
    got = edgeconv_fused_extrema(table, idx, bvec, gamma, s, t)
    want = edgeconv_fused_extrema_plain(table, idx, bvec, gamma, s, t)
    torch.testing.assert_close(got, want, atol=0, rtol=0)  # no sums: exact


@pytest.mark.parametrize("b, n, k", [(2, 1200, 30), (1, 1001, 20), (1, 1001, 70), (3, 77, 1)])
def test_fused_extrema_kernel_grids(dev, b, n, k):
    """Every grid (one block an SM by default; one block walking every
    query; ranges of unequal length; more blocks than queries) gives the
    plain version's outputs exactly, on local neighbours with indices
    outside [0, n) and on spread ones, k over one warp's 32 lanes too."""
    rng = np.random.default_rng(n + k)
    table, bvec = _on(dev, *rng.standard_normal((2, b, n, 64)).astype(np.float32))
    (s, t), = [fold_bn(*_on(dev, v["gamma"], v["beta"], v["mean"], v["var"]))
               for v in (random_bn(rng, 64),)]
    gamma = torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32)).to(dev)
    local = np.arange(n)[None, :, None] + rng.integers(-40, 40, (b, n, k))
    for name, idx in (("local", np.clip(local, -3, n + 2)),
                      ("spread", rng.integers(-2, n + 2, (b, n, k)))):
        idx, = _on(dev, idx.astype(np.int32))
        want = edgeconv_fused_extrema_plain(table, idx, bvec, gamma, s, t)
        for grid in (0, 1, 3, 7, 264, 100000):
            got = launch_extrema(table, idx, bvec, [gamma, s, t], grid)
            assert torch.equal(got, want), (name, grid)


def test_default_model_on_cuda_matches_cpu_plain_versions(dev):
    """The default configuration (auto, bands 2048/4096) on the card
    against the CPU plain versions of the same banded path."""
    model = init_dgcnn(DGCNNConfig(k=30, emb_dims=64), torch.Generator().manual_seed(1))
    # on the CPU "auto" is the exact kNN: ask for the banded path by name
    plain = init_dgcnn(DGCNNConfig(k=30, emb_dims=64, knn_impl="pallas_capped"))
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(sorted_blocks(2, 5000, seed=9))
    with torch.no_grad():
        want = torch.softmax(plain(x), -1)
        before = knn_banded_raw.launches
        got = torch.softmax(model.to(dev)(x.to(dev)), -1).cpu()
    assert knn_banded_raw.launches == before + 3
    assert (got - want).abs().max().item() <= 1e-3


def test_model_on_cuda_matches_cpu_plain_versions(dev):
    cfg = DGCNNConfig(k=20, emb_dims=64, knn_impl="pallas_capped", knn_band=0,
                      knn_band_feature=0)
    model = init_dgcnn(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(sorted_blocks(2, 1024, seed=4))
    with torch.no_grad():
        want = torch.softmax(model(x), -1)
        got = torch.softmax(model.to(dev)(x.to(dev)), -1).cpu()
    assert (got - want).abs().max().item() <= 1e-3


def _shifted(dev, a, shift):
    """``a`` on the card as a contiguous view that starts ``shift`` elements
    into its buffer: shift 1 leaves it 4-byte but not 16-byte aligned."""
    flat = torch.zeros(a.size + shift, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
    flat[shift:] = torch.from_numpy(np.ascontiguousarray(a)).reshape(-1).to(dev)
    return flat[shift:].view(a.shape)


# rows per thread is 4 and a block takes 1024 slots, so M = 3001 and 4097
# leave ragged tails; C = 1, 3, 68 and the misaligned views take the
# 4-byte or generic paths, C = 4 and 64 the widths the port runs
ROW_CASES = [  # (b, m, n, c, shift of (values, idx))
    *[(2, 3001, 390, c, (0, 0)) for c in (1, 3, 4, 5, 8, 64, 68, 128)],
    (2, 0, 390, 4, (0, 0)), (2, 0, 390, 64, (0, 0)),             # M = 0
    (1, 4097, 1000, 64, (0, 0)), (8, 4097, 1000, 4, (0, 0)),     # B = 1, B = 8
    (8, 4097, 1000, 64, (0, 0)),
    (2, 3001, 390, 4, (1, 0)), (2, 3001, 390, 64, (1, 0)),       # misaligned values
    (2, 3001, 390, 4, (0, 1)), (2, 3001, 390, 64, (0, 1)),       # misaligned indices
]


@pytest.mark.parametrize("b, m, n, c, shift", ROW_CASES)
def test_scatter_add_rows_kernel_equals_plain(dev, b, m, n, c, shift):
    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_add_rows, scatter_add_rows_plain

    rng = np.random.default_rng(m + c)
    dy = _shifted(dev, rng.standard_normal((b, m, c)).astype(np.float32), shift[0])
    # some out of range: they clamp
    idx = _shifted(dev, rng.integers(-2, n + 10, (b, m)).astype(np.int32), shift[1])
    before = scatter_add_rows.launches
    got = scatter_add_rows(dy, idx, n)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    # atomics: the sum order changes from run to run
    torch.testing.assert_close(got, scatter_add_rows_plain(dy, idx, n), atol=1e-5, rtol=1e-5)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    assert not scatter_add_rows(dy, idx, n, pred=no).any()  # the predicate: zeros


@pytest.mark.parametrize("values", ["integers", "floats"])
@pytest.mark.parametrize("c", [1, 4, 64])
def test_scatter_add_rows_kernel_all_rows_to_one_target(dev, c, values):
    """Every index equal: all B*M rows of an element add into one row, the
    most contention the reductions can meet. Integer values keep every
    partial sum exact in FP32, so any order gives the same bits and a lost
    or doubled add shows. On floats each of the two sums (the kernel's and
    index_add_'s, both atomic) is within (m - 1) * 2^-24 * sum |dy| of the
    exact one (recursive summation's bound), so they differ by at most
    twice that."""
    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_add_rows, scatter_add_rows_plain

    b, m, n = 2, 6001, 50
    rng = np.random.default_rng(c)
    a = (rng.integers(-8, 9, (b, m, c)) if values == "integers"
         else rng.standard_normal((b, m, c))).astype(np.float32)
    dy, idx = _on(dev, a, np.full((b, m), 7, np.int32))
    got = scatter_add_rows(dy, idx, n)
    want = scatter_add_rows_plain(dy, idx, n)
    if values == "integers":
        assert torch.equal(got, want)
    else:
        atol = 2 * (m - 1) * 2.0 ** -24 * dy.abs().sum(1).max().item()
        torch.testing.assert_close(got, want, atol=atol, rtol=0)
    assert not got[:, :7].any() and not got[:, 8:].any()


def test_scatter_stage_tail_kernel_equals_plain(dev):
    from dgcnn_tpu_torch.kernels.scatter_rows import (
        scatter_stage_tail_rows, scatter_stage_tail_rows_plain)

    rng = np.random.default_rng(9)
    u, w = _on(dev, *rng.standard_normal((2, 2, 900, 64)).astype(np.float32))
    am, = _on(dev, rng.integers(0, 30, (2, 900, 64)).astype(np.int8))
    idx, = _on(dev, rng.integers(0, 900, (2, 900, 30)).astype(np.int32))
    sums, count = scatter_stage_tail_rows(u, w, am, idx)
    want_sums, want_count = scatter_stage_tail_rows_plain(u, w, am, idx)
    torch.testing.assert_close(sums, want_sums, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(count, want_count, atol=0, rtol=0)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    assert not scatter_stage_tail_rows(u, w, am, idx, pred=no)[0].any()


def _assert_tail_close(got, want, u, w, am, idx):
    """The tail's sums within 1e-5 (absolute and relative) of the plain
    version's, or, on a row that takes many entries (a clamped row 0 or
    N-1, a hub of a feature-space kNN), within twice the recursive-
    summation bound (hits - 1) * 2^-24 * sum |term| of each of the two
    sums, which add the same terms in different (atomic) orders; the count
    exact."""
    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_stage_tail_rows_plain

    mag, count = scatter_stage_tail_rows_plain(u.abs(), w.abs(), am, idx)
    assert torch.equal(got[1], want[1]) and torch.equal(got[1], count)
    bound = 2 * count[..., None] * 2.0 ** -24 * mag
    err = (got[0] - want[0]).abs()
    assert (err <= torch.maximum(1e-5 + 1e-5 * want[0].abs(), bound)).all(), err.max().item()


# (b, n, k, c): widths of one to three channel chunks, a ragged cloud of
# one element, and one past the tile's rows (the global route)
TAIL_CASES = [*[(2, 3001, 30, c) for c in (1, 3, 4, 64, 128)],
              (1, 1001, 20, 64), (1, 1001, 1, 5), (1, 60000, 30, 64)]


@pytest.mark.parametrize("b, n, k, c", TAIL_CASES)
def test_scatter_stage_tail_kernel_cases(dev, b, n, k, c):
    """The tail kernel at its plan's tile against the plain version,
    indices in [-7, N+7) clamped; a False predicate leaves zeros on both
    routes."""
    from dgcnn_tpu_torch.kernels.scatter_rows import (
        scatter_stage_tail_rows, scatter_stage_tail_rows_plain, tail_plan)

    rng = np.random.default_rng(n + c + k)
    u, w = _on(dev, *rng.standard_normal((2, b, n, c)).astype(np.float32))
    am, = _on(dev, rng.integers(-1, k, (b, n, c)).astype(np.int8))
    idx, = _on(dev, rng.integers(-7, n + 7, (b, n, k)).astype(np.int32))
    before = scatter_stage_tail_rows.launches
    got = scatter_stage_tail_rows(u, w, am, idx)
    torch.cuda.synchronize()
    assert scatter_stage_tail_rows.launches == before + 1
    _assert_tail_close(got, scatter_stage_tail_rows_plain(u, w, am, idx), u, w, am, idx)
    assert (tail_plan(b, n, k, c) == 0) == (n == 60000)  # the route the case is for
    no = torch.zeros((), dtype=torch.bool, device=dev)
    assert not any(t.any() for t in scatter_stage_tail_rows(u, w, am, idx, pred=no))


def test_scatter_stage_tail_kernel_on_feature_knn(dev):
    """The production shape (B=8, N=7000, k=30, C=64) on feature-space kNN
    indices, as stage 3 hands them (hubs: rows many queries share)."""
    from dgcnn_tpu_torch.kernels.scatter_rows import (
        scatter_stage_tail_rows, scatter_stage_tail_rows_plain, tail_plan)

    rng = np.random.default_rng(12)
    feats, u, w = _on(dev, *rng.standard_normal((3, 8, 7000, 64)).astype(np.float32))
    am, = _on(dev, rng.integers(0, 30, (8, 7000, 64)).astype(np.int8))
    idx = knn_capped(feats, 30)
    assert tail_plan(8, 7000, 30, 64) == 68
    _assert_tail_close(scatter_stage_tail_rows(u, w, am, idx),
                       scatter_stage_tail_rows_plain(u, w, am, idx), u, w, am, idx)


# (c, qt, shift): one to three chunks of 64 channels two a lane (C even)
# or 32 one a lane (C odd), tables aligned or one float off (shift 1),
# tiles of 1 to 136 queries (4080 entries), the global route
TAIL_GEOMETRIES = [*[(c, qt, s) for c in (3, 64, 130) for qt in (1, 7, 68, 136)
                     for s in (0, 1)], *[(c, 0, s) for c in (3, 64) for s in (0, 1)]]


@pytest.mark.parametrize("c, qt, shift", TAIL_GEOMETRIES)
def test_scatter_stage_tail_kernel_geometries(dev, c, qt, shift):
    """Every instance and tile of the kernel, whatever the plan would take;
    a False predicate leaves zeros."""
    from dgcnn_tpu_torch.kernels.scatter_rows import launch_tail, scatter_stage_tail_rows_plain

    b, n, k = 2, 2500, 30
    rng = np.random.default_rng(c + qt)
    u = _shifted(dev, rng.standard_normal((b, n, c)).astype(np.float32), shift)
    w = _shifted(dev, rng.standard_normal((b, n, c)).astype(np.float32), shift)
    am, = _on(dev, rng.integers(-1, k, (b, n, c)).astype(np.int8))
    idx, = _on(dev, rng.integers(-7, n + 7, (b, n, k)).astype(np.int32))
    got = launch_tail(u, w, am, idx, qt=qt)
    _assert_tail_close(got, scatter_stage_tail_rows_plain(u, w, am, idx), u, w, am, idx)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    assert not any(t.any() for t in launch_tail(u, w, am, idx, qt=qt, pred=no))


def test_train_step_on_cuda_matches_cpu_plain_versions(dev):
    """One training forward and backward (default configuration, dropout
    off) on the card against the CPU plain versions of the banded path,
    the CPU replaying the card's neighbour indices."""
    from dgcnn_tpu_torch.ops.losses import masked_smoothed_cross_entropy

    model = init_dgcnn(DGCNNConfig(k=30, emb_dims=64, dropout=0.0),
                       torch.Generator().manual_seed(2))
    plain = init_dgcnn(DGCNNConfig(k=30, emb_dims=64, dropout=0.0, knn_impl="pallas_capped"))
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(sorted_blocks(2, 3000, seed=10))
    labels = torch.from_numpy(rng.integers(0, 5, (2, 3000)))
    replay_knn(model, plain)
    grads = []
    for m, d in ((model.to(dev), dev), (plain, torch.device("cpu"))):
        m.train()
        masked_smoothed_cross_entropy(m(x.to(d)), labels.to(d), torch.ones(2, 3000, device=d)
                                      ).backward()
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
    floor = 1e-3 * max(g.norm().item() for g in grads[1].values())
    for k, want in grads[1].items():
        # the tolerance of tests/test_torch_train.py: sum order (atomics, cuBLAS)
        assert (grads[0][k] - want).norm().item() / max(want.norm().item(), floor) <= 1e-2, k


@pytest.mark.parametrize("b, m, n, c, shift", [
    (2, 90000, 3000, 4, (0, 0)), (2, 90000, 3000, 64, (0, 0)),  # the stage widths
    (3, 12345, 1001, 3, (0, 0)), (1, 301, 77, 64, (0, 0)),      # ragged
    *ROW_CASES,
])
def test_gather_rows_kernel_equals_plain(dev, b, m, n, c, shift):
    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain

    rng = np.random.default_rng(n + c)
    table = _shifted(dev, rng.standard_normal((b, n, c)).astype(np.float32), shift[0])
    idx = _shifted(dev, rng.integers(-5, n + 5, (b, m)).astype(np.int32), shift[1])  # some clamp
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))  # a copy: bit for bit


def test_training_gather_launches_the_kernel(dev):
    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain
    from dgcnn_tpu_torch.ops.edgeconv import gather_neighbors

    rng = np.random.default_rng(4)
    feats, = _on(dev, rng.standard_normal((2, 500, 64)).astype(np.float32))
    idx, = _on(dev, rng.integers(0, 500, (2, 500, 20)).astype(np.int32))
    before = gather_rows.launches
    got = gather_neighbors(feats, idx)
    assert gather_rows.launches == before + 1
    want = gather_rows_plain(feats, idx.reshape(2, -1)).reshape(2, 500, 20, 64)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="float32"):
        gather_neighbors(feats.double(), idx)


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("c", [3, 64])
def test_split_kernel_equals_plain_on_integer_inputs(dev, c, splits):
    from dgcnn_tpu_torch.kernels.knn_packed import _knn_packed_split, knn_packed_split_plain

    rng = np.random.default_rng(c + splits)
    x, q = _on(dev, rng.integers(0, 64, (2, 3000, c)).astype(np.float32),
               rng.integers(0, 64, (2, 90, c)).astype(np.float32))
    before = _knn_packed_split.launches
    assert torch.equal(knn_packed(x, 30, splits=splits), knn_packed_split_plain(x, 30))
    assert torch.equal(knn_packed(x, 13, queries=q, splits=splits),
                       knn_packed_split_plain(x, 13, queries=q))
    assert _knn_packed_split.launches == before + 2


@pytest.mark.parametrize("c", [4, 64])
def test_split_kernel_at_the_production_shape(dev, c):
    """B=8, N=7000: on integers in [0, 16), where the split keys part from
    the flat ones, equal to the plain version; on floats, splits 2 and 8
    equal (the slicing shapes no result)."""
    from dgcnn_tpu_torch.kernels.knn_packed import knn_packed_split_plain

    rng = np.random.default_rng(c)
    ints, floats = _on(dev, rng.integers(0, 16, (8, 7000, c)).astype(np.float32),
                       rng.standard_normal((8, 7000, c)).astype(np.float32))
    assert torch.equal(knn_packed(ints, 30, splits=2), knn_packed_split_plain(ints, 30))
    assert torch.equal(knn_packed(ints, 30, splits=8), knn_packed_split_plain(ints, 30))
    assert torch.equal(knn_packed(floats, 30, splits=2), knn_packed(floats, 30, splits=8))


def test_split_routing_and_launch_counts(dev):
    """As chip_smoke.path_split: splits 2 and 8 launch the split kernel
    once each; splits=3 (7040 % 3 != 0) and N=9000 (n_pad 9088 > 8192) the
    flat kernel; the split entry point refuses n_pad > 8192."""
    from dgcnn_tpu_torch.kernels.knn_packed import _knn_packed_split, launch_split

    rng = np.random.default_rng(16)
    x, big = _on(dev, rng.standard_normal((2, 7000, 64)).astype(np.float32),
                 rng.standard_normal((1, 9000, 4)).astype(np.float32))
    for run, want in ((lambda: knn_packed(x, 30, splits=2), (0, 1)),
                      (lambda: knn_packed(x, 30, queries=x[:, :1000], splits=8), (0, 1)),
                      (lambda: knn_packed(x, 30, splits=3), (1, 0)),
                      (lambda: knn_packed(big, 30, splits=2), (1, 0))):
        before = knn_packed.launches, _knn_packed_split.launches
        run()
        assert (knn_packed.launches - before[0], _knn_packed_split.launches - before[1]) == want
    norms = (big * big).sum(-1)
    with pytest.raises(RuntimeError, match="knn_packed_split"):
        launch_split(big, big, norms, norms, 30, qb=32)


def test_eval_test_on_the_card(dev, tmp_path):
    """One ``test()`` on the card against the same call on the CPU plain
    versions: the devices' kNNs may break a near-tie differently, so a few
    predictions may differ."""
    from dgcnn_tpu_torch.eval.test import test
    from dgcnn_tpu_torch.train.checkpoint import save_checkpoint
    from dgcnn_tpu_torch.train.steps import init_train_state
    from dgcnn_tpu_torch.utils.logging import IOStream
    from torch_port_helpers import write_rooms

    write_rooms(str(tmp_path), n_rooms=6, n_points=1500, seed=3)
    cfg = DGCNNConfig(k=20, emb_dims=64)
    save_checkpoint(str(tmp_path / "ckpt" / "dgcnn_model.npz"),
                    init_train_state(cfg, seed=4, device="cpu"))
    kw = dict(data_dir=str(tmp_path), num_points=1024, num_features=4, test_batch_size=2,
              emb_dims=64, min_class_confidence=0.0, model_root=str(tmp_path / "ckpt"),
              validation_prop=0.5)
    io = IOStream(str(tmp_path / "eval.log"))
    gpu = test(20, io, pred_dir=str(tmp_path / "gpu"), device="cuda", **kw)
    cpu = test(20, io, pred_dir=str(tmp_path / "cpu"), device="cpu", knn_impl="pallas_capped",
               **kw)
    total = gpu["confusion"].sum()
    assert total == 3 * 1024
    assert np.abs(gpu["confusion"] - cpu["confusion"]).sum() / 2 <= 0.005 * total


@pytest.mark.parametrize("b, n, exclude", [(8, 7000, ()), (8, 7000, (4,)), (1, 1001, (0,))])
def test_class_balance_mask_on_the_card_equals_the_cpu_s(dev, b, n, exclude):
    """``ops/masks.py`` on the card against the CPU on the same uniforms,
    the rounding edge of ``label + u`` included; and the generator path
    marks m points of every considered class."""
    from dgcnn_tpu_torch.ops.masks import balanced_train_mask, balanced_train_mask_from_u

    rng = np.random.default_rng(b * n)
    labels = rng.integers(0, 5, (b, n))
    labels[0, : n // 3] = 2  # a dominant class
    u = rng.random((b, n)).astype(np.float32)
    u[rng.random((b, n)) < 0.05] = np.float32(1.0 - 2.0 ** -23)
    u[rng.random((b, n)) < 0.05] = 0.0
    lab, uu = torch.from_numpy(labels), torch.from_numpy(u)
    want = balanced_train_mask_from_u(lab, uu, 5, exclude)
    got = balanced_train_mask_from_u(lab.to(dev), uu.to(dev), 5, exclude)
    assert torch.equal(got.cpu(), want)
    gen = torch.Generator(device=dev).manual_seed(3)
    mask = balanced_train_mask(lab.to(dev), 5, exclude, gen).cpu()
    for row in range(b):
        counts = np.bincount(labels[row], minlength=5)
        kept = [c for c in range(5) if c not in exclude]
        m = min(int(counts[kept].min()), n // 5)
        picked = np.bincount(labels[row][mask[row].numpy() > 0], minlength=5)
        assert all(picked[c] == (0 if c in exclude else m) for c in range(5))


@pytest.mark.parametrize("c", [6, 9])
def test_stage1_kernels_at_the_wide_feature_widths_equal_plain(dev, c):
    """Stage 1 of a wide-feature model (C=6 pads to kernel width 8, C=9 to
    16) at the production shape, B=8, N=7000, k=30: the capped (the banded
    wrapper's fallback), banded, flat exact (256 queries, with and without
    the row hint: at width 8 a 7000-row cloud does not fit in shared
    memory), exact banded, packed and split kNN kernels bit for bit against
    their plain versions on integers in [0, 16); the training gather of
    the points (rows of C floats, not 16-byte aligned) on their indices."""
    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain
    from dgcnn_tpu_torch.kernels.knn_packed import knn_packed_split_plain

    rng = np.random.default_rng(c)
    ints = rng.integers(0, 16, (8, 7000, c)).astype(np.float32)
    ints = np.take_along_axis(ints, np.argsort(ints[..., 0], axis=1, kind="stable")[..., None], 1)
    x, floats = _on(dev, ints, rng.standard_normal((8, 7000, c)).astype(np.float32) * 1000)
    rows = torch.from_numpy(rng.permutation(7000)[:256]).to(dev).expand(8, -1).contiguous()
    q = x.gather(1, rows[..., None].expand(-1, -1, c))
    band = dict(band=2048, n_win=64, cap=6, query_tile=512)
    eb = dict(band=2048, n_win=64, cap=8, query_tile=256)
    pairs = {
        "capped": (knn_capped(x, 30, cap=8), knn_capped_plain(x, 30, cap=8)),
        "banded": (knn_banded_raw(x, 30, **band), knn_banded_raw_plain(x, 30, **band)),
        "exact": (knn_exact(x, 30, queries=q), knn_exact_plain(x, 30, queries=q)),
        "exact, hinted": (knn_exact(x, 30, queries=q, query_rows=rows),
                          knn_exact_plain(x, 30, queries=q)),
        "exact banded": (knn_exact_banded_raw(x, 30, **eb),
                         knn_exact_banded_raw_plain(x, 30, **eb)),
        "packed": (knn_packed(x, 30), knn_packed_plain(x, 30)),
        "split": (knn_packed(x, 30, splits=2), knn_packed_split_plain(x, 30)),
    }
    for name, (got, want) in pairs.items():
        got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
    idx = pairs["capped"][0].reshape(8, -1)
    assert torch.equal(gather_rows(floats, idx), gather_rows_plain(floats, idx))


# ---------------------------------------- remat and bf16 training on the card

def _train_grads(model, x, labels, remat="off"):
    from dgcnn_tpu_torch.ops.losses import masked_smoothed_cross_entropy

    model.zero_grad(set_to_none=True)
    d = next(model.parameters()).device
    loss = masked_smoothed_cross_entropy(model(x.to(d), remat=remat), labels.to(d),
                                         torch.ones(labels.shape, device=d))
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}


def _worst_rel(got, want):
    floor = 1e-3 * max(g.norm().item() for g in want.values())
    return max((got[k] - w).norm().item() / max(w.norm().item(), floor) for k, w in want.items())


# the scatters add with atomics, so two "off" backwards on the card differ
# in the last bits; a recompute reproduces the forward, so remat adds no
# more than that (measured on the H100: below 1e-5 per leaf)
REMAT_CARD_REL = 1e-4


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_remat_on_cuda_matches_off_and_counts_its_launches(dev, compute_dtype):
    """The default configuration's step under each remat mode: gradients
    within the atomics' tolerance of "off" (FP32; bf16 rounds each
    cotangent, so there a last-bit difference may move a leaf further:
    held to the CPU test's bf16 budget), running statistics equal, and the
    launches: the gathers again in each recomputed stage (selective), twice
    again under full (the whole forward, then each nested stage region),
    the banded kNN again under full, neither stage kernel in a train
    step."""
    from dgcnn_tpu_torch.kernels.edgeconv_fused import (
        edgeconv_fused_extrema, edgeconv_fused_stage, edgeconv_fused_stage_bf16)
    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows
    from dgcnn_tpu_torch.kernels.knn_banded import knn_banded_raw
    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_add_rows, scatter_stage_tail_rows

    counted = {"gather_rows": gather_rows, "knn_banded": knn_banded_raw,
               "scatter_add_rows": scatter_add_rows,
               "scatter_stage_tail_rows": scatter_stage_tail_rows,
               "stage": edgeconv_fused_stage, "stage_bf16": edgeconv_fused_stage_bf16,
               "extrema": edgeconv_fused_extrema}
    cfg = DGCNNConfig(k=30, emb_dims=64, dropout=0.0, compute_dtype=compute_dtype)
    model = init_dgcnn(cfg, torch.Generator().manual_seed(2)).to(dev).train()
    rng = np.random.default_rng(3)
    # N past the feature band (4096), so that all three stages take the banded kNN
    x = torch.from_numpy(sorted_blocks(2, 7000, seed=10))
    labels = torch.from_numpy(rng.integers(0, 5, (2, 7000)))
    runs = {}
    for mode in ("off", "off", "selective", "full"):
        stats0 = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("bn")}
        before = {n: f.launches for n, f in counted.items()}
        loss, grads = _train_grads(model, x, labels, mode)
        torch.cuda.synchronize()
        launches = {n: f.launches - before[n] for n, f in counted.items()}
        stats = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("bn")}
        model.load_state_dict({**model.state_dict(), **stats0})
        runs.setdefault(mode, []).append((loss, grads, launches, stats))
    noise = _worst_rel(runs["off"][1][1], runs["off"][0][1])
    # bf16 rounds each product's operands and cotangents: a last-bit
    # difference of the atomics may move a leaf much further (the CPU
    # test's budget, 0.3, or twice the two "off" runs' own distance)
    tol = REMAT_CARD_REL if compute_dtype is None else max(0.3, 2.0 * noise)
    want = {"off": (3, 3), "selective": (6, 3), "full": (9, 6)}
    for mode, ((loss, grads, launches, stats),) in (("selective", runs["selective"]),
                                                    ("full", runs["full"])):
        assert loss == runs["off"][0][0], mode  # the forward is the same computation
        assert _worst_rel(grads, runs["off"][0][1]) <= tol, (mode, noise)
        assert all(torch.equal(stats[k], v) for k, v in runs["off"][0][3].items()), mode
    for mode, rs in runs.items():
        for _, _, launches, _ in rs:
            assert (launches["gather_rows"], launches["knn_banded"]) == want[mode], launches
            assert launches["scatter_add_rows"] == launches["scatter_stage_tail_rows"] == 1
            assert launches["stage"] == launches["stage_bf16"] == launches["extrema"] == 0
    assert noise <= tol


def test_bf16_train_step_on_cuda_matches_cpu_plain_versions(dev):
    """One bf16 training forward and backward on the card (the trunk's
    products by ``torch.mm(..., out_dtype=torch.float32)`` where torch has
    it, the backward's in FP32) against the CPU plain versions on the
    card's kNN graph. The bf16 step is ill-conditioned
    (``tests/test_torch_bf16_train.py``), so the loss and the worst leaf
    are held to twice the most that scaling the weights by 1 +- 2^-22 or
    1 +- 2^-21 does to the CPU step itself on the same graph; the FP32
    step's gradients lie beyond that."""
    cfg = DGCNNConfig(k=30, emb_dims=64, dropout=0.0, compute_dtype="bfloat16")
    model = init_dgcnn(cfg, torch.Generator().manual_seed(2))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(sorted_blocks(2, 3000, seed=10))
    labels = torch.from_numpy(rng.integers(0, 5, (2, 3000)))
    graph = []

    def record(*args, **kwargs):
        graph.append(type(model)._knn(model, *args, **kwargs).cpu())
        return graph[-1].to(dev)

    model._knn = record
    got = _train_grads(model.to(dev).train(), x, labels)
    scales = (1.0 + 2.0 ** -22, 1.0 - 2.0 ** -22, 1.0 + 2.0 ** -21, 1.0 - 2.0 ** -21)
    runs = {}
    for dtype in ("bfloat16", None):
        for scale in (1.0, *scales) if dtype else (1.0,):
            plain = init_dgcnn(DGCNNConfig(k=30, emb_dims=64, dropout=0.0, compute_dtype=dtype,
                                           knn_impl="pallas_capped"))
            plain.load_state_dict({k: v * scale if k.endswith(".w") else v
                                   for k, v in weights.items()})
            queue = list(graph)
            plain._knn = lambda v, *a, **kw: queue.pop(0)
            runs[dtype, scale] = _train_grads(plain.train(), x, labels)
    want = runs["bfloat16", 1.0]
    spread_loss = max(abs(runs["bfloat16", s][0] - want[0]) for s in scales)
    spread_leaf = max(_worst_rel(runs["bfloat16", s][1], want[1]) for s in scales)
    assert abs(got[0] - want[0]) <= 2.0 * spread_loss, (got[0], want[0], spread_loss)
    assert _worst_rel(got[1], want[1]) <= 2.0 * spread_leaf, spread_leaf
    assert _worst_rel(runs[None, 1.0][1], want[1]) > 2.0 * spread_leaf
    for k, g in got[1].items():  # a weight one product owns gets bf16 values
        if k in ("conv2.w", "conv4.w", "conv6.w", "conv7.w", "conv8.w", "conv9.w"):
            assert torch.equal(g, g.bfloat16().float()), k


def test_whether_mm_out_dtype_has_a_derivative(dev):
    """Records whether this torch's ``torch.mm(..., out_dtype=)`` has a
    derivative (the port's bf16 backward does not use it): either it
    computes the FP32 product's gradient, or autograd refuses it. The
    port's ``mm`` gives JAX's rounded cotangents either way."""
    from dgcnn_tpu_torch.ops.matmul import mm

    rng = np.random.default_rng(5)
    a, b, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
               for s in ((64, 32), (32, 16), (64, 16)))
    ab = a.bfloat16().requires_grad_()
    try:
        torch.mm(ab, b.bfloat16(), out_dtype=torch.float32).backward(g)
        has = ab.grad is not None
    except (RuntimeError, NotImplementedError, TypeError) as e:
        has = False
        print(f"torch.mm(..., out_dtype=) has no derivative here: {e}")
    print(f"torch {torch.__version__}: torch.mm(..., out_dtype=) derivative: {has}")
    a32 = a.clone().requires_grad_()
    mm(a32, b, torch.bfloat16).backward(g)
    want = (g.double() @ b.bfloat16().double().t()).float().bfloat16().float()
    assert torch.allclose(a32.grad, want, rtol=2 ** -7, atol=0)
    assert torch.equal(a32.grad, a32.grad.bfloat16().float())


# the approximate kNN kernel: (B, N, C, k, queries, recall_target) covering L
# = N, L = 128 (k = 1), a short last chunk, every list size (16, 32, 64),
# an odd channel count and queries= rows
APPROX_CASES = [
    (2, 1000, 4, 30, None, 0.95),   # L = N
    (2, 7000, 4, 30, None, 0.95),   # L = 896, 7000 = 7 * 896 + 728
    (1, 7000, 64, 30, None, 0.95),
    (2, 2000, 3, 20, None, 0.95),   # L = 512, C padded to 4
    (1, 5000, 16, 64, None, 0.95),  # 64 slots
    (2, 4096, 8, 10, None, 0.9),    # 16 slots
    (1, 3000, 4, 1, None, 0.95),    # k = 1: L = 128
    (2, 7000, 64, 30, 1000, 0.95),
    (1, 129, 4, 5, 7, 0.5),         # a partial block of queries
]


@pytest.mark.parametrize("b, n, c, k, m, r", APPROX_CASES)
def test_approx_kernel_equals_plain_on_integer_inputs(dev, b, n, c, k, m, r):
    rng = np.random.default_rng(n + c + k)
    x, = _on(dev, rng.integers(0, 8, (b, n, c)).astype(np.float32))
    q = None if m is None else _on(dev, rng.integers(0, 8, (b, m, c)).astype(np.float32))[0]
    before = knn_approx.launches
    got = knn_approx(x, k, r, queries=q)
    torch.cuda.synchronize()
    assert knn_approx.launches == before + 1
    assert torch.equal(got, knn(x, k, approx=True, recall_target=r, queries=q))


def test_approx_kernel_where_nothing_is_folded_is_the_exact_kernel_on_floats(dev):
    """L = N: the same score bits and order as the flat exact kernel."""
    x, = _on(dev, sorted_blocks(2, 1000, seed=3))
    assert approx_reduction_size(1000, 30) == 1000
    assert torch.equal(knn_approx(x, 30), knn_exact(x, 30))


@pytest.mark.parametrize("c", [4, 64])
def test_approx_kernel_agrees_with_plain_on_floats(dev, c):
    x, = _on(dev, sorted_blocks(2, 7000, seed=4) if c == 4 else
             np.random.default_rng(5).standard_normal((2, 7000, 64)).astype(np.float32))
    # cuBLAS's FP32 sum order differs from the kernel's: a near-tie may swap
    assert (knn_approx(x, 30) == knn(x, 30, approx=True)).float().mean() >= 0.999


def test_approx_kernel_gives_the_first_design_bits(dev):
    """The kernel's indices on chip_smoke.approx_digest_inputs (make_blocks
    at C=4, normal C=64, 1000 queries, a cloud with inf / nan coordinates)
    hash to the first design's SHA-256 digests, chip_smoke.APPROX_DIGESTS."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_approx_digests", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert set(cs.approx_digests_held()) == set(cs.APPROX_DIGESTS)


def test_approx_kernel_refuses_what_it_does_not_take(dev):
    x, = _on(dev, sorted_blocks(1, 500, seed=6))
    for k in (0, 65):
        with pytest.raises(ValueError, match="k"):
            knn_approx(x, k)
    with pytest.raises(ValueError, match="recall_target"):
        knn_approx(x, 10, 0.0)
    with pytest.raises(ValueError, match="float32"):
        knn_approx(x.double(), 10)


def test_approx_forward_launches_the_kernel_three_times(dev):
    cfg = DGCNNConfig(k=20, emb_dims=64, knn_impl="approx")
    model = DGCNN(cfg)
    model.load_state_dict(init_dgcnn(cfg, torch.Generator().manual_seed(0)).state_dict())
    x = torch.from_numpy(sorted_blocks(2, 3000, seed=7))
    with torch.inference_mode():
        want = torch.softmax(model(x), -1)
        before = knn_approx.launches
        got = torch.softmax(model.to(dev)(x.to(dev)), -1).cpu()
    assert knn_approx.launches == before + 3
    assert (got - want).abs().max() <= 1e-3


# ------------------------------------------- training tails (edgeconv_train)

TAIL_SHAPES = [(2, 1000, 30), (8, 7000, 30), (1, 37, 5), (2, 300, 127)]


def _tail_case(dev, b, n, k, seed):
    """(B, N, k, 64) neighbour terms with exact ties across k, the point
    term, a cotangent, BN vectors (a negative and a zero gamma), and the
    channel vectors from the plain sums."""
    from dgcnn_tpu_torch.kernels import edgeconv_train as et

    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn((b, n, k, 64), generator=g, device=dev) * 2 + 0.5
    if k > 4:
        p[:, :, 4] = p[:, :, 2]  # ties: slot 2 is the first maximum where they win
    bvec = torch.randn((b, n, 64), generator=g, device=dev)
    gz = torch.randn((b, n, k, 64), generator=g, device=dev)
    gamma = (torch.rand(64, generator=g, device=dev) + 0.5) * torch.where(
        torch.rand(64, generator=g, device=dev) < 0.3, -1.0, 1.0)
    gamma[5] = 0.0
    beta = 0.2 * torch.randn(64, generator=g, device=dev)
    m = b * n * k
    sums = et.tail_sums_plain(p, bvec)
    mean = sums[0] / m
    inv = torch.rsqrt((sums[1] / m - mean * mean).clamp_min(0.0) + 1e-5)
    return dict(p=p, bvec=bvec, gz=gz, gamma=gamma, beta=beta, mean=mean, inv=inv, m=m)


def _seq_sum_k(t):
    """sum over k in slot order, one rounding an add: the kernels' order."""
    acc = t[:, :, 0].clone()
    for j in range(1, t.shape[2]):
        acc = acc + t[:, :, j]
    return acc


def _sums_close(got, want64, abs64):
    # the kernels' FP32 sums (a lane's rows in order, then a fixed tree,
    # then FP64 across blocks) against float64: within 2e-6 of the sum of
    # magnitudes, a tenth of the worst case of a lane's ~200-add chains
    assert ((got.double() - want64).abs() <= 2e-6 * abs64).all()


@pytest.mark.parametrize("b, n, k", TAIL_SHAPES)
@pytest.mark.parametrize("with_bvec", [True, False])
def test_train_tail_forward_kernels_equal_plain(dev, b, n, k, with_bvec):
    from dgcnn_tpu_torch.kernels import edgeconv_train as et

    c = _tail_case(dev, b, n, k, seed=b + n + k)
    p, bvec = c["p"], (c["bvec"] if with_bvec else None)
    scale = c["inv"] * c["gamma"]
    e64 = (p + bvec[:, :, None, :] if with_bvec else p).double()
    sums = et.tail_sums(p, bvec)
    _sums_close(sums, torch.stack([e64.sum((0, 1, 2)), (e64 * e64).sum((0, 1, 2))]),
                torch.stack([e64.abs().sum((0, 1, 2)), (e64 * e64).sum((0, 1, 2))]))
    assert torch.equal(sums, et.tail_sums(p, bvec))  # no atomics: the same bits
    args = (p, bvec, c["mean"], scale, c["beta"])
    assert torch.equal(et.tail_apply(*args), et.tail_apply_plain(*args))
    mx, am, se = et.tail_max(*args, with_sum=True)
    want_mx, want_am, _ = et.tail_max_plain(*args)
    assert torch.equal(mx, want_mx) and torch.equal(am, want_am)
    e = p + bvec[:, :, None, :] if with_bvec else p
    assert torch.equal(se, _seq_sum_k(e))
    assert et.tail_max(*args)[2] is None


@pytest.mark.parametrize("b, n, k", TAIL_SHAPES)
@pytest.mark.parametrize("with_bvec", [True, False])
def test_train_tail_backward_kernels_equal_plain(dev, b, n, k, with_bvec):
    from dgcnn_tpu_torch.kernels import edgeconv_train as et

    c = _tail_case(dev, b, n, k, seed=2 * (b + n + k))
    p, bvec, g = c["p"], (c["bvec"] if with_bvec else None), c["gz"]
    vec = (c["mean"], c["inv"], c["gamma"], c["beta"])
    sums = et.tail_grad_sums(p, bvec, g, *vec)
    xhat = ((p + bvec[:, :, None, :] if with_bvec else p) - c["mean"]) * c["inv"]
    gp = torch.where(xhat * c["gamma"] + c["beta"] >= 0, g, 0.2 * g).double()
    _sums_close(sums, torch.stack([gp.sum((0, 1, 2)), (gp * xhat).sum((0, 1, 2))]),
                torch.stack([gp.abs().sum((0, 1, 2)), (gp * xhat).abs().sum((0, 1, 2))]))
    assert torch.equal(sums, et.tail_grad_sums(p, bvec, g, *vec))
    t1, t2 = sums.unbind(0)
    de, d_bvec = et.tail_grad(p, bvec, g, *vec, t1, t2, c["m"])
    want, _ = et.tail_grad_plain(p, bvec, g, *vec, t1, t2, c["m"])
    assert torch.equal(de, want)
    assert (d_bvec is None) == (not with_bvec)
    if with_bvec:
        assert torch.equal(d_bvec, _seq_sum_k(want))
    # the max tail's: the (B, N, 64) cotangent routed to the argmax slot
    mx, am, _ = et.tail_max(p, None, c["mean"], c["inv"] * c["gamma"], c["beta"])
    gq = g[:, :, 0]
    got = et.tail_max_grad(p, am, gq, c["mean"], c["inv"], c["gamma"], t1, t2, c["m"])
    assert torch.equal(got, et.tail_max_grad_plain(p, am, gq, c["mean"], c["inv"],
                                                   c["gamma"], t1, t2, c["m"]))


def test_train_tail_kernels_refuse_what_they_do_not_take(dev):
    from dgcnn_tpu_torch.kernels import edgeconv_train as et

    c = _tail_case(dev, 1, 50, 8, seed=9)
    vec = (c["mean"], c["inv"] * c["gamma"], c["beta"])
    for p, what in ((c["p"].double(), "float32"), (c["p"][..., :32], "64"),
                    (torch.zeros((1, 4, 128, 64), device=dev), "127")):
        with pytest.raises(ValueError, match=what):
            et.tail_apply(p, None, *vec)
    with pytest.raises(ValueError, match="channel vector"):
        et.tail_apply(c["p"], None, c["mean"].double(), *vec[1:])


def test_train_step_tails_take_the_kernels(dev):
    """A training forward and backward on the card: five tails, each on the
    kernels (``edgeconv.train_tail.plain`` 0), and the wrappers' launches."""
    from dgcnn_tpu_torch.kernels import edgeconv_train as et
    from dgcnn_tpu_torch.utils import profiling

    cfg = DGCNNConfig(k=20, emb_dims=64)
    model = init_dgcnn(cfg, torch.Generator().manual_seed(2)).to(dev).train()
    x = torch.from_numpy(sorted_blocks(2, 2048, seed=8)).to(dev)
    fns = (et.tail_sums, et.tail_apply, et.tail_max, et.tail_grad_sums, et.tail_grad,
           et.tail_max_grad)
    before = [fn.launches for fn in fns]
    profiling.reset()
    try:
        with profiling.recording():
            model(x).square().mean().backward()
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert counters.get("edgeconv.train_tail.kernel") == 5
    assert counters.get("edgeconv.train_tail.plain", 0) == 0
    assert [fn.launches - b for fn, b in zip(fns, before)] == [5, 2, 3, 2, 2, 2]
