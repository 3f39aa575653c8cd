"""The extrema kernel's partition of the queries, modelled on the CPU.

``csrc/edgeconv_fused.cu::edgeconv_extrema_kernel`` gives each of its
blocks a contiguous range of ``ceil(B*N / grid)`` queries (a range may span
two clouds) and each of the block's 32 warps the queries ``lo + w``,
``lo + w + 32``, ...; a warp folds its query's clamped neighbour rows into
a max and a min per channel (NaN skipped, as ``fmaxf`` / ``fminf`` skip
it), eight rows at a time. Max and min are exact in any order, so the
model below, for any grid, must cover every query exactly once and give
``edgeconv_fused_extrema_plain``'s outputs, indices outside [0, N)
included; on rows holding NaN it must give the plain version's outputs
with each NaN skipped. The kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.edgeconv_fused import (
    edgeconv_fused_extrema_plain,
    fold_bn,
    launch_extrema,
)
from dgcnn_tpu_torch.ops.edgeconv import lrelu

WARPS = 32  # csrc/edgeconv_fused.cu's kXWarps
UNROLL = 8  # rows in flight a warp


def model_extrema(table, idx, bvec, gamma, scale, shift, grid, seen=None):
    """The kernel's partition and fold in numpy (float32): (B, N, 64).
    Each query folded is counted in ``seen`` where given."""
    b, n, c = table.shape
    k = idx.shape[-1]
    total = b * n
    flat = table.reshape(total, c).numpy()
    rows = (np.arange(b)[:, None, None] * n + np.clip(idx.numpy(), 0, n - 1)).reshape(total, k)
    mx = np.full((total, c), -np.inf, np.float32)
    mn = np.full((total, c), np.inf, np.float32)
    per = -(-total // grid)
    for blk in range(min(grid, total)):
        lo, hi = blk * per, min(total, blk * per + per)
        for w in range(WARPS):
            for q in range(lo + w, hi, WARPS):
                if seen is not None:
                    seen[q] += 1
                for j0 in range(0, k, UNROLL):
                    for r in rows[q, j0:j0 + UNROLL]:
                        mx[q] = np.fmax(mx[q], flat[r])
                        mn[q] = np.fmin(mn[q], flat[r])
    mx, mn = (torch.from_numpy(a).reshape(b, n, c) for a in (mx, mn))
    sel = torch.where(gamma >= 0, mx + bvec, mn + bvec)  # the plain version's epilogue
    return lrelu(sel * scale + shift)


def _inputs(seed, b, n, k, lo=0, hi=None, nan_rows=0):
    rng = np.random.default_rng(seed)
    table, bvec = (torch.from_numpy(rng.standard_normal((b, n, 64)).astype(np.float32))
                   for _ in range(2))
    if nan_rows:
        table[0, rng.choice(n, nan_rows, replace=False), rng.integers(0, 64)] = float("nan")
    # neighbours near the query, as a spatially ordered cloud's are
    base = np.arange(n)[None, :, None] + rng.integers(-40, 40, (b, n, k))
    idx = torch.from_numpy(np.clip(base, lo, n - 1 if hi is None else hi).astype(np.int32))
    g = rng.uniform(0.5, 1.5, 64) * rng.choice([-1.0, 1.0], 64)
    scale, shift = fold_bn(*(torch.from_numpy(v.astype(np.float32)) for v in (
        g, rng.normal(0, 0.2, 64), rng.normal(0, 0.3, 64), rng.uniform(0.5, 2.0, 64))))
    return table, idx, bvec, torch.from_numpy(g.astype(np.float32)), scale, shift


# grids: one block (every warp many queries), a few blocks of unequal
# last range, the H100's 132 SMs (ranges shorter than 32 warps), more
# blocks than queries
GRIDS = [1, 3, 7, 132, 500]


@pytest.mark.parametrize("grid", GRIDS)
def test_partition_covers_every_query_once_and_equals_plain(grid):
    """B=2, N=150, k=30: ranges span the two clouds; indices outside
    [0, N) are clamped."""
    args = _inputs(grid, 2, 150, 30, lo=-3, hi=152)
    seen = np.zeros(300, np.int64)
    assert torch.equal(model_extrema(*args, grid, seen), edgeconv_fused_extrema_plain(*args))
    assert (seen == 1).all()


@pytest.mark.parametrize("k", [1, 20, 40, 70])
def test_fold_equals_plain_at_other_k(k):
    args = _inputs(k, 1, 101, k, lo=-2, hi=103)
    assert torch.equal(model_extrema(*args, 132), edgeconv_fused_extrema_plain(*args))


@pytest.mark.parametrize("grid", GRIDS[:3])
def test_fold_skips_nan_rows(grid):
    """A NaN in a gathered row is skipped (fmaxf / fminf), not propagated
    as the plain version's amax / amin propagate it: the model equals the
    plain version on the same table with each NaN replaced by -inf for the
    max and +inf for the min."""
    table, idx, bvec, gamma, scale, shift = _inputs(7, 1, 200, 30, nan_rows=20)
    got = model_extrema(table, idx, bvec, gamma, scale, shift, grid)
    nan = torch.isnan(table)
    want_mx = edgeconv_fused_extrema_plain(table.masked_fill(nan, -float("inf")), idx, bvec,
                                           gamma, scale, shift)
    want_mn = edgeconv_fused_extrema_plain(table.masked_fill(nan, float("inf")), idx, bvec,
                                           gamma, scale, shift)
    assert torch.equal(got, torch.where(gamma >= 0, want_mx, want_mn))
    assert not torch.isnan(got).any()


def test_constants_match_the_source():
    src = (_build.CSRC / "edgeconv_fused.cu").read_text()
    for line in (f"constexpr int kXWarps = {WARPS};", f"#pragma unroll {UNROLL}",
                 "const long long per = (total + gridDim.x - 1) / gridDim.x;",
                 "for (long long row = lo + warp; row < hi; row += kXWarps) {"):
        assert line in src, line


@pytest.mark.parametrize("k, grid", [(0, 0), (30, -1)])
def test_launch_refuses_what_the_kernel_does_not_take(k, grid):
    table, idx, bvec, gamma, scale, shift = _inputs(0, 1, 50, 30)
    with pytest.raises(ValueError, match="extrema kernel"):
        launch_extrema(table, idx[..., :k], bvec, [gamma, scale, shift], grid)
