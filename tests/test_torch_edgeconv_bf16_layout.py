"""The bf16 stage kernel's layout and walk, modelled on the CPU.

The kernel (``csrc/edgeconv_fused.cu::edgeconv_stage_bf16_kernel``) runs
only on a card. What decides its result besides the arithmetic is where
each value goes: which lane loads which (row, channel) pairs of a gathered
row, how they pack into the B fragments of ``mma.sync.m16n8k16`` (and W2's
into the A fragments), which lane holds which (output channel, row) of the
accumulator, which lane writes which output, and which warp takes which
(query, unit). This file writes that down in PyTorch, lane by lane, and
holds it against the dense tiles, against the plain version
(``edgeconv_fused_stage_plain(..., bf16_mm=True)``) and against the JAX
package's interpreted ``_stage_kernel(bf16_mm=True)``.

Fragments follow the PTX ISA's layouts of m16n8k16 with bf16 operands:
lane (g, t) = (lane // 4, lane % 4) holds A[g][2t + i] (register 0),
A[g + 8][2t + i] (1), A[g][2t + 8 + i] (2), A[g + 8][2t + 8 + i] (3);
B[2t + i][g] (0) and B[2t + 8 + i][g] (1); C/D[g][2t + i] (0, 1) and
D[g + 8][2t + i] (2, 3), the pair's element i = 0 at the lower half.

The mma model sums each k-step's 16 exact bf16 products and the
accumulator in float64 and rounds to FP32, k-steps 0..3 in order: the
tensor cores' own rounding of that sum is not modelled, so the model is
held at the stated 1e-5 (and within ``stage_bf16_tolerance``), not bit for
bit; bit equality across the kernel's designs is the card's to show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.edgeconv_pallas import edgeconv_fused_stage as jax_stage
from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.edgeconv_fused import (
    BF16_SMEM_BYTES,
    BF16_WARPS,
    H100_SMS,
    UNIT_ROWS,
    edgeconv_fused_stage_plain,
    fold_bn,
    launch_geometry_bf16,
    stage_bf16_tolerance,
)
from dgcnn_tpu_torch.kernels.knn_banded import SMEM_LIMIT
from dgcnn_tpu_torch.ops.edgeconv import lrelu
from dgcnn_tpu_torch.ops.knn import knn
from dgcnn_tpu_torch.ops.matmul import rounded
from torch_port_helpers import random_bn, sorted_blocks

LANES = 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _gt(lane):
    return lane // 4, lane % 4


# ------------------------------------------------------- the PTX fragments


def a_tile(regs):
    """The 16 x 16 A matrix from 32 lanes' 4 registers of 2 values each:
    ``regs`` (32, 4, 2)."""
    a = torch.full((16, 16), float("nan"), dtype=regs.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        for i in range(2):
            a[g, 2 * t + i] = regs[lane, 0, i]
            a[g + 8, 2 * t + i] = regs[lane, 1, i]
            a[g, 2 * t + 8 + i] = regs[lane, 2, i]
            a[g + 8, 2 * t + 8 + i] = regs[lane, 3, i]
    return a


def b_tile(regs):
    """The 16 x 8 B matrix (k x n) from 32 lanes' 2 registers: (32, 2, 2)."""
    b = torch.full((16, 8), float("nan"), dtype=regs.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        for i in range(2):
            b[2 * t + i, g] = regs[lane, 0, i]
            b[2 * t + 8 + i, g] = regs[lane, 1, i]
    return b


def d_lanes(d):
    """The 16 x 8 accumulator as 32 lanes' 4 values: (32, 4)."""
    out = torch.empty((LANES, 4), dtype=d.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        out[lane] = torch.stack([d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t],
                                 d[g + 8, 2 * t + 1]])
    return out


# ------------------------------------------------------- the kernel's lanes


def kernel_b_regs(rows, s):
    """What the kernel packs into lane (g, t)'s B fragment of k-step ``s``
    from an n-tile's 8 rows (8, 64): row g at channels 16s + 2t, +1
    (register 0) and 16s + 2t + 8, +9 (register 1), as ``load_share``
    loads them (float2 at float2 index t + 8s and t + 8s + 4)."""
    regs = torch.empty((LANES, 2, 2), dtype=rows.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        flat = rows[g].reshape(32, 2)  # the row as float2s
        regs[lane, 0] = flat[t + 8 * s]
        regs[lane, 1] = flat[t + 8 * s + 4]
    return regs


def kernel_a_regs(w2t, m, s):
    """What the kernel packs into lane (g, t)'s A fragment of m-tile ``m``,
    k-step ``s`` from W2^T (64 output channels x 64 input channels):
    output channels 16m + g (registers 0, 2) and 16m + g + 8 (1, 3) at input
    channels 16s + 2t + i (0, 1) and 16s + 2t + 8 + i (2, 3)."""
    regs = torch.empty((LANES, 4, 2), dtype=w2t.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        c0, c1, d = 16 * m + g, 16 * m + g + 8, 16 * s + 2 * t
        for i in range(2):
            regs[lane, 0, i] = w2t[c0, d + i]
            regs[lane, 1, i] = w2t[c1, d + i]
            regs[lane, 2, i] = w2t[c0, d + 8 + i]
            regs[lane, 3, i] = w2t[c1, d + 8 + i]
    return regs


def mma_model(d, a, b):
    """d + a @ b in float64, rounded to FP32: one k-step of exact bf16
    products (16 x 16, 16 x 8, 16 x 8)."""
    return (d.double() + a.double() @ b.double()).float()


def out_channels(lane):
    """The two channels lane (g, t) writes: 16t + g and 16t + g + 8."""
    g, t = _gt(lane)
    return 16 * t + g, 16 * t + g + 8


# ------------------------------------------------------------ the fragments


@pytest.mark.parametrize("s", range(4))
def test_b_fragments_are_the_rows_tile(s):
    """Lane (g, t)'s two 8-byte loads of row g per k-step give exactly the
    transposed rows of that k-step: B[k][n] = row n, channel 16s + k."""
    rows = torch.arange(8 * 64, dtype=torch.float64).reshape(8, 64)
    assert torch.equal(b_tile(kernel_b_regs(rows, s)), rows[:, 16 * s:16 * s + 16].T)


@pytest.mark.parametrize("m", range(4))
def test_a_fragments_are_w2_transposed(m):
    """The A fragments of m-tile m, k-step s are W2^T's 16 x 16 block:
    A[r][k] = W2[16s + k][16m + r]."""
    w2 = torch.arange(64 * 64, dtype=torch.float64).reshape(64, 64)
    for s in range(4):
        got = a_tile(kernel_a_regs(w2.T, m, s))
        assert torch.equal(got, w2[16 * s:16 * s + 16, 16 * m:16 * m + 16].T)


def test_every_row_element_is_loaded_once():
    """Over an n-tile's 4 k-steps the 32 lanes' 8 loads of 2 channels cover
    the 8 x 64 tile once; a warp's load of one (k-step, register) reads 8
    rows' 32-byte sectors whole (4 lanes, channels 16s + 8h .. + 7)."""
    seen = torch.zeros((8, 64), dtype=torch.int64)
    for lane in range(LANES):
        g, t = _gt(lane)
        for s in range(4):
            for h in range(2):
                for i in range(2):
                    seen[g, 16 * s + 2 * t + 8 * h + i] += 1
    assert (seen == 1).all()
    for s in range(4):
        for h in range(2):
            by_row = {}
            for lane in range(LANES):
                g, t = _gt(lane)
                first = 16 * s + 8 * h + 2 * t
                by_row.setdefault(g, set()).update({first, first + 1})
            assert all(sorted(ch) == list(range(16 * s + 8 * h, 16 * s + 8 * h + 8))
                       for ch in by_row.values())


def test_accumulator_lanes_and_outputs():
    """D[c][r] of m-tile m sits in lane (g, t) as d[m][0..1] = channel
    16m + g, rows 2t, 2t + 1 and d[m][2..3] = channel 16m + g + 8; the
    lanes' output channels cover the 64 channels once, each among the
    lane's own 8 channels (16m + g + 8h, m = t)."""
    d = torch.arange(16 * 8, dtype=torch.float64).reshape(16, 8)  # value 8c + r
    lanes = d_lanes(d)
    for lane in range(LANES):
        g, t = _gt(lane)
        assert lanes[lane].tolist() == [8 * g + 2 * t, 8 * g + 2 * t + 1,
                                        8 * (g + 8) + 2 * t, 8 * (g + 8) + 2 * t + 1]
    written = sorted(c for lane in range(LANES) for c in out_channels(lane))
    assert written == list(range(64))
    for lane in range(LANES):
        g, t = _gt(lane)
        own = {16 * m + g + 8 * h for m in range(4) for h in range(2)}
        assert set(out_channels(lane)) <= own


# ------------------------------------------------------ the stage, lane by lane


def _unit_rows(idx_q, c, k, n):
    """Unit c's 32 row indices of one query: row 32c + l, past k the last
    neighbour's (``unit_index``), clamped to [0, n)."""
    j = torch.clamp(torch.arange(UNIT_ROWS) + UNIT_ROWS * c, max=k - 1)
    return idx_q[j].clamp(0, n - 1)


def model_stage(table, idx, bvec, w2, sa, ta, sb, tb):
    """The bf16 stage as the kernel computes it, lane by lane: the units' 4
    n-tiles, the B fragments activated and rounded from the lanes' own
    loads, W2^T's A fragments (negated where BN_b is flipped), four k-steps
    of the mma model from zero, the lanes' running max (before BN_b where
    all 64 channels are regular, else after it on every row), the
    reduction over t and the lanes' writes. (B, N, 64)."""
    b_, n, _ = table.shape
    k = idx.shape[-1]
    regular = torch.isfinite(sb) & (sb != 0) & torch.isfinite(tb)
    flipped = regular & (sb < 0)
    w2t = rounded(torch.where(flipped[None, :], -w2, w2), torch.bfloat16).T
    a = [[a_tile(kernel_a_regs(w2t, m, s)) for s in range(4)] for m in range(4)]
    fast = [bool(regular.all())] * LANES  # the warp's choice: every channel regular
    sc = torch.where(flipped, -sb, sb)
    out = torch.empty((b_, n, 64), dtype=torch.float32)
    nch = -(-k // UNIT_ROWS)
    for bi in range(b_):
        for q in range(n):
            mx = torch.full((LANES, 4, 2), float("-inf"))
            for c in range(nch):
                rows_idx = _unit_rows(idx[bi, q], c, k, n)
                for j in range(4):
                    raw = table[bi, rows_idx[8 * j:8 * j + 8]]
                    e = raw + bvec[bi, q]
                    e = lrelu((e.double() * sa.double() + ta.double()).float())
                    e = rounded(e, torch.bfloat16)
                    bs = [b_tile(kernel_b_regs(e, s)) for s in range(4)]
                    for m in range(4):
                        d = torch.zeros((16, 8))
                        for s in range(4):
                            d = mma_model(d, a[m][s], bs[s])
                        dl = d_lanes(d)
                        for lane in range(LANES):
                            g, _ = _gt(lane)
                            for h in range(2):
                                v = dl[lane, 2 * h:2 * h + 2]
                                if not fast[lane]:
                                    ch = 16 * m + g + 8 * h
                                    v = lrelu(v * sc[ch] + tb[ch])
                                v = v.nan_to_num(nan=float("-inf"), posinf=float("inf"),
                                                 neginf=float("-inf"))
                                mx[lane, m, h] = torch.fmax(mx[lane, m, h], v.max())
            for lane in range(LANES):  # two shuffles over t: lanes 4g .. 4g + 3
                g, t = _gt(lane)
                red = mx[4 * g:4 * g + 4].amax(0)
                for h, ch in enumerate(out_channels(lane)):
                    v = red[t, h]
                    out[bi, q, ch] = lrelu(v * sc[ch] + tb[ch]) if fast[lane] else v
    return out


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(15)
    b, n = 1, 44
    table, bvec = rng.standard_normal((2, b, n, 64)).astype(np.float32)
    w2 = rng.uniform(-0.125, 0.125, (64, 64)).astype(np.float32)
    bns = [random_bn(rng, 64) for _ in range(2)]
    return rng, table, bvec, w2, bns


# (k, indices, BN_b): k below one n-tile, within a unit, a unit exactly,
# one n-tile past it, two units; kNN of x-sorted blocks or uniform indices
# with some outside [0, n) (clamped); BN_b of both signs, or with three
# zero scales (their lanes take the per-row path)
MODEL_CASES = [(1, "knn", "signs"), (20, "knn", "signs"), (30, "uniform", "signs"),
               (32, "knn", "special"), (33, "uniform", "signs"), (40, "knn", "special")]


@pytest.mark.parametrize("k, kind, scales", MODEL_CASES)
def test_layout_model_matches_plain_and_jax(operands, k, kind, scales):
    rng, table, bvec, w2, bns = operands
    b, n = table.shape[:2]
    if kind == "knn":
        idx = knn(torch.from_numpy(sorted_blocks(b, n, seed=k)), k).numpy()
    else:
        idx = rng.integers(-2, n + 2, (b, n, k))
    idx = idx.astype(np.int32)
    bn_b = dict(bns[1])
    if scales == "special":
        bn_b["gamma"] = bn_b["gamma"].copy()
        bn_b["gamma"][[1, 18, 37]] = 0.0
    (sa, ta), (sb, tb) = (fold_bn(*(torch.from_numpy(v[key]) for key in
                                    ("gamma", "beta", "mean", "var"))) for v in (bns[0], bn_b))
    args = [torch.from_numpy(x) for x in (table, idx, bvec, w2)] + [sa, ta, sb, tb]
    got = model_stage(*args)
    want = edgeconv_fused_stage_plain(*args, bf16_mm=True)
    ok = torch.isfinite(want)
    assert ok.all() and torch.isfinite(got).all()
    tol = stage_bf16_tolerance(*args[:7])
    assert ((got - want).abs() <= tol).all()
    torch.testing.assert_close(got, want, **TOL)
    if k <= 33:  # the interpreted Pallas kernel (on the clamped indices), at the smaller k
        jargs = [*args[:1], args[1].clamp(0, n - 1), *args[2:]]
        jax_out = np.asarray(jax_stage(*(jnp.asarray(x.numpy()) for x in jargs), bf16_mm=True,
                                       interpret=True))
        np.testing.assert_allclose(got.numpy(), jax_out, **TOL)


# ------------------------------------------------------------ the walk


def walk(b, n, k, warps, per):
    """The kernel's units as (query, unit) per (block, warp): block i takes
    queries [i * per, min(b * n, (i + 1) * per)), its warp w the queries
    i * per + w, + warps, ...; each query's units c = 0 .. ceil(k / 32) - 1
    of 32 rows (4 n-tiles of 8)."""
    rows, nch = b * n, -(-k // UNIT_ROWS)
    units = []
    for block in range(-(-rows // per)):
        lo, hi = block * per, min(rows, block * per + per)
        for w in range(warps):
            for q in range(lo + w, hi, warps):
                for c in range(nch):
                    units.append((q, c))
    return units


# (b, n, k, sms): the production shape; b*n not a multiple of the range;
# n smaller than a block's range (blocks span clouds); fewer queries than
# SMs; k at 1, 32, 33 and 64
WALK_CASES = [(8, 7000, 30, 132), (3, 1001, 20, 132), (8, 50, 33, 132), (1, 100, 64, 132),
              (2, 77, 1, 132), (5, 613, 32, 7)]


@pytest.mark.parametrize("b, n, k, sms", WALK_CASES)
def test_walk_takes_every_query_and_neighbour_once(b, n, k, sms):
    warps, per = launch_geometry_bf16(b, n, k, sms)
    assert warps == BF16_WARPS and per >= 1
    assert -(-(b * n) // per) <= sms  # one block an SM at most
    units = walk(b, n, k, warps, per)
    queries = sorted({q for q, _ in units})
    assert queries == list(range(b * n))
    per_query = {}
    for q, c in units:
        per_query.setdefault(q, []).append(c)
    nch = -(-k // UNIT_ROWS)
    for q, us in per_query.items():
        assert us == list(range(nch))
        positions = [min(32 * c + 8 * j + r, k - 1) for c in us for j in range(4)
                     for r in range(8)]
        assert sorted(set(positions)) == list(range(k))  # padding repeats position k - 1
        assert len(positions) - k < UNIT_ROWS


@pytest.mark.parametrize("b, n", [(8, 7000), (1, 1001), (3, 50), (1, 1)])
def test_geometry_is_one_range_a_sm(b, n):
    """``per`` is the smallest range that needs at most ``sms`` blocks, so
    every block but the last takes ``per`` queries."""
    warps, per = launch_geometry_bf16(b, n, 30)
    blocks = -(-(b * n) // per)
    assert blocks <= H100_SMS and (per == 1 or -(-(b * n) // (per - 1)) > H100_SMS)
    assert (warps, per) == (BF16_WARPS, -(-(b * n) // H100_SMS))


def test_geometry_at_the_production_shape():
    """B=8, N=7000, k=30: 8 warps, 425 queries a block, 132 blocks (the
    last 325), no shared memory."""
    assert launch_geometry_bf16(8, 7000, 30) == (8, 425)
    assert -(-56000 // 425) == 132 and 56000 - 131 * 425 == 325


@pytest.mark.parametrize("k", [1, 32, 33, 64, 1000])
def test_geometry_does_not_grow_with_k(k):
    assert launch_geometry_bf16(2, 1001, k) == launch_geometry_bf16(2, 1001, 1)


@pytest.mark.parametrize("args", [(1, 100, 0), (1, 100, -1), (0, 100, 30), (1, 100, 30, 0)])
def test_geometry_refuses(args):
    with pytest.raises(ValueError):
        launch_geometry_bf16(*args)


def test_geometry_within_the_shared_memory_budget():
    """The kernel declares no shared memory (W2's fragments in registers,
    the rows loaded straight into the mma fragments), so the budget of a
    Hopper block never bounds its geometry."""
    src = (_build.CSRC / "edgeconv_fused.cu").read_text()
    kernel = src[src.index("edgeconv_stage_bf16_kernel(const float*"):
                 src.index("// The extrema kernel")]
    launcher = src[src.index('extern "C" int dgcnn_edgeconv_stage_bf16'):]
    assert "__shared__" not in kernel and "smem" not in launcher.split("}")[0]
    assert BF16_SMEM_BYTES == 0 < SMEM_LIMIT


def test_constants_match_the_source():
    """The wrapper's warps and the kernel's bound, the launcher's checks,
    its L1 carveout and the fragments' loads, as the source has them."""
    src = (_build.CSRC / "edgeconv_fused.cu").read_text()
    launcher = src[src.index('extern "C" int dgcnn_edgeconv_stage_bf16'):]
    assert "cudaFuncAttributePreferredSharedMemoryCarveout, 0);" in launcher.split("}")[0]
    for line in (f"constexpr int kBfWarps = {BF16_WARPS};",
                 "__global__ void __launch_bounds__(kLanes * kBfWarps, 1)\n"
                 "edgeconv_stage_bf16_kernel(",
                 "if (K < 1 || warps < 1 || warps > kBfWarps || per < 1) return "
                 "cudaErrorInvalidValue;",
                 "p[s][0] = kStream ? __ldcs(r2 + 8 * s) : __ldg(r2 + 8 * s);",
                 "p[s][1] = kStream ? __ldcs(r2 + 8 * s + 4) : __ldg(r2 + 8 * s + 4);",
                 "const int lo = blockIdx.x * per, hi = min(rows, lo + per);",
                 "for (int s = 0; s < 4; ++s) mma_bf16(d[m], L.a[m][s], b[s][0], b[s][1]);",
                 "float* o = out + (size_t)q * kC + 16 * t + g;"):
        assert line in src, line
    bf16 = src[src.index("edgeconv_stage_bf16_kernel(const float*"):
               src.index("// The extrema kernel")]
    assert "__shared__" not in bf16 and "ldmatrix" not in bf16 and "cp_async" not in bf16
