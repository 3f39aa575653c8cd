"""The TF32 stage kernel's layout, loop order and walk, modelled on the CPU.

The kernel (``csrc/edgeconv_fused.cu::edgeconv_stage_tf32_kernel``) runs
only on a card. What decides its result besides the arithmetic is where
each value goes: which lane loads which (row, channel) pairs of a gathered
row, which input channel each k row of ``mma.sync.m16n8k8`` carries (a
permutation of the 64 channels, the same for both operands), how W2^T's
A fragments are laid out in shared memory, which lane holds which
(output channel, row) of the accumulator, in which order a unit's
products are issued, and which warp takes which (query, unit). This file
writes that down in PyTorch, lane by lane, and holds it against the dense
tiles, against the plain version (``edgeconv_fused_stage_tf32_plain``) and
against the JAX package's interpreted ``_stage_kernel`` (its dot at the
"default" precision, which XLA's CPU computes in FP32: on integer operands
every TF32 value and every sum is exact, so there the two agree bit for
bit).

Fragments follow the PTX ISA's layouts of m16n8k8 with tf32 operands:
lane (g, t) = (lane // 4, lane % 4) holds A[g][t] (register 0),
A[g + 8][t] (1), A[g][t + 4] (2), A[g + 8][t + 4] (3); B[t][g] (0) and
B[t + 4][g] (1); C/D[g][2t + i] (0, 1) and D[g + 8][2t + i] (2, 3).

The mma model adds each k-step's 8 exact TF32 products to the accumulator
in float64 and rounds to FP32, k-steps 0..7 in order: the tensor cores'
own rounding of that sum is not modelled, so on floats the model is held
at the stated 1e-5 (and within ``stage_tf32_tolerance``), not bit for bit;
bit equality across the kernel's designs is the card's to show
(``tests/test_torch_cuda.py``, ``scripts/torch_edgeconv_bf16.py --mode
tf32``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.edgeconv_pallas import edgeconv_fused_stage as jax_stage
from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.edgeconv_fused import (
    TF32_WARPS,
    UNIT_ROWS,
    edgeconv_fused_stage_plain,
    edgeconv_fused_stage_tf32,
    edgeconv_fused_stage_tf32_plain,
    fold_bn,
    launch_geometry_bf16,
    stage_tf32_tolerance,
)
from dgcnn_tpu_torch.ops.edgeconv import lrelu
from dgcnn_tpu_torch.ops.knn import knn
from dgcnn_tpu_torch.ops.matmul import round_tf32
from torch_port_helpers import random_bn, sorted_blocks

LANES = 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _gt(lane):
    return lane // 4, lane % 4


# ------------------------------------------------------- the PTX fragments


def a_tile(regs):
    """The 16 x 8 A matrix from 32 lanes' 4 registers: ``regs`` (32, 4)."""
    a = torch.full((16, 8), float("nan"), dtype=regs.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = regs[lane]
    return a


def b_tile(regs):
    """The 8 x 8 B matrix (k x n) from 32 lanes' 2 registers: (32, 2)."""
    b = torch.full((8, 8), float("nan"), dtype=regs.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        b[t, g], b[t + 4, g] = regs[lane]
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


def channel(s, kk):
    """The input channel of k row ``kk`` at k-step ``s = 2i + v``: lane
    (g, t) holds k rows t and t + 4, channels 16i + 4t + 2v and + 1."""
    i, v = divmod(s, 2)
    return 16 * i + 4 * (kk % 4) + 2 * v + kk // 4


def kernel_b_regs(rows, s):
    """What lane (g, t) puts into its B fragment of k-step ``s = 2i + v``
    from an n-tile's 8 rows (8, 64): its 16-byte load ``i`` of row g
    (``load_share4``: float4 index t + 4i, channels 16i + 4t .. + 3),
    components 2v and 2v + 1 (x, y at v = 0; z, w at v = 1)."""
    regs = torch.empty((LANES, 2), dtype=rows.dtype)
    i, v = divmod(s, 2)
    for lane in range(LANES):
        g, t = _gt(lane)
        four = rows[g].reshape(16, 4)[t + 4 * i]
        regs[lane] = four[2 * v:2 * v + 2]
    return regs


def kernel_a_regs(w2t, m, s):
    """What the block writes to ``w2f[(8m + s) * 32 + lane]`` for lane (g, t)
    from W2^T (64 output x 64 input channels): ``make_float4(w(d, c0),
    w(d, c1), w(d + 1, c0), w(d + 1, c1))`` with d = 16(s >> 1) + 4t +
    2(s & 1), c0 = 16m + g, c1 = c0 + 8."""
    regs = torch.empty((LANES, 4), dtype=w2t.dtype)
    for lane in range(LANES):
        g, t = _gt(lane)
        d = 16 * (s >> 1) + 4 * t + 2 * (s & 1)
        c0, c1 = 16 * m + g, 16 * m + g + 8
        regs[lane] = torch.stack([w2t[c0, d], w2t[c1, d], w2t[c0, d + 1], w2t[c1, d + 1]])
    return regs


def out_channels(lane):
    """The two channels lane (g, t) writes: 16t + g and 16t + g + 8."""
    g, t = _gt(lane)
    return 16 * t + g, 16 * t + g + 8


def tf32_bits(u: int) -> int:
    """``csrc/edgeconv_fused.cu::tf32_bits`` on a float's 32 bits: a NaN
    becomes the canonical NaN, anything else is rounded to nearest even on
    its 13 low mantissa bits."""
    if u & 0x7FFFFFFF > 0x7F800000:
        return 0x7FFFFFFF
    return (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000


def walk_prologue():
    """What a lane reads before its first unit: m-tile 0's 8 A fragments,
    held in registers for the whole walk."""
    for s in range(8):
        yield ("lds", 0, s, None)


def unit_schedule():
    """The kernel's order of a unit's work, as (op, m, s, j): n-tile by
    n-tile, its rows activated ("act"), then m-tile by m-tile, k-step by
    k-step, the products ("mma"; m-tiles 1-3's fragments named from shared
    memory, "lds", m-tile 0's from registers), each m-tile's two rows a
    lane folded into the running max ("max"); the next unit's rows loaded
    once every product is issued ("load")."""
    for j in range(4):
        yield ("act", None, None, j)
        for m in range(4):
            for s in range(8):
                if m > 0:
                    yield ("lds", m, s, None)
                yield ("mma", m, s, j)
            yield ("max", m, None, j)
    for j in range(4):
        yield ("load", None, None, j)


def first_design_schedule():
    """The first design's order: n-tile by n-tile, activated, the next
    unit's rows of that n-tile loaded, then m-tile by m-tile, k-step by
    k-step, every fragment named from shared memory, then the folds."""
    for j in range(4):
        yield ("act", None, None, j)
        yield ("load", None, None, j)
        for m in range(4):
            for s in range(8):
                yield ("lds", m, s, None)
                yield ("mma", m, s, j)
        for m in range(4):
            yield ("max", m, None, j)


# ------------------------------------------------------------ the fragments


@pytest.mark.parametrize("s", range(8))
def test_b_fragments_are_the_rows_tile(s):
    """Lane (g, t)'s two registers of k-step s are row g's channels at k
    rows t and t + 4: B[kk][n] = row n, channel ``channel(s, kk)``."""
    rows = torch.arange(8 * 64, dtype=torch.float64).reshape(8, 64)
    cols = [channel(s, kk) for kk in range(8)]
    assert torch.equal(b_tile(kernel_b_regs(rows, s)), rows[:, cols].T)


@pytest.mark.parametrize("m", range(4))
def test_a_fragments_are_w2_transposed(m):
    """The A fragments of m-tile m, k-step s are W2^T's 16 x 8 block at the
    same channel permutation: A[r][kk] = W2[channel(s, kk)][16m + r]."""
    w2 = torch.arange(64 * 64, dtype=torch.float64).reshape(64, 64)
    for s in range(8):
        cols = [channel(s, kk) for kk in range(8)]
        assert torch.equal(a_tile(kernel_a_regs(w2.T, m, s)), w2[cols, 16 * m:16 * m + 16].T)


def test_k_permutation_and_row_loads():
    """The k rows of the 8 k-steps carry each input channel once, so the
    64-term sum is over the same products; a lane's four 16-byte loads
    of row g cover its channels 16i + 4t .. + 3, each once over the
    fragments; a warp's load i reads each of 8 rows' 64 bytes 16i .. 16i +
    15 whole (4 lanes), two 32-byte sectors a row."""
    assert sorted(channel(s, kk) for s in range(8) for kk in range(8)) == list(range(64))
    rows = torch.arange(8 * 64, dtype=torch.float64).reshape(8, 64)
    seen = torch.zeros((8, 64), dtype=torch.int64)
    for s in range(8):
        for lane, regs in enumerate(kernel_b_regs(rows, s)):
            g, t = _gt(lane)
            for reg, v in enumerate(regs.tolist()):  # k rows t and t + 4
                r, c = divmod(int(v), 64)
                assert (r, c) == (g, channel(s, t + 4 * reg))
                seen[r, c] += 1
    assert (seen == 1).all()
    for i in range(4):
        by_row = {}
        for lane in range(LANES):
            g, t = _gt(lane)
            by_row.setdefault(g, set()).update(range(16 * i + 4 * t, 16 * i + 4 * t + 4))
        assert all(sorted(ch) == list(range(16 * i, 16 * i + 16)) for ch in by_row.values())


def test_bn_a_reads_match_the_row_loads():
    """BN_a's scale and shift sit in shared memory as 16 float4 each; lane
    (g, t) reads float4 4i + t of each for its load i of a row: the same
    four channels 16i + 4t .. + 3 that load holds."""
    sa = torch.arange(64, dtype=torch.float64)
    for lane in range(LANES):
        g, t = _gt(lane)
        for i in range(4):
            row = torch.arange(64, dtype=torch.float64)[None].expand(8, 64)
            loaded = kernel_b_regs(row, 2 * i)[lane].tolist() + kernel_b_regs(row, 2 * i + 1)[
                lane].tolist()
            assert sa.reshape(16, 4)[4 * i + t].tolist() == loaded


def test_accumulator_lanes_and_outputs():
    """D[c][r] of m-tile m sits in lane (g, t) as d[0..1] = channel 16m + g,
    rows 2t, 2t + 1 and d[2..3] = channel 16m + g + 8; the lanes' output
    channels cover the 64 channels once, each among the lane's own 8
    (16m + g + 8h, m = t)."""
    d = torch.arange(16 * 8, dtype=torch.float64).reshape(16, 8)  # value 8c + r
    lanes = d_lanes(d)
    for lane in range(LANES):
        g, t = _gt(lane)
        assert lanes[lane].tolist() == [8 * g + 2 * t, 8 * g + 2 * t + 1,
                                        8 * (g + 8) + 2 * t, 8 * (g + 8) + 2 * t + 1]
    assert sorted(c for lane in range(LANES) for c in out_channels(lane)) == list(range(64))
    for lane in range(LANES):
        g, t = _gt(lane)
        assert set(out_channels(lane)) <= {16 * m + g + 8 * h for m in range(4) for h in range(2)}


def test_loop_order_keeps_every_chain():
    """The unit issues the first design's 128 products, and each accumulator
    (m, j) still takes k-steps 0..7 in order from zero, each running max
    (m) its n-tiles 0..3 in order: so the outputs are the first design's
    bit for bit. m-tile 0's 8 fragments are read once for the walk; the
    source names m-tiles 1-3's for each n-tile, and the compiled kernel
    reads each once a unit (``cuobjdump -sass``: 40 LDS in each of its two
    instances, 8 of them BN_a's; the first design 32, its m-tile 0's
    too). An n-tile's rows are activated before its products, and the next
    unit's rows, which land in the same registers, are loaded after the
    unit's last product."""
    new, old = list(unit_schedule()), list(first_design_schedule())

    def chains(sched):
        acc, fold = {}, {}
        for op, m, s, j in sched:
            if op == "mma":
                acc.setdefault((m, j), []).append(s)
            elif op == "max":
                fold.setdefault(m, []).append(j)
        return acc, fold

    assert chains(new) == chains(old)
    acc, fold = chains(new)
    assert all(steps == list(range(8)) for steps in acc.values()) and len(acc) == 16
    assert all(js == list(range(4)) for js in fold.values())
    assert sorted({(m, s) for op, m, s, _ in new if op == "lds"}) == [
        (m, s) for m in range(1, 4) for s in range(8)]
    assert sorted((m, s) for _, m, s, _ in walk_prologue()) == [(0, s) for s in range(8)]
    for sched in (new, old):  # each product after its fragment and its n-tile's activation
        seen = {("lds", 0, s) for s in range(8)} if sched is new else set()
        for op, m, s, j in sched:
            if op in ("lds", "act"):
                seen.add((op, m, s) if op == "lds" else (op, j))
            elif op == "mma":
                assert ("lds", m, s) in seen and ("act", j) in seen
            elif op == "load":  # the rows of n-tile j are reloaded after their activation
                assert ("act", j) in seen
    last_mma = max(i for i, (op, *_) in enumerate(new) if op == "mma")
    assert all(i > last_mma for i, (op, *_) in enumerate(new) if op == "load")


def test_tf32_bits_is_round_tf32_and_canonical_nan():
    """The kernel's rounding of an operand equals ``round_tf32`` on every
    non-NaN value (ties to even, the carry into the exponent, past the
    largest finite value to inf, subnormals), and makes a NaN whose payload
    lies only in the 13 dropped bits a NaN the tensor cores see (its top 19
    bits), where truncating it would give inf."""
    vals = np.array([0.0, -0.0, 1.0, -1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                     1.0 + 2 ** -11 + 2 ** -20, 3.4028235e38, -3.4028235e38, 1e-40, -1e-45,
                     np.inf, -np.inf, 0.1, -2.7182817], np.float32)
    vals = np.concatenate([vals, np.random.default_rng(3).standard_normal(200).astype(np.float32)])
    u = vals.view(np.uint32)
    got = np.array([tf32_bits(int(x)) for x in u], np.uint32).view(np.float32)
    want = round_tf32(torch.from_numpy(vals)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    def top19(u):
        return np.uint32(u & 0xFFFFE000).view(np.float32)

    for nan in (0x7F800001, 0xFF800FFF):  # payload in the dropped bits alone
        assert np.isinf(top19(nan)) and np.isnan(top19(tf32_bits(nan)))
    assert np.isnan(top19(tf32_bits(0x7FC00000)))


# ------------------------------------------------------ the stage, lane by lane


def _unit_rows(idx, k, n):
    """Every unit's 32 row indices of every query: row 32c + l, past k the
    last neighbour's (``unit_index``), clamped to [0, n). (B, N, units * 32)."""
    nch = -(-k // UNIT_ROWS)
    j = torch.clamp(torch.arange(nch * UNIT_ROWS), max=k - 1)
    return idx.long()[..., j].clamp(0, n - 1)


@functools.lru_cache(maxsize=None)
def _b_sources(s):
    """(k row, n) -> the (row, channel) of an n-tile that lane by lane lands
    there at k-step s: the rows tile read back through the lanes' loads."""
    code = torch.arange(8 * 64, dtype=torch.float64).reshape(8, 64)
    src = b_tile(kernel_b_regs(code, s)).long()
    return src // 64, src % 64


@functools.lru_cache(maxsize=None)
def _d_sources():
    """lane, register -> (channel within the m-tile, row within the n-tile)."""
    lanes = d_lanes(torch.arange(16 * 8, dtype=torch.float64).reshape(16, 8)).long()
    return lanes // 8, lanes % 8


def model_stage(table, idx, bvec, w2, sa, ta, sb, tb):
    """The TF32 stage as the kernel computes it, every query at once, lane
    by lane: each unit's rows activated (FP32, BN_a as two roundings) and
    rounded to TF32 (the card's ``cvt.rn.tf32.f32``: ``round_tf32``'s top
    19 bits, all the tensor cores read); the B fragments from the lanes' loads, W2^T's
    A fragments from shared memory (negated where BN_b is flipped); the
    unit's products in ``unit_schedule``'s order, eight k-steps of the mma
    model from zero; the lanes' running max over their two rows of each
    n-tile (before BN_b where all 64 channels are regular, else after it
    on every row), the reduction over t and the lanes' writes. (B, N, 64)."""
    b_, n, _ = table.shape
    k = idx.shape[-1]
    regular = torch.isfinite(sb) & (sb != 0) & torch.isfinite(tb)
    flipped = regular & (sb < 0)
    w2n = torch.where(flipped[None, :], -w2, w2)
    bits = w2n.contiguous().view(torch.int32).numpy().astype(np.uint32)
    w2r = torch.from_numpy(np.vectorize(tf32_bits, otypes=[np.uint32])(bits).view(np.float32))
    a = {(m, s): a_tile(kernel_a_regs(w2r.T, m, s)) for m in range(4) for s in range(8)}
    fast = bool(regular.all())  # the warp's choice: every channel regular
    sc = torch.where(flipped, -sb, sb)
    rows = _unit_rows(idx, k, n)
    e = torch.stack([table[i][rows[i]] for i in range(b_)]) + bvec[:, :, None, :]
    e = round_tf32(lrelu(e * sa + ta))
    units = e.reshape(b_, n, -1, 4, 8, 64)  # (.., unit, n-tile, row, channel)
    dc, dr = _d_sources()
    mx = torch.full((b_, n, LANES, 4, 2), float("-inf"))
    out = torch.empty((b_, n, 64), dtype=torch.float32)
    for c in range(units.shape[2]):
        bs = {}
        for j in range(4):
            for s in range(8):
                r, ch = _b_sources(s)
                bs[j, s] = units[:, :, c, j][:, :, r, ch]  # (B, N, 8, 8): B[kk][n]
        d = {}
        for op, m, s, j in unit_schedule():
            if op == "mma":
                acc = d.get((m, j), torch.zeros((b_, n, 16, 8)))
                d[m, j] = (acc.double() + a[m, s].double() @ bs[j, s].double()).float()
            elif op == "max":
                v = d[m, j][:, :, dc, dr]  # (B, N, lane, 4)
                for h in range(2):
                    vh = v[..., 2 * h:2 * h + 2]
                    if not fast:
                        chs = torch.tensor([16 * m + _gt(lane)[0] + 8 * h for lane in range(32)])
                        vh = lrelu(vh * sc[chs][:, None] + tb[chs][:, None])
                    vh = vh.nan_to_num(nan=float("-inf"), posinf=float("inf"),
                                       neginf=float("-inf"))
                    mx[..., m, h] = torch.fmax(mx[..., m, h], vh.amax(-1))
        if c == units.shape[2] - 1:  # the query's last unit
            for lane in range(LANES):  # two shuffles over t: lanes 4g .. 4g + 3
                g, t = _gt(lane)
                red = mx[:, :, 4 * g:4 * g + 4].amax(2)
                for h, ch in enumerate(out_channels(lane)):
                    v = red[..., t, h]
                    out[..., ch] = lrelu(v * sc[ch] + tb[ch]) if fast else v
    return out


def _jax_stage(args, n):
    """JAX's interpreted stage at the "default" precision, on the clamped indices."""
    jargs = [*args[:1], args[1].clamp(0, n - 1), *args[2:]]
    with jax.default_matmul_precision("default"):
        return np.asarray(jax_stage(*(jnp.asarray(x.numpy()) for x in jargs), interpret=True))


def _folded(bns, special=False):
    bn_b = dict(bns[1])
    if special:  # three zero scales: their lanes take the per-row path
        bn_b["gamma"] = bn_b["gamma"].copy()
        bn_b["gamma"][[1, 18, 37]] = 0.0
    return [t for v in (bns[0], bn_b)
            for t in fold_bn(*(torch.from_numpy(v[key]) for key in
                               ("gamma", "beta", "mean", "var")))]


def _indices(rng, b, n, k, kind):
    """kNN of x-sorted blocks, or uniform indices with some outside [0, n)."""
    if kind == "knn":
        return knn(torch.from_numpy(sorted_blocks(b, n, seed=k)), k).numpy().astype(np.int32)
    return rng.integers(-2, n + 2, (b, n, k)).astype(np.int32)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(16)
    b, n = 2, 44
    table, bvec = rng.standard_normal((2, b, n, 64)).astype(np.float32)
    w2 = rng.uniform(-0.125, 0.125, (64, 64)).astype(np.float32)
    bns = [random_bn(rng, 64) for _ in range(2)]
    return rng, table, bvec, w2, bns


# (k, indices, BN_b): k below one n-tile, within a unit, a unit exactly,
# one row past it, two units; kNN of x-sorted blocks or uniform indices
# with some outside [0, n) (clamped); BN_b of both signs (flipped columns),
# or with three zero scales (the per-row path)
MODEL_CASES = [(1, "knn", "signs"), (20, "knn", "signs"), (32, "knn", "special"),
               (33, "uniform", "signs"), (40, "knn", "special")]


@pytest.mark.parametrize("k, kind, scales", MODEL_CASES)
def test_layout_model_matches_plain(operands, k, kind, scales):
    """On floats the model agrees with the plain TF32 stage within 1e-5 and
    within ``stage_tf32_tolerance`` (the two sum orders), and the wrapper on
    CPU tensors is the plain version."""
    rng, table, bvec, w2, bns = operands
    b, n = table.shape[:2]
    args = [torch.from_numpy(x) for x in (table, _indices(rng, b, n, k, kind), bvec, w2)]
    args += _folded(bns, scales == "special")
    got = model_stage(*args)
    want = edgeconv_fused_stage_tf32_plain(*args)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    assert ((got - want).abs() <= stage_tf32_tolerance(*args)).all()
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(edgeconv_fused_stage_tf32(*args), want)


@pytest.mark.parametrize("k, kind, special", [(33, "uniform", False), (40, "knn", True)])
def test_layout_model_is_exact_on_integers(operands, k, kind, special):
    """Integer rows, W2 and BN_a (e = 5m, so lrelu(-5m) = -m), BN_b scales
    in +-{1/2, 1, 2} (three zero ones: the per-row path) and integer
    shifts: every TF32 operand, every partial sum and BN_b are exact, so
    the model equals the plain TF32 stage, the FP32 stage and JAX's
    interpreted kernel (whose CPU dot is FP32 at "default") bit for bit."""
    rng = operands[0]
    b, n = 2, 44
    sb = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], 64)
    if special:
        sb[[1, 18, 37]] = 0.0
    args = [torch.from_numpy(x.astype(np.float32)) for x in (
        rng.integers(-3, 4, (b, n, 64)), _indices(rng, b, n, k, kind),
        rng.integers(-3, 4, (b, n, 64)), rng.integers(-3, 4, (64, 64)),
        rng.choice([-5.0, 5.0], 64), 5.0 * rng.integers(-2, 3, 64), sb,
        rng.integers(-4, 5, 64))]
    args[1] = args[1].to(torch.int32)
    got = model_stage(*args)
    assert torch.equal(got, edgeconv_fused_stage_tf32_plain(*args))
    assert torch.equal(got, edgeconv_fused_stage_plain(*args))
    jax_out = _jax_stage(args, n)
    assert np.array_equal(got.numpy(), jax_out)


# ------------------------------------------------------------ the walk


def walk(b, n, k, warps, per):
    """The kernel's units as (query, unit): block i takes queries
    [i * per, min(b * n, (i + 1) * per)), its warp w the queries i * per +
    w, + warps, ...; each query's units c = 0 .. ceil(k / 32) - 1 of 32
    rows (4 n-tiles of 8)."""
    rows, nch = b * n, -(-k // UNIT_ROWS)
    return [(q, c) for block in range(-(-rows // per))
            for w in range(warps)
            for q in range(block * per + w, min(rows, block * per + per), warps)
            for c in range(nch)]


# (b, n, k, sms): the production shape; b*n not a multiple of the range;
# blocks spanning clouds; k at 1, 32, 33 and 64; a card of 7 SMs
WALK_CASES = [(8, 7000, 30, 132), (3, 1001, 20, 132), (8, 50, 33, 132), (1, 100, 64, 132),
              (2, 77, 1, 132), (5, 613, 32, 7)]


@pytest.mark.parametrize("b, n, k, sms", WALK_CASES)
def test_walk_takes_every_query_and_neighbour_once(b, n, k, sms):
    """The wrapper launches the TF32 kernel at ``launch_geometry_bf16``'s
    range with :data:`TF32_WARPS` warps: every query once, its units in
    order, every neighbour position among its 4 n-tiles a unit."""
    _, per = launch_geometry_bf16(b, n, k, sms)
    assert -(-(b * n) // per) <= sms  # one block an SM at most
    units = walk(b, n, k, TF32_WARPS, per)
    per_query = {}
    for q, c in units:
        per_query.setdefault(q, []).append(c)
    assert sorted(per_query) == list(range(b * n))
    nch = -(-k // UNIT_ROWS)
    for us in per_query.values():
        assert us == list(range(nch))
        positions = [min(32 * c + 8 * j + r, k - 1) for c in us for j in range(4)
                     for r in range(8)]
        assert sorted(set(positions)) == list(range(k))  # padding repeats position k - 1


def test_constants_match_the_source():
    """The wrapper's warps, the kernel's bound, the launcher's checks, the
    fragments' layout in shared memory, the lanes' loads and the unit's
    loop order, as the source has them."""
    src = (_build.CSRC / "edgeconv_fused.cu").read_text()
    walk_src = src[src.index("__device__ __forceinline__ void tf32_walk("):
                   src.index("edgeconv_stage_tf32_kernel(const float*")]
    for line in (f"constexpr int kTfWarps = {TF32_WARPS};",
                 "__global__ void __launch_bounds__(kLanes * kTfWarps, 1)\n"
                 "edgeconv_stage_tf32_kernel(",
                 "if (K < 1 || warps < 1 || warps > kTfWarps || per < 1) return "
                 "cudaErrorInvalidValue;",
                 "__shared__ float4 w2f[4 * 8 * kLanes];",
                 "const int d = 16 * (s >> 1) + 4 * t + 2 * (s & 1);",
                 "w2f[i] = make_float4(w(d, c0, f0), w(d, c1, f1), w(d + 1, c0, f0), "
                 "w(d + 1, c1, f1));",
                 "for (int i = 0; i < 4; ++i) p[i] = kStream ? __ldcs(r4 + 4 * i) : "
                 "__ldg(r4 + 4 * i);",
                 "if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fffffffu;",
                 'asm("cvt.rn.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));',
                 "b[2 * i][0] = tf32_rn(lrelu(affine(__fadd_rn(v.x, bb.x), s.x, h.x)));",
                 "s = L.sa[4 * i], h = L.ta[4 * i];",
                 "L.sa = bn_a + t;",
                 "L.ta = bn_a + kC / 4 + t;",
                 "return (u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u;"):
        assert line in src, line
    order = ["for (int j = 0; j < 4; ++j) {", "b[2 * i][0] = tf32_rn(",
             "for (int m = 0; m < 4; ++m) {", "for (int s = 0; s < 8; ++s)",
             "mma_tf32(d, m == 0 ? w0[s] : w2f[(8 * m + s) * kLanes + lane], b[s][0], b[s][1]);",
             "mx[m][h] = fmaxf(mx[m][h], fmaxf(v0, v1));", "load_share4(x[j], tab1 +"]
    loop = walk_src[walk_src.index("for (;;) {"):]
    at = 0
    for line in order:  # in this order in the unit loop
        at = loop.index(line, at)
    assert "for (int s = 0; s < 8; ++s) w0[s] = w2f[s * kLanes + lane];" in walk_src
    assert walk_src.index("w0[s] = w2f[") < walk_src.index("for (;;) {")
    assert walk_src.count("w2f[") == 2 and walk_src.count("mma_tf32(") == 1

