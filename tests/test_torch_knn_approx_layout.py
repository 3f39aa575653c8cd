"""The approximate kNN kernel's walk (``csrc/knn_approx.cu``), stated in
numpy and held to the plain version (``ops/knn.py::approx_fold`` and
``_top_k``) on the CPU.

The kernel cannot run here; its index arithmetic can. This file restates
it step for step: the stage positions (position c * 32 + j of stage s of
group g is bin 32 g + j's chunk 8 s + c), the groups of 32 bins walked
outward from the group of the block's middle query, each group's chunks in
stages of up to 8 with each query's running winners carried from stage to
stage, the fold (chunk 0 first, a later chunk only when strictly greater),
the 64-bit keys (score_key high, ~row low), the ballot of each group's
winners against the running k-th key and the warp-wide list insertion in
rounds of one survivor a query. The model takes the scores as given, so
the plain version and the model see the same bits: on integer clouds
(exact scores, many ties) and on floats they must return the same rows.
Non-finite scores follow the first design's rule, stated here directly: a
NaN winner never enters, a -inf winner ranks ahead of the empty slots,
which read INT_MAX.
"""

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.ops.knn import _top_k, approx_fold, approx_reduction_size

GROUP, CHUNKS = 32, 8  # bins a group (one a lane), chunks a stage
QB = 64  # queries a block
LANES = np.arange(32)
NETWORK = 6  # survivors a query above which the network takes them ...
NETWORK_TWO_PHASE = 10  # ... in the two-phase kernel (C >= 16)
EMPTY = np.iinfo(np.int64).min
INT_MAX = np.iinfo(np.int32).max


def walk_group(i: int, g0: int, groups: int) -> int:
    """The i-th group of the walk from group g0: g0, g0 + 1, g0 - 1, ..."""
    off = (i + 1) // 2 if i & 1 else -(i // 2)
    return (g0 + off) % groups


def walk_shape(n: int, width: int) -> tuple[int, int, int]:
    """(chunks T, groups G, stages a group S)."""
    t = -(-n // width)
    return t, -(-width // GROUP), -(-t // CHUNKS)


def stage_rows(g: int, s: int, width: int, t: int, n: int) -> np.ndarray:
    """The rows at the 256 positions of stage s of group g, -1 where none
    (a bin >= L, a chunk >= T or a row >= N): position c * 32 + j holds
    bin 32 g + j's chunk 8 s + c."""
    p = np.arange(GROUP * CHUNKS)
    bins, chunk = g * GROUP + p % GROUP, s * CHUNKS + p // GROUP
    o = bins + chunk * width
    return np.where((bins < width) & (chunk < t) & (o < n), o, -1)


def winner_key(best: np.ndarray, row: np.ndarray) -> np.ndarray:
    """score_key(best) << 32 | (unsigned) ~row as int64; NaN: EMPTY."""
    bits = best.astype(np.float32).view(np.int32).astype(np.int64)
    hi = np.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))
    key = hi * 2 ** 32 + (~row.astype(np.int64) & 0xFFFFFFFF)
    return np.where(np.isnan(best), EMPTY, key)


def key_row(key: np.ndarray) -> np.ndarray:
    return np.where(key == EMPTY, INT_MAX, 0xFFFFFFFF - (key & 0xFFFFFFFF)).astype(np.int32)


def list_insert(lst: np.ndarray, c: np.ndarray) -> np.ndarray:
    """c into each sorted list (slot s in lane s % 32): its position is the
    number of slots above it (a ballot), the slots from there on move down
    one (a shuffle up), the last drops; EMPTY changes nothing."""
    pos = (lst > c[..., None]).sum(-1, keepdims=True)
    slot = np.arange(lst.shape[-1])
    moved = np.concatenate([lst[..., :1], lst[..., :-1]], -1)
    return np.where(slot < pos, lst, np.where(slot == pos, c[..., None], moved))


def pick(a, b, larger):
    """The larger (or smaller) of two keys, lane by lane."""
    return np.where((a > b) == larger, a, b)


def warp_sort(v: np.ndarray) -> np.ndarray:
    """A key a lane (..., 32), sorted largest first by the bitonic network
    of the kernel's warp_sort: runs of ``size`` alternate largest-first and
    smallest-first, the lower lane of a pair keeps the run's leading key."""
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            v = pick(v, v[..., LANES ^ stride], ((LANES & stride) == 0) == ((LANES & size) == 0))
            stride //= 2
        size *= 2
    return v


def warp_merge(lst: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """The kernel's warp_merge: the sorted candidates reversed against the
    sorted list, the larger of each pair, then 5 bitonic merge steps."""
    v = pick(lst, cand[..., 31 - LANES], True)
    stride = 16
    while stride:
        v = pick(v, v[..., LANES ^ stride], (LANES & stride) == 0)
        stride //= 2
    return v


def offer(lst, kth, v, k, counts, two_phase):
    """One group's winners (a lane's v, a query's row) against the lists:
    a ballot keeps those above the query's k-th key so far; a query of more
    than NETWORK survivors (a 32-slot list) takes them at once through the
    sorting network and the merge (the two-phase kernel: every query of a
    warp of 8 where one has more than NETWORK_TWO_PHASE); the rest go in one at a time, lowest lane
    first (list_insert); then the k-th keys, read once."""
    passed = v > kth[..., None]
    counts += passed.sum(-1)
    if lst.shape[-1] == 32:
        big = passed.sum(-1) > (NETWORK_TWO_PHASE if two_phase else NETWORK)
        if two_phase:  # (b, q): a warp's 8 queries together
            pad = -big.shape[1] % 8
            warps = np.pad(big, ((0, 0), (0, pad))).reshape(big.shape[0], -1, 8).any(-1)
            big = np.repeat(warps, 8, 1)[:, :big.shape[1]]
        merged = warp_merge(lst, warp_sort(np.where(passed, v, EMPTY)))
        lst = np.where(big[..., None], merged, lst)
        passed &= ~big[..., None]
    while passed.any():
        has = passed.any(-1)
        lane = passed.argmax(-1)
        c = np.where(has, np.take_along_axis(v, lane[..., None], -1)[..., 0], EMPTY)
        lst = list_insert(lst, c)
        np.put_along_axis(passed, lane[..., None], False, -1)
    return lst, lst[..., k - 1].copy()


def kernel_model(scores: np.ndarray, k: int, width: int, two_phase: bool = False):
    """(rows (B, M, k) int32, survivors a query): the kernel's walk over
    the float32 scores (B, M, N), block by block (two_phase: the C >= 16
    kernel's network rule)."""
    b, m, n = scores.shape
    t, groups, stages = walk_shape(n, width)
    kmax = 32 if k <= 32 else 64
    out = np.empty((b, m, k), np.int32)
    counts = np.zeros((b, m), np.int64)
    for q0 in range(0, m, QB):
        blk = scores[:, q0:q0 + QB]  # queries past M are not written
        g0 = ((q0 + QB // 2) % width) // GROUP
        lst = np.full(blk.shape[:2] + (kmax,), EMPTY)
        kth = np.full(blk.shape[:2], EMPTY)
        for i in range(groups * stages):
            g, s = walk_group(i // stages, g0, groups), i % stages
            rows = stage_rows(g, s, width, t, n).reshape(CHUNKS, GROUP)
            staged = blk[..., np.maximum(rows, 0)]  # (b, q, chunk, lane)
            for c in range(CHUNKS):
                sc, o = staged[..., c, :], rows[c]
                if s == 0 and c == 0:
                    best, brow = sc.copy(), np.broadcast_to(o, sc.shape).copy()
                else:
                    take = (o >= 0) & (sc > best)  # a later chunk wins by more only
                    best, brow = np.where(take, sc, best), np.where(take, o, brow)
            if s == stages - 1:  # the group's winners are final
                real = g * GROUP + np.arange(GROUP) < width
                v = np.where(real, winner_key(best, brow), EMPTY)
                lst, kth = offer(lst, kth, v, k, counts[:, q0:q0 + QB], two_phase)
        out[:, q0:q0 + QB] = key_row(lst[..., :k])
    return out, counts


def scores_of(x: np.ndarray, queries: np.ndarray | None = None) -> np.ndarray:
    """The plain version's FP32 scores 2 q.x - |x|^2 (B, M, N)."""
    xt = torch.from_numpy(x)
    qt = xt if queries is None else torch.from_numpy(queries)
    return (2.0 * torch.matmul(qt, xt.transpose(1, 2))
            - (xt * xt).sum(-1)[:, None, :]).numpy()


def plain(scores: np.ndarray, k: int, width: int) -> np.ndarray:
    st = torch.from_numpy(scores)
    if width == scores.shape[-1]:
        return _top_k(st, None, k).numpy()
    return _top_k(*approx_fold(st, width), k).numpy()


def first_design_rule(scores: np.ndarray, k: int, width: int) -> np.ndarray:
    """The first design's output, stated directly: each bin's winner
    (approx_fold: chunk 0 unless a later chunk is strictly greater), the
    NaN winners dropped, the rest by (score descending, row ascending),
    INT_MAX past them."""
    best, rows = (t.numpy() for t in approx_fold(torch.from_numpy(scores), width))
    nan = np.isnan(best)
    order = np.lexsort((rows, np.where(nan, 0.0, -best.astype(np.float64)), nan), -1)[..., :k]
    return np.where(np.take_along_axis(nan, order, -1), INT_MAX,
                    np.take_along_axis(rows, order, -1)).astype(np.int32)


def int_cloud(b, n, c, seed, sort=True):
    """Integer points (exact scores, many ties), x-sorted where ``sort``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 8, (b, n, c)).astype(np.float32)
    if sort:
        x[..., 0] = np.sort(rng.integers(0, 300, (b, n)), -1)
    return x


def blocks(b, n, seed):
    """x-sorted float points, xyz in a 30 m block plus one feature."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 30.0, (b, n, 4)).astype(np.float32)
    return np.take_along_axis(x, np.argsort(x[..., :1], 1, kind="stable"), 1)


# (label, cloud, queries: None (self) or a slice of the cloud's rows, k,
# recall target): L = N (T = 1), k = 1 (L = 128, T = 55: seven stages a
# group), the forward's short last chunk (7000 = 7 * 896 + 728), N = 2000
# (L = 1024), L = 128 at k = 10 (T = 32), k = 16 and k = 64 (64 slots), a
# partial last block of queries in each
CASES = [
    ("L=N int", lambda: int_cloud(1, 1000, 4, 1), None, 30, 0.95),
    ("k=1 int", lambda: int_cloud(1, 7000, 4, 2), slice(3000, 3130), 1, 0.95),
    ("short chunk int", lambda: int_cloud(1, 7000, 4, 3), slice(3400, 3600), 30, 0.95),
    ("short chunk C=64 int", lambda: int_cloud(1, 7000, 64, 4, False), slice(0, 70), 30, 0.95),
    ("N=2000 floats", lambda: blocks(1, 2000, 5), None, 30, 0.95),
    ("T=32 int", lambda: int_cloud(1, 4096, 8, 6), slice(100, 200), 10, 0.9),
    ("k=16 int", lambda: int_cloud(1, 4096, 8, 7), slice(0, 100), 16, 0.95),
    ("k=64 int", lambda: int_cloud(1, 5000, 16, 8), slice(2500, 2570), 64, 0.95),
    ("short chunk floats", lambda: blocks(1, 7000, 9), slice(5000, 5200), 30, 0.95),
    ("C=64 normal floats", lambda: np.random.default_rng(10).standard_normal(
        (1, 7000, 64)).astype(np.float32), slice(6900, 7000), 30, 0.95),
]


def case_scores(cloud, rows):
    """(scores, channels) of a case."""
    x = cloud()
    return scores_of(x, None if rows is None else np.ascontiguousarray(x[:, rows])), x.shape[-1]


@pytest.mark.parametrize("n, k, r", [(1000, 30, 0.95), (7000, 1, 0.95), (7000, 30, 0.95),
                                     (2000, 30, 0.95), (4096, 10, 0.9), (5000, 64, 0.95),
                                     (129, 5, 0.5)])
def test_every_row_is_staged_once_at_its_bin_and_chunk(n, k, r):
    width = approx_reduction_size(n, k, r)
    t, groups, stages = walk_shape(n, width)
    for q0 in (0, 64 * 7, 64 * 50):
        g0 = ((q0 + QB // 2) % width) // GROUP
        seen = []
        for i in range(groups * stages):
            g, s = walk_group(i // stages, g0, groups), i % stages
            rows = stage_rows(g, s, width, t, n)
            p = np.flatnonzero(rows >= 0)
            o = rows[p]
            assert np.array_equal(o % width, g * GROUP + p % GROUP)  # the bin: its lane
            assert np.array_equal(o // width, s * CHUNKS + p // GROUP)  # the chunk: its row
            seen.append(o)
        assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(n))


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 28, 31, 40])
def test_groups_are_walked_outward_each_once(groups):
    for g0 in range(groups):
        walk = [walk_group(i, g0, groups) for i in range(groups)]
        assert sorted(walk) == list(range(groups))
        assert walk[:3] == [g0, (g0 + 1) % groups, (g0 - 1) % groups][:groups]


def test_keys_order_score_then_lower_row():
    s = np.array([-np.inf, -np.inf, -3.5, -0.0, 0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    rows = np.array([9, 2, 7, 5, 3, 4, 8, 1, 6])
    keys = winner_key(s, rows)
    # (score descending, row ascending); -0.0 and +0.0 tie; -inf above EMPTY
    assert list(np.argsort(keys)[::-1]) == [8, 7, 6, 4, 5, 3, 2, 1, 0]
    assert (keys > EMPTY).all()
    assert winner_key(np.array([np.nan], np.float32), np.array([0]))[0] == EMPTY
    assert np.array_equal(key_row(keys), rows)
    assert key_row(np.array([EMPTY]))[0] == INT_MAX


def test_network_keeps_the_32_largest_in_order():
    rng = np.random.default_rng(13)
    keys = rng.integers(-2 ** 62, 2 ** 62, (200, 2, 32))
    keys[rng.random(keys.shape) < 0.3] = EMPTY  # empty slots and lanes repeat
    lst = np.flip(np.sort(keys[:, 0], -1), -1)
    cand = warp_sort(keys[:, 1])
    assert np.array_equal(cand, np.flip(np.sort(keys[:, 1], -1), -1))
    want = np.flip(np.sort(keys.reshape(200, 64), -1), -1)[:, :32]
    assert np.array_equal(warp_merge(lst, cand), want)


@pytest.mark.parametrize("label, cloud, rows, k, r", CASES, ids=[c[0] for c in CASES])
def test_kernel_walk_equals_the_plain_fold(label, cloud, rows, k, r):
    scores, c = case_scores(cloud, rows)
    width = approx_reduction_size(scores.shape[-1], k, r)
    got, counts = kernel_model(scores, k, width, two_phase=c > 8)
    assert np.array_equal(got, plain(scores, k, width))
    # the ballot keeps at least the k winners a query needs, at most every bin
    assert (counts >= k).all() and (counts <= width).all()


def test_non_finite_scores_follow_the_first_design_rule():
    x = blocks(1, 3000, 11)
    rng = np.random.default_rng(12)
    for value in (np.inf, -np.inf, np.nan):
        x.reshape(-1)[rng.integers(0, x.size, 40)] = value
    scores = scores_of(x)
    width = approx_reduction_size(3000, 30)
    assert width == 768
    best = approx_fold(torch.from_numpy(scores), width)[0].numpy()
    # the case holds what the rule is about: NaN winners (a whole query's
    # too), -inf and +inf winners
    assert np.isnan(best).any() and np.isnan(best).all(-1).any()
    assert np.isneginf(best).any() and np.isposinf(best).any()
    got, _ = kernel_model(scores, 30, width)
    want = first_design_rule(scores, 30, width)
    assert np.array_equal(got, want)
    assert (got == INT_MAX).any()
    finite = np.isfinite(best).all(-1)  # where every winner is finite: the plain version
    assert np.array_equal(got[finite], plain(scores, 30, width)[finite])
