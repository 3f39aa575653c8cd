"""The flat exact kNN kernel's selection, modelled on the CPU.

``csrc/knn_exact.cu`` splits each query's rows over S warps (slices): the
rows are walked in chunks of 32 from the chunk of a row hint rightward,
then leftward from the chunk before it (ascending without a hint), slice s
taking the walk's steps s, s + S, ...;
each slice keeps its top-k by (score desc, row asc), admitting a
candidate only ahead of its k-th entry (for k <= 32 into a pending buffer
merged 32 at a time by bitonic networks, ``merge_winners``, the k-th entry
rising only at a merge); the slices' lists meet by rank (an entry's
position in its own list plus, in each other list, the count of entries
ahead of it, equal empties ranked by slice).
Where the rows are sorted by channel 0 (the cloud kernel), a slice stops
walking a side at its first chunk whose nearest row in channel 0 is out of
reach of its k-th entry (``beyond_reach``: |q|^2 - (q0 - x0)^2 plus a
margin for the roundings, below the k-th score). (score, row) is a
total order and the bound holds for every row beyond, so neither the walk,
the split nor the pruning may change a result: the model below must give
``knn_exact_plain``'s indices for any split, any start row and any hint,
on integer inputs (ties everywhere), on x-sorted floats (pruned) and on
unsorted ones. The kernel itself is held against the plain version, and
its pruned walk against its unpruned one, on the card
(``tests/test_torch_cuda.py``)."""

import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_pallas import knn_pallas
from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.knn_exact import (
    CLOUD_WARPS,
    SMS,
    cloud_fits,
    knn_exact,
    knn_exact_plain,
    launch_geometry,
)

LANES = 32
INT_MAX = 2 ** 31 - 1


def walk_chunk(t, c0, nch):
    """Step t of csrc/knn_exact.cu's walk over chunks 0 .. nch - 1 from
    chunk c0: c0, c0 + 1, ..., nch - 1, then c0 - 1, ..., 0."""
    return c0 + t if t < nch - c0 else nch - 1 - t


def _scores(x, q):
    """The plain version's scores: ops/knn.py's ``2 q·x - |x|^2``."""
    return (2.0 * torch.matmul(q, x.transpose(1, 2)) - (x * x).sum(-1)[:, None, :]).numpy()


def beyond_reach(x0, q0, qn2, cmax, ks):
    """csrc/knn_exact.cu::beyond_reach, in float32."""
    f = np.float32
    dx = f(f(x0) - f(q0))
    d2 = f(dx * dx)
    margin = f(f(2.0 ** -14) * f(f(qn2 + f(cmax)) + d2))
    return bool(f(ks) > f(f(f(qn2) - d2) + margin) + f(1e-30))


def _slice_list(scores, k, c0, slices, s, x0=None, q=None, cmax=None, scored=None):
    """Slice s's sorted top-k entries as (-score, row) keys (smaller is
    ahead), filled with empties (inf, INT_MAX); ``x0`` (the rows' channel
    0, sorted) with the query ``q`` and the largest norm ``cmax`` prune
    the walk as the cloud kernel does, None walks every chunk. The chunks
    scored are appended to ``scored`` where given. For k <= 32 the list
    holds 32 entries, its winners wait in a pending buffer merged 32 at a
    time (the k-th entry rising only then); for k > 32 each winner is
    inserted at once."""
    n = scores.shape[0]
    nch = -(-n // LANES)
    empty = (float("inf"), INT_MAX)
    width = LANES if k <= LANES else 2 * LANES
    top, pending = [empty] * width, []
    right = True  # the right side is walked first: a stop there skips to the left
    qn2 = None
    if q is not None:  # one fmaf chain over the channels, from 0
        qn2 = np.float32(0.0)
        for v in q.astype(np.float32):
            qn2 = np.float32(np.float64(v) * np.float64(v) + np.float64(qn2))

    def flush():
        nonlocal top, pending
        top = merge_winners(top, pending[:LANES] + [None] * (LANES - len(pending[:LANES])))
        pending = pending[LANES:]

    for t in range(s, nch, slices):
        c = walk_chunk(t, c0, nch)
        ks = -top[k - 1][0]
        if c > c0:
            if not right:
                continue
            if x0 is not None and x0[c * LANES] >= q[0] and \
                    beyond_reach(x0[c * LANES], q[0], qn2, cmax, ks):
                right = False
                continue
        elif c < c0 and x0 is not None:
            xl = x0[c * LANES + LANES - 1]
            if xl <= q[0] and beyond_reach(xl, q[0], qn2, cmax, ks):
                break  # the left side comes last
        if scored is not None:
            scored.append(c)
        for o in range(c * LANES, min(c * LANES + LANES, n)):  # lane order
            key = (-float(scores[o]), o)
            if key < top[k - 1]:
                if width == LANES:
                    pending.append(key)
                else:
                    top = sorted(top + [key])[:width]
        if len(pending) >= LANES:
            flush()
    if pending:
        flush()
    return top[:k]


def _merge(lists, k):
    """The slices' lists joined by rank, as the kernel's binary searches."""
    out = [None] * k
    for s, own in enumerate(lists):
        for j, e in enumerate(own):
            rank = j + sum(sum(1 for f in other if f < e or (f == e and o < s))
                           for o, other in enumerate(lists) if o != s)
            if rank < k:
                assert out[rank] is None
                out[rank] = e[1]
    assert None not in out
    return out


def model(x, k, queries=None, rows=None, slices=1, prune=True):
    """The kernel's selection: (B, M, k) int32. ``prune``: where a
    cloud's rows are sorted by channel 0, as the cloud kernel prunes."""
    q = x if queries is None else queries
    sc = _scores(x, q)
    b, m, n = sc.shape
    xn, qn = x.numpy(), q.numpy()
    cn = (x * x).sum(-1).numpy()
    out = np.empty((b, m, k), np.int32)
    for bi in range(b):
        x0 = xn[bi, :, 0]
        sorted_ = prune and bool(np.all(x0[:-1] <= x0[1:]))
        for mi in range(m):
            r = 0 if rows is None else int(np.clip(rows[bi, mi], 0, n - 1))
            kw = dict(x0=x0, q=qn[bi, mi], cmax=float(cn[bi].max())) if sorted_ else {}
            lists = [_slice_list(sc[bi, mi], k, r // LANES, slices, s, **kw)
                     for s in range(slices)]
            out[bi, mi] = _merge(lists, k)
    return torch.from_numpy(out)


def _sorted_floats(rng, b, n):
    x = rng.uniform(0.0, 30.0, (b, n, 4)).astype(np.float32)
    x[..., 2:] /= 6.0
    return np.ascontiguousarray(np.take_along_axis(
        x, np.argsort(x[..., 0], axis=1, kind="stable")[..., None], axis=1))


@pytest.mark.parametrize("c0, nch", [(c0, nch) for nch in (1, 2, 3, 7, 32, 219)
                                     for c0 in sorted({0, 1, nch // 2, nch - 2, nch - 1})
                                     if 0 <= c0 < nch])
def test_walk_visits_every_chunk_once(c0, nch):
    walk = [walk_chunk(t, c0, nch) for t in range(nch)]
    assert sorted(walk) == list(range(nch))
    assert walk[0] == c0
    right, left = walk[:nch - c0], walk[nch - c0:]
    assert right == list(range(c0, nch)) and left == list(range(c0 - 1, -1, -1))
    if c0 == 0:
        assert walk == list(range(nch))  # no hint: ascending


# (seed, b, n, m, k, slices, hint): the repair's shape scaled down, a
# self-kNN, ragged n, k over one lane slot, hints at the query's own row,
# random and out-of-range rows
CASES = [(0, 2, 300, 9, 30, 4, "own"), (1, 1, 1001, 6, 30, 8, "own"),
         (2, 2, 300, 5, 40, 2, "random"), (3, 1, 257, 7, 20, 1, "own"),
         (4, 2, 200, 4, 64, 4, "clipped"), (5, 1, 40, 40, 30, 2, "self"),
         (6, 1, 333, 5, 30, 8, None), (7, 2, 100, 3, 1, 4, "random"),
         (8, 1, 300, 40, 30, 1, "own")]


def _case(x, m, hint, rng):
    b, n, _ = x.shape
    if hint == "self":
        return None, np.broadcast_to(np.arange(n), (b, n))
    rows = rng.choice(n, (b, m), replace=False) if m <= n else rng.integers(0, n, (b, m))
    q = torch.from_numpy(np.take_along_axis(x.numpy(), rows[..., None], axis=1))
    if hint == "random":
        return q, rng.integers(0, n, (b, m))
    if hint == "clipped":
        return q, rng.choice([-5, n + 3], (b, m))
    return q, rows if hint == "own" else None


def _int_cloud(rng, b, n, hi=16, sort=True):
    x = rng.integers(0, hi, (b, n, 4)).astype(np.float32)
    if sort:  # channel 0 sorted, as the repair's clouds: the pruned walk
        x = np.take_along_axis(x, np.argsort(x[..., 0], axis=1, kind="stable")[..., None], 1)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("seed, b, n, m, k, slices, hint", CASES)
def test_split_walk_equals_plain_on_integers(seed, b, n, m, k, slices, hint, sort):
    rng = np.random.default_rng(seed)
    x = _int_cloud(rng, b, n, hi=64 if sort else 16, sort=sort)
    q, rows = _case(x, m, hint, rng)
    assert torch.equal(model(x, k, q, rows, slices), knn_exact_plain(x, k, queries=q))


@pytest.mark.parametrize("seed, b, n, m, k, slices, hint", CASES[:5])
def test_split_walk_equals_plain_on_sorted_floats(seed, b, n, m, k, slices, hint):
    rng = np.random.default_rng(seed + 100)
    x = torch.from_numpy(_sorted_floats(rng, b, n))
    q, rows = _case(x, m, hint, rng)
    assert torch.equal(model(x, k, q, rows, slices), knn_exact_plain(x, k, queries=q))


def test_pruning_skips_most_of_a_sorted_cloud():
    """On an x-sorted cloud the pruned walk scores a band around the
    query, not the whole cloud, and gives the plain version's result."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(_sorted_floats(rng, 1, 2000))
    sc = _scores(x, x[:, 1000:1001])[0, 0]
    x0, cmax = x[0, :, 0].numpy(), float((x * x).sum(-1).max())
    visited = []
    top = _slice_list(sc, 30, 1000 // LANES, 1, 0, x0=x0, q=x[0, 1000].numpy(), cmax=cmax,
                      scored=visited)
    assert len(visited) < 20  # of 63 chunks
    assert [o for _, o in top] == knn_exact_plain(x, 30)[0, 1000].tolist()


def _bitonic_step(key, j, desc):
    """csrc/knn_exact.cu::bitonic_step over 32 lanes of (-score, row) keys
    (smaller is ahead); ``desc`` per lane."""
    lanes = np.arange(LANES)
    part = [key[i ^ j] for i in lanes]
    out = []
    for i in lanes:
        lower = (i & j) == 0
        take = part[i] < key[i] if lower == desc[i] else key[i] < part[i]
        out.append(part[i] if take else key[i])
    return out


def merge_winners(lst, cand):
    """csrc/knn_exact.cu::merge_winners: a sorted 32-entry list and a
    chunk's winners (None elsewhere), merged by the bitonic networks."""
    empty = (float("inf"), INT_MAX)
    c = [empty if v is None else v for v in cand]
    k2 = 2
    while k2 <= LANES:
        j = k2 >> 1
        while j > 0:
            c = _bitonic_step(c, j, [(i & k2) == 0 for i in range(LANES)])
            j >>= 1
        k2 <<= 1
    merged = [min(a, b) for a, b in zip(lst, reversed(c))]
    j = LANES // 2
    while j > 0:
        merged = _bitonic_step(merged, j, [True] * LANES)
        j >>= 1
    return merged


@pytest.mark.parametrize("seed", range(12))
def test_batch_merge_equals_insertion_one_by_one(seed):
    """Up to 32 winners merged into a one-slot list at once give the list
    that inserting them one after another gives, on integer scores (ties
    broken by row) and with empty entries on both sides."""
    rng = np.random.default_rng(seed)
    filled = int(rng.integers(0, LANES + 1))
    rows = rng.permutation(4 * LANES)
    lst = sorted((-float(rng.integers(0, 8)), int(r)) for r in rows[:filled])
    lst += [(float("inf"), INT_MAX)] * (LANES - filled)
    win = rng.random(LANES) < rng.uniform(0.1, 1.0)
    cand = [(-float(rng.integers(0, 8)), int(r)) if w else None
            for w, r in zip(win, rows[LANES:2 * LANES])]
    want = sorted(lst + [v for v in cand if v is not None])[:LANES]
    assert merge_winners(lst, cand) == want


def test_split_walk_equals_the_jax_kernel():
    """One case against the interpreted Pallas kernel (``_knn_kernel``):
    integer coordinates, so both frameworks' scores are exact."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 16, (1, 300, 3)).astype(np.float32)
    rows = rng.choice(300, (1, 5), replace=False)
    q = np.take_along_axis(x, rows[..., None], axis=1)
    want = np.asarray(knn_pallas(jnp.asarray(x), 20, packed=False, interpret=True,
                                 queries=jnp.asarray(q)))
    got = model(torch.from_numpy(x), 20, torch.from_numpy(q), rows, slices=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_hint_changes_no_result_on_the_cpu():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_sorted_floats(rng, 2, 500))
    pos = torch.from_numpy(rng.choice(500, (2, 20), replace=False))
    q = x.gather(1, pos[..., None].expand(-1, -1, 4))
    want = knn_exact(x, 30, queries=q)
    for rows in (pos, pos.to(torch.int32), torch.zeros_like(pos), pos.flip(1)):
        assert torch.equal(knn_exact(x, 30, queries=q, query_rows=rows), want)
    assert torch.equal(knn_exact(x, 30, query_rows=torch.arange(500).expand(2, 500)),
                       knn_exact(x, 30))
    with pytest.raises(ValueError, match="query_rows"):
        knn_exact(x, 30, queries=q, query_rows=pos[:, :5])
    with pytest.raises(ValueError, match="query_rows"):
        knn_exact(x, 30, queries=q, query_rows=pos.float())


@pytest.mark.parametrize("b, m, n, cv, want", [
    (8, 256, 7000, 4, 2),      # the stage-1 repair: 128 blocks of 16 queries
    (1, 40000, 40000, 4, 1),   # the capped kNN's fallback past 15 index bits (L2 kernel)
    (8, 7000, 7000, 4, 1),
    (8, 7000, 7000, 64, 1),    # the parity wrapper's flat fallback (L2 kernel)
    (1, 1001, 1001, 4, 4),
    (1, 5, 40, 4, 2),          # two chunks
    (1, 3, 20, 8, 1),          # one chunk
    (8, 256, 12000, 4, 1),     # a cloud beyond shared memory (L2 kernel)
])
def test_launch_geometry(b, m, n, cv, want):
    s = launch_geometry(b, m, n, cv)
    assert s == want
    assert s in (1, 2, 4, 8) and s <= -(-n // LANES)
    assert s == 1 or b * -(-m * s // CLOUD_WARPS) <= SMS


@pytest.mark.parametrize("n, cv, fits", [(7000, 4, True), (10800, 4, True), (10900, 4, False),
                                         (6000, 8, True), (6100, 8, False), (100, 16, False)])
def test_cloud_fits_matches_the_source(n, cv, fits):
    """``cloud_fits`` restates the source's: the cloud's rows and norms
    beside the 32 warps' lists in 227 KB."""
    assert cloud_fits(n, cv) == fits
    src = (_build.CSRC / "knn_exact.cu").read_text()
    for line in (f"constexpr int kCloudWarps = {CLOUD_WARPS};", "constexpr int kMaxSlots = 2;",
                 "constexpr size_t kSmemLimit = 232448;",
                 "constexpr size_t lists = 2 * sizeof(float) * kCloudWarps * kMaxSlots * kLanes + 16;",
                 "return sizeof(float) * (size_t)N * (CV + 1) + lists <= kSmemLimit;"):
        assert line in src, line
