"""The port's scatter-add kernels' plain versions (what the CUDA kernels of
``kernels/csrc/scatter_rows.cu`` are held against on the card) against
the JAX package's Pallas scatter kernels in interpret mode and XLA's
scatter, on the CPU.

Tolerance 1e-5 (absolute and relative): the two sides add the same rows
in another order, and FP32 sums differ in the last bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.scatter_pallas import scatter_add_rows as jax_scatter_add_rows
from dgcnn_tpu.kernels.scatter_pallas import (
    scatter_stage_tail_rows as jax_scatter_stage_tail_rows,
)
from dgcnn_tpu_torch.kernels.scatter_rows import (
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_stage_tail_rows,
    scatter_stage_tail_rows_plain,
)
from dgcnn_tpu_torch.ops.edgeconv import gather_neighbors
from dgcnn_tpu_torch.ops.knn import knn
from torch_port_helpers import sorted_blocks

TOL = dict(atol=1e-5, rtol=1e-5)


def _rows_inputs(seed, b, m, c, n, dup=False):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((b, m, c)).astype(np.float32)
    hi = max(n // 8, 1) if dup else n  # few targets: many duplicates each
    idx = rng.integers(0, hi, (b, m)).astype(np.int32)
    return dy, idx


@pytest.mark.parametrize("b, m, c, n, dup", [
    (2, 500, 16, 40, False),    # m not a multiple of any chunk
    (2, 1237, 4, 97, True),     # stage-1 width, heavy duplicates
    (1, 333, 64, 61, False),    # stage-2 width
    (3, 210, 5, 7, True),       # a width that is no multiple of 4
])
def test_scatter_add_rows_plain_matches_jax_kernel(b, m, c, n, dup):
    dy, idx = _rows_inputs(b * m + c, b, m, c, n, dup)
    got = scatter_add_rows(torch.from_numpy(dy), torch.from_numpy(idx), n).numpy()
    want = np.asarray(jax_scatter_add_rows(jnp.asarray(dy), jnp.asarray(idx), n,
                                           chunk=128, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    xla = np.asarray(jnp.zeros((b, n, c)).at[jnp.arange(b)[:, None], jnp.asarray(idx)]
                     .add(jnp.asarray(dy)))
    np.testing.assert_allclose(got, xla, **TOL)


@pytest.mark.parametrize("c", [4, 64])
def test_scatter_add_rows_on_knn_indices_matches_jax_kernel(c):
    """The indices the CUDA kernel is built around: the port's plain kNN of
    x-sorted blocks (each row a target of ~k rows of nearby queries, the
    rows of one query's neighbours consecutive), at the stage widths."""
    b, n, k = 2, 300, 20
    idx = knn(torch.from_numpy(sorted_blocks(b, n, seed=c)), k).reshape(b, n * k)
    dy = np.random.default_rng(c).standard_normal((b, n * k, c)).astype(np.float32)
    got = scatter_add_rows(torch.from_numpy(dy), idx, n).numpy()
    want = np.asarray(jax_scatter_add_rows(jnp.asarray(dy), jnp.asarray(idx.numpy()), n,
                                           chunk=512, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_scatter_add_rows_plain_is_index_add():
    dy, idx = _rows_inputs(5, 2, 300, 8, 50, dup=True)
    want = torch.zeros(2 * 50, 8)
    flat = torch.from_numpy(idx).long() + torch.arange(2)[:, None] * 50
    want.index_add_(0, flat.reshape(-1), torch.from_numpy(dy).reshape(-1, 8))
    got = scatter_add_rows_plain(torch.from_numpy(dy), torch.from_numpy(idx), 50)
    torch.testing.assert_close(got, want.reshape(2, 50, 8), atol=0, rtol=0)


def test_out_of_range_index_is_the_clamped_gathers_adjoint():
    """An index outside [0, N) (a padding row of an overflowing capped
    window) lands where the port's forward gather read it: the scatter is
    the exact adjoint of the clamped gather. (JAX's scatter drops such an
    index and its flat gather reads the next element's row, so the two
    packages differ here by design.)"""
    rng = np.random.default_rng(7)
    b, n, k, c = 2, 30, 5, 6
    feats = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[0, 3, 1] = n + 4
    idx[1, 7, 0] = -2
    idx = torch.from_numpy(idx)
    dy = torch.from_numpy(rng.standard_normal((b, n, k, c)).astype(np.float32))
    feats.requires_grad_(True)
    (gather_neighbors(feats, idx) * dy).sum().backward()
    # the adjoint of the clamped gather, by autograd through torch.gather
    f2 = feats.detach().clone().requires_grad_(True)
    flat = idx.long().clamp(0, n - 1).reshape(b, -1, 1).expand(-1, -1, c)
    (torch.gather(f2, 1, flat).reshape(b, n, k, c) * dy).sum().backward()
    torch.testing.assert_close(feats.grad, f2.grad, **TOL)
    direct = scatter_add_rows(dy.reshape(b, -1, c), idx.reshape(b, -1), n)
    torch.testing.assert_close(direct, f2.grad, **TOL)


def _tail_inputs(seed, b, n, k, c):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, n, c)).astype(np.float32)
    w = rng.standard_normal((b, n, c)).astype(np.float32)
    am = rng.integers(0, k, (b, n, c)).astype(np.int8)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, ::3, 1] = idx[:, ::3, 0]  # duplicate targets within a query too
    return u, w, am, idx


def _jax_tail(u, w, am, idx, k):
    """The JAX kernel with the count in a reserved lane, as
    ``ops/edgeconv.py::_edge_stage_tail_bwd`` pads it."""
    b, n, c = u.shape
    lp = -(-(c + 1) // 128) * 128
    u_p = np.concatenate([u, np.zeros((b, n, lp - c), np.float32)], -1)
    w_p = np.concatenate([w, np.ones((b, n, 1), np.float32),
                          np.zeros((b, n, lp - c - 1), np.float32)], -1)
    am_p = np.concatenate([am.astype(np.int32), np.full((b, n, lp - c), -1, np.int32)], -1)
    scat = np.asarray(jax_scatter_stage_tail_rows(
        jnp.asarray(u_p), jnp.asarray(w_p), jnp.asarray(am_p), jnp.asarray(idx),
        k=k, n=n, q_block=8, interpret=True, copies=3))
    return scat[..., :c], scat[..., c]


@pytest.mark.parametrize("b, n, k, c", [(2, 37, 7, 64), (1, 50, 5, 3), (2, 19, 12, 9)])
def test_scatter_stage_tail_plain_matches_jax_kernel(b, n, k, c):
    u, w, am, idx = _tail_inputs(b * n + k, b, n, k, c)
    sums, count = scatter_stage_tail_rows(*(torch.from_numpy(a) for a in (u, w, am, idx)))
    want_sums, want_count = _jax_tail(u, w, am, idx, k)
    np.testing.assert_allclose(sums.numpy(), want_sums, **TOL)
    np.testing.assert_allclose(count.numpy(), want_count, atol=0, rtol=0)


def test_scatter_stage_tail_plain_matches_loop():
    u, w, am, idx = _tail_inputs(3, 2, 23, 6, 5)
    sums, count = scatter_stage_tail_rows_plain(*(torch.from_numpy(a) for a in (u, w, am, idx)))
    want = np.zeros_like(u)
    want_count = np.zeros(u.shape[:2], np.float32)
    for b in range(2):
        for q in range(23):
            for j in range(6):
                want[b, idx[b, q, j]] += u[b, q] * (am[b, q] == j) + w[b, q]
                want_count[b, idx[b, q, j]] += 1
    np.testing.assert_allclose(sums.numpy(), want, **TOL)
    np.testing.assert_array_equal(count.numpy(), want_count)


def test_predicate_and_device_checks():
    dy, idx = _rows_inputs(1, 1, 20, 4, 10)
    no = torch.zeros((), dtype=torch.bool)
    out = scatter_add_rows(torch.from_numpy(dy), torch.from_numpy(idx), 10, pred=no)
    assert out.shape == (1, 10, 4) and not out.any()
    u, w, am, idx3 = (torch.from_numpy(a) for a in _tail_inputs(2, 1, 10, 3, 4))
    sums, count = scatter_stage_tail_rows(u, w, am, idx3, pred=no)
    assert not sums.any() and not count.any()
    with pytest.raises(ValueError, match="do not match"):
        scatter_add_rows(torch.from_numpy(dy), torch.from_numpy(idx)[:, :5], 10)
    with pytest.raises(ValueError, match="do not match"):
        scatter_stage_tail_rows(u, w[:, :5], am, idx3)


# The tail kernel's tile route (csrc/scatter_rows.cu::scatter_tail_tile_kernel)
# modelled block by block: a block owns element b and a tile of qt queries,
# whose q * k + j entries are contiguous in idx; it sorts them by target row
# (a counting sort over the rows' span: histogram, ranks, exclusive scan),
# packs each as (row - lo) << 16 | q_local << 7 | j, and each of its SLICES
# half-warps walks an equal slice of the sorted entries, summing a row's
# entries, (am == j ? u : 0) + w, and adding the sum into the zeroed
# outputs where the row changes (a row two slices share is added twice),
# with the run's length into the count. THREADS and SLICES are the kernel's
# kTileThreads and kTileSlices.
THREADS, SLICES = 512, 32


def _entry_walk(n_entries, k):
    """The (entry, q, j) triples the kernel's threads visit: thread t starts
    at entry t with q = t // k, j = t % k, then steps by THREADS entries,
    advancing q by THREADS // k and j by THREADS % k (carrying into q)."""
    dq, dj = divmod(THREADS, k)
    e = np.arange(THREADS)
    q, j = e // k, e % k
    out = []
    while (e < n_entries).any():
        live = e < n_entries
        out.append((e[live], q[live], j[live]))
        e, q, j = e + THREADS, q + dq, j + dj
        q, j = np.where(j >= k, q + 1, q), np.where(j >= k, j - k, j)
    return [np.concatenate(t) for t in zip(*out)] if out else [np.zeros(0, int)] * 3


def _tiled_tail(u, w, am, idx, qt):
    """The tile route's blocks in plain PyTorch (float32 sums in the walk's
    order; the kernel's ranks within a row follow its atomics, here the
    entries' order)."""
    b, n, c = u.shape
    k = idx.shape[-1]
    sums, count = torch.zeros((b, n, c)), torch.zeros((b, n))
    for bb in range(b):
        for q0 in range(0, n, qt):
            n_entries = min(qt, n - q0) * k
            e, q, j = (torch.from_numpy(a) for a in _entry_walk(n_entries, k))
            assert torch.equal(e.sort().values, torch.arange(n_entries))
            assert torch.equal(e, q * k + j)  # the walk visits each entry once
            t = idx[bb, q0:q0 + qt].reshape(-1).long().clamp(0, n - 1)
            lo, hi = int(t.min()), int(t.max())
            hist = torch.bincount(t - lo, minlength=hi - lo + 1)
            offsets = torch.cumsum(hist, 0) - hist  # the exclusive scan
            rank = torch.zeros(n_entries, dtype=torch.long)
            seen = torch.zeros(hi - lo + 1, dtype=torch.long)
            for ee in e.tolist():  # the histogram's atomics hand out the ranks
                rank[ee] = seen[t[ee] - lo]
                seen[t[ee] - lo] += 1
            packed = torch.empty(n_entries, dtype=torch.long)
            packed[offsets[t[e] - lo] + rank[e]] = (t[e] - lo) << 16 | q << 7 | j
            per = -(-n_entries // SLICES)
            for p0 in range(0, n_entries, per):
                cur, run, acc = -1, 0, None
                for v in packed[p0:min(p0 + per, n_entries)].tolist():
                    r, ql, jj = v >> 16, (v >> 7) & 511, v & 127
                    if r != cur:
                        if cur >= 0:
                            sums[bb, lo + cur] += acc
                            count[bb, lo + cur] += run
                        cur, run, acc = r, 0, torch.zeros(c)
                    run += 1
                    qq = q0 + ql
                    acc += torch.where(am[bb, qq].long() == jj, u[bb, qq], 0.0) + w[bb, qq]
                if cur >= 0:
                    sums[bb, lo + cur] += acc
                    count[bb, lo + cur] += run
    return sums, count


def _assert_sums_close(got, want, u, w, am, idx, count):
    """Within 1e-5 (absolute and relative), or where a row takes many
    entries (the clamped rows 0 and N-1 take ~8x the others) within twice
    the recursive-summation bound (hits - 1) * 2^-24 * sum |term| of each
    of two sums of the same terms in different orders."""
    mag = scatter_stage_tail_rows_plain(u.abs(), w.abs(), am, idx)[0]
    bound = 2 * count[..., None] * 2.0 ** -24 * mag
    err = (got - want).abs()
    assert (err <= torch.maximum(1e-5 + 1e-5 * want.abs(), bound)).all()


_JAX_TAIL = {}


@pytest.mark.parametrize("k", [1, 20, 30])
@pytest.mark.parametrize("qt", [1, 5, 41])
def test_tail_tile_model_matches_jax_kernel(qt, k):
    """Tiles of 1, 5 and 41 (= N: one tile) queries, every tile's sort and
    the half-warps' slices with their flushes, the count, indices in [-7, N+7)
    clamped, C=9: the model against the plain version and the JAX kernel
    (interpret mode, on the clamped indices)."""
    b, n, c = 2, 41, 9
    rng = np.random.default_rng(k)
    u, w = rng.standard_normal((2, b, n, c)).astype(np.float32)
    am = rng.integers(-1, k, (b, n, c)).astype(np.int8)
    idx = rng.integers(-7, n + 7, (b, n, k)).astype(np.int32)
    if k > 1:
        idx[:, ::3, 1] = idx[:, ::3, 0]  # duplicate targets within a query too
    t = [torch.from_numpy(a) for a in (u, w, am, idx)]
    sums, count = _tiled_tail(*t, qt)
    want_sums, want_count = scatter_stage_tail_rows_plain(*t)
    assert torch.equal(count, want_count)
    _assert_sums_close(sums, want_sums, *t, count)
    if k not in _JAX_TAIL:
        _JAX_TAIL[k] = [torch.tensor(a) for a in _jax_tail(u, w, am, np.clip(idx, 0, n - 1), k)]
    assert torch.equal(count, _JAX_TAIL[k][1])
    _assert_sums_close(sums, _JAX_TAIL[k][0], *t, count)


@pytest.mark.parametrize("n_entries, k", [(4080, 30), (8192, 1), (4064, 127), (3, 1), (0, 7)])
def test_tail_entry_walk(n_entries, k):
    """The kernel's running (q, j) of each thread stays q * k + j = e over a
    whole tile, at k up to the int8 limit."""
    e, q, j = _entry_walk(n_entries, k)
    assert np.array_equal(np.sort(e), np.arange(n_entries))
    assert np.array_equal(q * k + j, e) and (j < k).all()


def test_tail_entry_packing_at_its_limits():
    """A sorted entry's row (< 32768 = TAIL_MAX_ROWS), tile query (< 512 =
    TAIL_MAX_QUERIES) and slot (< 128) come back from its int32."""
    from dgcnn_tpu_torch.kernels.scatter_rows import TAIL_MAX_QUERIES, TAIL_MAX_ROWS

    for r, q, j in ((TAIL_MAX_ROWS - 1, TAIL_MAX_QUERIES - 1, 126), (0, 0, 0), (1, 511, 1)):
        v = np.int32(r << 16 | q << 7 | j)
        assert v >= 0 and (int(v) >> 16, (int(v) >> 7) & 511, int(v) & 127) == (r, q, j)


BUDGET = 232448


@pytest.mark.parametrize("b, n, k, c, qt", [
    (8, 7000, 30, 64, 68),     # the train step's stage 3: 2040 entries a tile, 83 KB
    (8, 7000, 20, 64, 102),
    (8, 7000, 127, 64, 16),
    (8, 7000, 1, 64, 212),     # 424 queries take 272 KB: halved once
    (8, 7000, 30, 1, 68),
    (1, 7000, 30, 64, 53),     # one cloud: 133 tiles of 53 queries
    (1, 1001, 20, 64, 7),
    (16, 7000, 1, 16, 512),    # at most 512 queries a tile
    (8, 7000, 30, 256, 68),    # wide rows: 201 KB
    (8, 7000, 30, 512, 34),    # ... halved until the tile fits
    (132, 100, 30, 64, 68),
    (132, 50, 30, 64, 50),     # one tile a cloud
    (1, 1, 1, 1, 1),
    (8, 32768, 30, 64, 68),    # the most rows a tile's entry packs
    (8, 32768, 30, 256, 34),
    (8, 32769, 30, 64, 0),     # ... and past them the global route
    (1, 60000, 30, 64, 0),
])
def test_tail_plan_edges(b, n, k, c, qt):
    from dgcnn_tpu_torch.kernels.scatter_rows import tail_plan, tile_smem_bytes

    assert tail_plan(b, n, k, c) == qt
    if qt:
        assert qt * k <= 2048 and tile_smem_bytes(n, k, c, qt) <= BUDGET
        assert qt == min(512, 2048 // k, n, max(1, b * n // 132)) \
            or tile_smem_bytes(n, k, c, 2 * qt) > BUDGET


def test_tail_plan_budget_and_entries():
    from dgcnn_tpu_torch.kernels.scatter_rows import tail_plan, tile_smem_bytes

    need = tile_smem_bytes(7000, 30, 64, 68)
    assert need == 4 * (7000 + 2 * 2040) + 9 * 68 * 64
    assert tail_plan(8, 7000, 30, 64, budget=need) == 68
    assert tail_plan(8, 7000, 30, 64, budget=need - 1) == 34
    assert tail_plan(8, 7000, 30, 64, budget=4 * 7000 + 8) == 0  # not one query fits
    assert tail_plan(8, 7000, 30, 64, entries=4096) == 136
    assert tail_plan(8, 7000, 30, 64, entries=8192) == 136  # 273 queries take 245 KB
    assert tail_plan(8, 7000, 30, 64, entries=1024) == 34
    assert tile_smem_bytes(7001, 1, 3, 1) == 4 * 7004 + 27  # the int arrays end 16-byte aligned
