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
