"""Port row gather (dgcnn_tpu_torch.kernels.gather_rows) against the JAX
package on the CPU: the plain version bit for bit against the interpreted
``gather_pallas.gather_rows`` (kernel ``_kernel``) on seeded float tables,
the clamp of out-of-range indices, and ``ops/edgeconv.py::gather_neighbors``
on a CPU tensor (the plain version, equal to the JAX package's gather)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.gather_pallas import gather_rows as jax_gather_rows
from dgcnn_tpu.ops.edgeconv import gather_neighbors as jax_gather_neighbors
from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain
from dgcnn_tpu_torch.ops import edgeconv
from dgcnn_tpu_torch.ops.knn import knn
from torch_port_helpers import sorted_blocks


def _table_and_idx(seed, b, n, m, c):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, m)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("b, n, m, c, chunk", [
    (2, 77, 300, 1, 64),    # odd N, M not a multiple of the chunk
    (2, 129, 250, 4, 96),
    (1, 301, 333, 8, 128),
    (2, 45, 190, 64, 64),
])
def test_plain_matches_jax_kernel(b, n, m, c, chunk):
    table, idx = _table_and_idx(n + c, b, n, m, c)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx), chunk=chunk,
                                      interpret=True))
    got = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert got.shape == (b, m, c)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("c", [4, 64])
def test_plain_on_knn_indices_matches_jax_kernel(c):
    """The indices the CUDA kernel is built around: the port's plain kNN of
    x-sorted blocks (neighbouring queries read overlapping rows), at the
    stage widths; bit for bit."""
    b, n, k = 2, 300, 20
    pts = sorted_blocks(b, n, seed=c)
    idx = knn(torch.from_numpy(pts), k).reshape(b, n * k)
    table = pts if c == 4 else np.random.default_rng(c).standard_normal(
        (b, n, c)).astype(np.float32)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx.numpy()),
                                      chunk=600, interpret=True))
    got = gather_rows(torch.from_numpy(table), idx).numpy()
    assert got.tobytes() == want.tobytes()


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    table, idx = _table_and_idx(1, 2, 50, 120, 4)
    before = gather_rows.launches
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert torch.equal(got, gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx)))
    assert gather_rows.launches == before


def test_out_of_range_indices_clamp():
    table, _ = _table_and_idx(2, 1, 10, 1, 3)
    idx = np.array([[-3, 0, 9, 10, 40]], np.int32)
    got = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got[0], table[0][np.clip(idx[0], 0, 9)])


def test_validation():
    with pytest.raises(ValueError, match="do not match"):
        gather_rows(torch.zeros(2, 5, 3), torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        gather_rows(torch.zeros(2, 5, 3), torch.zeros(2, 4, 1, dtype=torch.int32))


@pytest.mark.parametrize("n, c, k", [(90, 16, 7), (77, 4, 30), (45, 64, 5)])
def test_gather_neighbors_on_cpu_is_the_plain_gather(n, c, k):
    """A CPU tensor takes the plain gather, equal to the JAX package's
    gather; no kernel launches."""
    rng = np.random.default_rng(n + c)
    feats = rng.standard_normal((2, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (2, n, k)).astype(np.int32)
    before = gather_rows.launches
    got = edgeconv.gather_neighbors(torch.from_numpy(feats), torch.from_numpy(idx))
    want = np.asarray(jax_gather_neighbors(jnp.asarray(feats), jnp.asarray(idx)))
    assert got.shape == (2, n, k, c)
    assert got.numpy().tobytes() == want.tobytes()
    assert gather_rows.launches == before
