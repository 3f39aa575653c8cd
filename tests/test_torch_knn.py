"""Port kNN (dgcnn_tpu_torch) against the JAX package on the CPU: the
capped kernel's plain version against the interpreted Pallas kernel, and
the exact kNN against ops.knn."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_pallas import knn_pallas
from dgcnn_tpu.ops.knn import knn as jax_knn
from dgcnn_tpu_torch.kernels.knn_banded import probe_rows
from dgcnn_tpu_torch.kernels.knn_capped import knn_capped, knn_capped_plain
from dgcnn_tpu_torch.ops.knn import knn


def _ints(rng, shape, hi=16):
    # integer-valued coordinates: every dot and norm is exact in FP32, so
    # the two frameworks' sum orders cannot differ and ties are many
    return rng.integers(0, hi, shape).astype(np.float32)


def _jax_capped(x, k, **kw):
    return np.asarray(knn_pallas(jnp.asarray(x), k, packed=True, interpret=True, **kw))


@pytest.mark.parametrize("c", [3, 64])
def test_capped_matches_jax_kernel_integer(c):
    x = _ints(np.random.default_rng(c), (2, 1024, c))
    got = knn_capped(torch.from_numpy(x), 20, cap=8).numpy()
    # exact: also checks the order of tied neighbours
    np.testing.assert_array_equal(got, _jax_capped(x, 20, cap=8))


def test_capped_window128_matches_jax_kernel_integer():
    x = _ints(np.random.default_rng(7), (2, 300, 3))
    got = knn_capped(torch.from_numpy(x), 10, cap=8, window=128).numpy()
    np.testing.assert_array_equal(got, _jax_capped(x, 10, cap=8, window=128))


def test_capped_modular_cluster_overflow_matches_jax():
    """tests/test_knn_pallas.py's documented failure mode, on integer
    coordinates: cluster members share a residue class mod n_win, so they
    crowd one window and more than cap of a query's top-k are lost. The
    port must lose exactly what the TPU kernel loses."""
    n, k, window = 512, 12, 128
    n_win = n // window
    rng = np.random.default_rng(3)
    x = _ints(rng, (1, n, 3), hi=100)
    cluster = np.arange(1, 1 + n_win * (k + 4), n_win)
    x[0, cluster] = 50.0
    got = knn_capped(torch.from_numpy(x), k, cap=4, window=window).numpy()
    np.testing.assert_array_equal(got, _jax_capped(x, k, cap=4, window=window))
    q = int(cluster[0])
    assert len(set(got[0, q])) == k
    assert set(got[0, q, :4].tolist()) <= set(cluster.tolist())
    # the overflow really happened: the exact top-k is all cluster members
    exact = knn(torch.from_numpy(x), k).numpy()
    assert set(exact[0, q].tolist()) <= set(cluster.tolist())
    assert not set(got[0, q].tolist()) <= set(cluster.tolist())


@pytest.mark.parametrize("n, c, m, k", [
    (1024, 4, 200, 20),  # free queries
    (2048, 64, 64, 30),  # the recall guard's probes: stage A ...
    (2048, 64, 256, 30),  # ... and stage B, rows of probe_rows, window 256
])
def test_capped_queries_variant_matches_jax_kernel(n, c, m, k):
    rng = np.random.default_rng(11)
    x = _ints(rng, (2, n, c))
    if m in (64, 256):  # the probes are rows of the table itself
        q = x[:, probe_rows(n, m, torch.device("cpu")).numpy()]
    else:
        q = _ints(rng, (2, m, c))
    got = knn_capped(torch.from_numpy(x), k, cap=8,
                     queries=torch.from_numpy(q)).numpy()
    want = _jax_capped(x, k, cap=8, queries=jnp.asarray(q))
    assert got.shape == (2, m, k)
    np.testing.assert_array_equal(got, want)


def test_capped_small_n_uses_flat_packed_like_jax():
    """n_win*cap < k: the TPU wrapper falls back to the flat packed
    kernel; the port's CPU path takes the same selection."""
    x = _ints(np.random.default_rng(5), (2, 200, 3))
    got = knn_capped(torch.from_numpy(x), 20, cap=8).numpy()
    np.testing.assert_array_equal(got, _jax_capped(x, 20, cap=8))
    with pytest.raises(ValueError):
        knn_capped_plain(torch.from_numpy(x), 20, cap=8)


@pytest.mark.parametrize("c", [4, 64])
def test_capped_random_floats_agree_with_jax(c):
    x = np.random.default_rng(c).standard_normal((2, 1024, c)).astype(np.float32)
    if c == 4:
        x = np.stack([xi[np.argsort(xi[:, 0])] for xi in x])
    got = knn_capped(torch.from_numpy(x), 20, cap=8).numpy()
    # FP32 dot sum orders differ between the frameworks, which can move a
    # score across an 18-bit key boundary and swap near-tied neighbours
    assert (got == _jax_capped(x, 20, cap=8)).mean() >= 0.999


@pytest.mark.parametrize("chunk", [None, 256])
def test_exact_knn_matches_jax_integer(chunk):
    x = _ints(np.random.default_rng(9), (2, 700, 3))
    got = knn(torch.from_numpy(x), 16, query_chunk=chunk).numpy()
    want = np.asarray(jax_knn(jnp.asarray(x), 16, query_chunk=chunk))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_knn_rejects_bad_inputs():
    x = torch.zeros(1, 10, 3)
    with pytest.raises(ValueError):
        knn(x, 11)
    with pytest.raises(ValueError):
        knn_capped(x, 11)
    with pytest.raises(ValueError):
        knn_capped(x, 4, window=100)
    with pytest.raises(ValueError):
        knn_capped(x, 4, queries=torch.zeros(1, 5, 2))
