"""Port packed kNN (dgcnn_tpu_torch.kernels.knn_packed) against the JAX
package on the CPU: the plain version against the interpreted
``knn_pallas(packed=True)`` (kernel ``_knn_kernel_packed``) on integer
inputs, where every score is exact in FP32 and the keys are bit-equal, at
13, 14 and 15 index bits and past them (the exact-kNN fallback); the
capped kNN's small-input fallback to it; and the split variant
(``knn_pallas(packed=True, splits=s)``, kernel
``_knn_kernel_packed_split``) with the TPU wrapper's routing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_pallas import knn_pallas
from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact_plain
from dgcnn_tpu_torch.kernels.knn_packed import (
    _knn_packed_split,
    knn_packed,
    knn_packed_plain,
    knn_packed_split_plain,
    packed_geometry,
    split_applies,
)


def _ints(seed, shape, hi=16):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.float32)


def _jax_packed(x, k, q=None, **kw):
    return np.asarray(knn_pallas(jnp.asarray(x), k, packed=True, interpret=True,
                                 queries=None if q is None else jnp.asarray(q), **kw))


@pytest.mark.parametrize("n, c, k", [(1500, 3, 20), (1111, 4, 7), (700, 64, 30)])
def test_plain_matches_jax_kernel_self(n, c, k):
    x = _ints(n + c, (2, n, c))
    want = _jax_packed(x, k)
    np.testing.assert_array_equal(knn_packed_plain(torch.from_numpy(x), k).numpy(), want)
    np.testing.assert_array_equal(knn_packed(torch.from_numpy(x), k).numpy(), want)


@pytest.mark.parametrize("n, bits", [
    (8192, 13),   # n_pad 8192: the widest 13-bit table
    (8193, 14),   # n_pad 8320
    (16500, 15),  # n_pad 16512
    (32768, 15),  # n_pad 32768: the widest packed table
])
def test_plain_matches_jax_kernel_at_index_widths(n, bits):
    """Queries against wide tables: the index field widens, the score
    field narrows, and the low bits must still be JAX's."""
    assert packed_geometry(n)[1] == bits
    x = _ints(n, (1, n, 3), hi=64)
    q = _ints(n + 1, (1, 40, 3), hi=64)
    want = _jax_packed(x, 16, q)
    got = knn_packed_plain(torch.from_numpy(x), 16, queries=torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_past_15_index_bits_is_the_exact_knn():
    x = _ints(5, (1, 33000, 3), hi=64)
    q = _ints(6, (1, 40, 3), hi=64)
    want = _jax_packed(x, 16, q)  # knn_pallas drops to the f32-exact kernel
    got = knn_packed(torch.from_numpy(x), 16, queries=torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, knn_exact_plain(torch.from_numpy(x), 16, queries=torch.from_numpy(q)).numpy())


def test_wrapper_on_cpu_honours_pred_and_launches_nothing():
    x = torch.from_numpy(_ints(3, (2, 900, 4)))
    before = knn_packed.launches
    assert torch.equal(knn_packed(x, 10), knn_packed_plain(x, 10))
    skipped = knn_packed(x, 10, queries=x[:, :50], pred=torch.tensor(False))
    assert skipped.shape == (2, 50, 10) and not skipped.any()
    assert knn_packed.launches == before


@pytest.mark.parametrize("queries", [False, True])
def test_capped_small_input_falls_back_to_packed(queries):
    """n_win * cap < k: knn_pallas(cap=8) drops to the flat packed kernel,
    on 128-row padding; so does the port's knn_capped, on either device."""
    x = _ints(11, (2, 200, 3))
    q = _ints(12, (2, 30, 3)) if queries else None
    tq = None if q is None else torch.from_numpy(q)
    want = _jax_packed(x, 20, q, cap=8)
    got = knn_capped(torch.from_numpy(x), 20, cap=8, queries=tq).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, knn_packed(torch.from_numpy(x), 20, queries=tq).numpy())


def test_validation():
    with pytest.raises(ValueError, match="exceeds"):
        knn_packed(torch.zeros(1, 4, 3), 8)
    with pytest.raises(ValueError, match="do not match"):
        knn_packed(torch.zeros(1, 40, 3), 8, queries=torch.zeros(1, 5, 4))
    with pytest.raises(ValueError, match="15 index bits"):
        knn_packed_plain(torch.zeros(1, 33000, 3), 8)


# ---------------------------------------------------------------- splits > 1
# Integers in [0, 64) with C=3-4: the dots stay exact in FP32, and the
# squared distances need more than 10 significant bits, so the split
# kernel's un-shifted 19-bit score keys select differently from the flat
# kernel's 18-bit ones on some rows.

@pytest.mark.parametrize("n, c, k, splits, with_queries", [
    (1500, 3, 20, 2, False),
    (1111, 4, 7, 4, True),
    (700, 4, 30, 8, False),
    (900, 3, 13, 4, True),
])
def test_split_plain_matches_jax_kernel(n, c, k, splits, with_queries):
    x = _ints(n + splits, (2, n, c), hi=64)
    q = _ints(n + 1, (2, 60, c), hi=64) if with_queries else None
    tq = None if q is None else torch.from_numpy(q)
    want = _jax_packed(x, k, q, splits=splits)
    tx = torch.from_numpy(x)
    assert split_applies(n, splits)
    before = _knn_packed_split.launches
    np.testing.assert_array_equal(knn_packed_split_plain(tx, k, queries=tq).numpy(), want)
    np.testing.assert_array_equal(knn_packed(tx, k, queries=tq, splits=splits).numpy(), want)
    assert _knn_packed_split.launches == before  # CPU: the plain version


def test_split_keys_are_not_the_flat_kernel_s():
    """The TPU docstrings call the split result identical to splits=1; it
    is only where distances fit the 18-bit keys. Here both packages'
    split results differ from both packages' flat results on some rows
    (sparse points: the 30 nearest lie past d^2 = 1024)."""
    x = _ints(40, (2, 256, 4), hi=64)
    tx = torch.from_numpy(x)
    split = knn_packed(tx, 30, splits=4).numpy()
    flat = knn_packed(tx, 30).numpy()
    np.testing.assert_array_equal(split, _jax_packed(x, 30, splits=4))
    np.testing.assert_array_equal(flat, _jax_packed(x, 30))
    assert (split != flat).any(axis=-1).sum() > 0


@pytest.mark.parametrize("n, splits, why", [
    (1000, 3, "n_pad 1024 % 3 != 0"),
    (8300, 2, "n_pad 8320 > 8192: splits = 1"),
    (600, 1, "splits 1"),
])
def test_split_routing_falls_back_to_the_flat_kernel(n, splits, why):
    x = _ints(n, (1, n, 3), hi=64)
    q = _ints(n + 2, (1, 40, 3), hi=64)
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    assert not split_applies(n, splits), why
    want = _jax_packed(x, 16, q, splits=splits)
    got = knn_packed(tx, 16, queries=tq, splits=splits).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, knn_packed_plain(tx, 16, queries=tq).numpy())


def test_split_wrapper_on_cpu_honours_pred():
    x = torch.from_numpy(_ints(3, (2, 900, 4), hi=64))
    skipped = knn_packed(x, 10, queries=x[:, :50], pred=torch.tensor(False), splits=2)
    assert skipped.shape == (2, 50, 10) and not skipped.any()
    assert torch.equal(knn_packed(x, 10, pred=torch.tensor(True), splits=2),
                       knn_packed_split_plain(x, 10))
    with pytest.raises(ValueError, match="n_pad <= 8192"):
        knn_packed_split_plain(torch.zeros(1, 8300, 3), 8)
