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
    score_bound,
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


def _monotone(scores: np.ndarray) -> np.ndarray:
    """The order-exact int32 of FP32 scores (knn_common.cuh::score_key)."""
    bits = scores.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))


def _packed(scores, rows, n_pad, idx_bits, shift):
    """The packed keys (int64 values of the int32 keys) of scores at rows."""
    keep = ~((1 << idx_bits) - 1)
    return ((_monotone(scores) >> shift) & keep) | (n_pad - 1 - rows)


def _probe_scores(rng) -> np.ndarray:
    """FP32 scores of every kind the fused kernel meets: recentred squared
    distances (negative) and their ties, positive scores large and small,
    the two zeros, subnormals, the extremes, -inf, +inf and NaN, and each
    one's neighbours by one unit in the last place."""
    base = np.concatenate([
        -rng.gamma(2.0, 3.0, 3000), rng.normal(0, 50, 1000), rng.uniform(0, 4, 500),
        -rng.uniform(0, 1e-3, 500), np.repeat(-rng.uniform(0, 10, 50), 8),  # ties
        [0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 3.4e38, -3.4e38, -np.inf, np.inf, np.nan],
    ]).astype(np.float32)
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])


@pytest.mark.parametrize("shift, idx_bits", [(0, 13), (1, 13), (1, 14), (1, 15)])
def test_score_bound_drops_no_score_whose_key_beats_the_kth(shift, idx_bits):
    """The fused kernel's float prefilter (``score_bound``, split key shift
    0 with its 13 index bits, flat key shift 1 at 13-15): a score below the
    bound of the k-th key so far never has a key above it, for k-th keys
    drawn from real scores (ties, both signs, zeros, subnormals, -inf,
    +inf, NaN) and the empty list's INT_MIN, on those scores and on the
    bound itself and its neighbours (at row 0: the largest index label);
    NaN scores pass every bound. And the bound is tight: a score whose
    key's score bits equal the k-th key's is never dropped."""
    rng = np.random.default_rng(shift * 16 + idx_bits)
    n_pad = 1 << idx_bits
    scores = _probe_scores(rng)
    rows = rng.integers(0, n_pad, scores.size)
    keys = _packed(scores, rows, n_pad, idx_bits, shift)
    keep = ~((1 << idx_bits) - 1)
    kths = [-(1 << 31), *rng.choice(keys, 600, replace=False).tolist(),
            *keys[np.isin(scores, scores[-33:]) | ~np.isfinite(scores)].tolist()]
    for kth in kths:
        bound = score_bound(int(kth), keep, shift)
        edge = np.array([bound, np.nextafter(bound, np.float32(np.inf)),
                         np.nextafter(bound, np.float32(-np.inf))], np.float32)
        probe = np.concatenate([scores, edge])
        pkeys = np.concatenate([keys, _packed(edge, np.zeros(3, np.int64), n_pad, idx_bits,
                                              shift)])
        with np.errstate(invalid="ignore"):
            dropped = probe < bound
        assert not (dropped & (pkeys > kth)).any(), (kth, bound)
        assert not (dropped & ((pkeys & keep) == (kth & keep))).any(), (kth, bound)
        assert not dropped[np.isnan(probe)].any()
    assert np.isneginf(score_bound(-(1 << 31), keep, shift))
