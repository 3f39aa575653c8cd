"""Port parity-mode kNN (dgcnn_tpu_torch.kernels.knn_exact_banded) against
the JAX package on the CPU: the raw kernel's plain version against the
interpreted ``_knn_exact_jit`` (indices, k-th keys and overflow flags, bit
for bit), and the wrapper ``knn_exact_banded`` against ``knn_pallas_exact``
and the port's exact kNN (``ops/knn.py``) in each case of
tests/test_knn_exact.py.

Inputs are clouds on a 1/64 grid (tests/test_knn_exact.py:21-41): every
dot term and partial sum is exact in FP32, so the two frameworks' scores,
and so their keys, are bit-equal in any summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_pallas import _knn_exact_jit, knn_pallas_exact
from dgcnn_tpu_torch.kernels import knn_exact_banded as keb
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact
from dgcnn_tpu_torch.kernels.knn_exact_banded import (
    exact_query_tile,
    key_to_f32,
    knn_exact_banded,
    knn_exact_banded_raw,
    knn_exact_banded_raw_plain,
)
from dgcnn_tpu_torch.ops.knn import knn

EXACT = dict(band=512, n_win=16, cap=8, query_tile=128)
# the wrapper picks JAX's default query tile (512 rows here): a band of
# 1024 leaves each tile 256 rows of margin on either side, so sorted
# clouds stay on the banded path and only the sparse rows are repaired
WRAP = dict(band=1024, n_win=16, cap=8)


def grid_cloud(rng, b, n, c, spans=(30.0, 4.0, 4.0, 4.0), sort=True):
    """tests/test_knn_exact.py::sorted_float_cloud as numpy (unsorted with
    ``sort=False``)."""
    cols = [rng.uniform(0, spans[min(j, len(spans) - 1)], (b, n)) for j in range(c)]
    x = np.round(np.stack(cols, axis=-1).astype(np.float32) * 64.0) / 64.0
    if sort:
        order = np.argsort(x[..., 0], axis=1, kind="stable")
        x = np.take_along_axis(x, order[..., None], axis=1)
    return np.ascontiguousarray(x, np.float32)


def _both(x, k, **kw):
    """(port wrapper, JAX wrapper, port exact kNN) indices as numpy."""
    got = knn_exact_banded(torch.from_numpy(x), k, **kw).numpy()
    want = np.asarray(knn_pallas_exact(jnp.asarray(x), k, interpret=True, **kw))
    exact = knn(torch.from_numpy(x), k).numpy()
    return got, want, exact


def _assert_all_equal(x, k, **kw):
    got, want, exact = _both(x, k, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, exact)
    return got


@pytest.mark.parametrize("n, c, band, n_win, cap, qt, sort", [
    (1600, 4, 512, 16, 8, 128, True),     # the JAX tests' banded geometry
    (1111, 3, 512, 16, 8, 128, True),     # unaligned N: padding in the last band
    (1600, 4, 1664, 16, 8, 128, False),   # full width (band = n_pad), unsorted
    (1536, 8, 256, 64, 8, 128, True),     # 4 rows per window < cap: knocked-out slots
    (1600, 64, 1664, 64, 8, 256, False),  # the feature stages' geometry, C=64
    (1024, 3, 512, 16, 4, 128, True),     # cap 4: windows overflow on the grid
])
def test_raw_plain_matches_jax_kernel_bits(n, c, band, n_win, cap, qt, sort):
    x = grid_cloud(np.random.default_rng(n + c), 2, n, c, sort=sort)
    want = _knn_exact_jit(jnp.asarray(x), 8, band=band, n_win=n_win, cap=cap,
                          query_tile=qt, interpret=True)
    got = knn_exact_banded_raw_plain(torch.from_numpy(x), 8, band=band, n_win=n_win,
                                     cap=cap, query_tile=qt)
    for name, g, w in zip(("idx", "kth", "ovf"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_raw_plain_matches_jax_kernel_at_stage1_windows():
    """The parity forward's stage-1 windows: 64 windows of 32 rows under cap
    8 in a band of 2048, query tile 256, one sorted cloud of 4500 rows (its
    last band holds padding rows)."""
    x = grid_cloud(np.random.default_rng(4500), 1, 4500, 4)
    kw = dict(band=2048, n_win=64, cap=8, query_tile=256)
    want = _knn_exact_jit(jnp.asarray(x), 30, interpret=True, **kw)
    got = knn_exact_banded_raw_plain(torch.from_numpy(x), 30, **kw)
    for name, g, w in zip(("idx", "kth", "ovf"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_raw_overflow_flags_the_adversarial_window():
    """tests/test_knn_exact.py's residue-class cluster: rows r = 3 (mod
    n_win) hold every true neighbour of each other, more than cap=4 deep in
    one window, and the plain version flags them as JAX does."""
    n, n_win = 1600, 16
    x = np.zeros((1, n, 3), np.float32)
    x[0, :, 0] = np.arange(n) * 1e-3
    x[0, :, 1] = 100.0
    x[0, 3::n_win, 1] = 0.0
    kw = dict(band=512, n_win=n_win, cap=4, query_tile=128)
    want = _knn_exact_jit(jnp.asarray(x), 8, interpret=True, **kw)
    got = knn_exact_banded_raw_plain(torch.from_numpy(x), 8, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2][0, 3::n_win].all()


def test_raw_wrapper_on_cpu_is_the_plain_version_and_honours_flags():
    x = torch.from_numpy(grid_cloud(np.random.default_rng(2), 1, 1600, 4))
    before = knn_exact_banded_raw.launches
    got = knn_exact_banded_raw(x, 8, **EXACT)
    want = knn_exact_banded_raw_plain(x, 8, **EXACT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    full = knn_exact_banded_raw(x, 8, banded=torch.tensor(False), **EXACT)
    want_full = knn_exact_banded_raw_plain(x, 8, **{**EXACT, "band": 1664})
    assert all(torch.equal(g, w) for g, w in zip(full, want_full))
    skipped = knn_exact_banded_raw(x, 8, pred=torch.tensor(False), **EXACT)
    assert not any(t.any() for t in skipped)
    assert knn_exact_banded_raw.launches == before  # no kernel on the CPU


def test_key_to_f32_inverts_the_key():
    s = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 2.25, 7e20, np.inf],
                     dtype=torch.float32)
    np.testing.assert_array_equal(key_to_f32(keb._key(s)).numpy(),
                                  np.abs(s.numpy()) * np.sign(s.numpy()) + 0.0)
    keys = keb._key(s)
    assert (keys[1:] >= keys[:-1]).all()  # monotone


def test_query_tile_is_the_jax_wrappers():
    # 12 MiB of scratch: 256 rows at the production N=7000 (n_pad 7040)
    assert exact_query_tile(7040, 2048, 64, 8) == 256
    assert exact_query_tile(7040, 0, 64, 8) == 256
    assert exact_query_tile(1664, 512, 16, 8) == 512
    assert exact_query_tile(1024, 0, 64, 8) == 512
    assert exact_query_tile(384, 0, 16, 8) == 384
    assert exact_query_tile(50048, 2048, 64, 8) == 64


def test_exact_matches_jax_on_sorted(rng):
    _assert_all_equal(grid_cloud(rng, 2, 1600, 4), 8, **WRAP)


def test_exact_unaligned_n_and_k(rng):
    _assert_all_equal(grid_cloud(rng, 1, 1111, 3), 7, **WRAP)


def test_exact_unsorted_runs_full_width(rng):
    x = np.round(rng.uniform(0, 30, (2, 1600, 4)).astype(np.float32) * 64.0) / 64.0
    _assert_all_equal(x, 8, **WRAP)


def test_exact_band_zero_forces_full_width(rng):
    _assert_all_equal(grid_cloud(rng, 1, 1600, 4), 8, **{**WRAP, "band": 0})


def test_exact_tie_order_matches_top_k(rng):
    base = rng.integers(0, 6, (1, 800, 4)).astype(np.float32)
    base[..., 0] = np.sort(base[..., 0], axis=1)  # exact score ties everywhere
    _assert_all_equal(base, 6, **WRAP)


def test_exact_sparse_rows_repaired(rng):
    x = grid_cloud(rng, 1, 1600, 4)
    x[0, np.linspace(50, 1500, 12, dtype=int), 1] += 500.0
    before = knn_exact.launches
    got = _assert_all_equal(x, 8, **WRAP)
    raw, _, _ = knn_exact_banded_raw_plain(torch.from_numpy(x), 8, **WRAP, query_tile=512)
    assert (raw.numpy() != got).any()  # the repair changed rows
    assert knn_exact.launches == before  # the plain versions on the CPU


def test_exact_window_overflow_repaired(rng):
    n, n_win = 1600, 16
    x = np.zeros((1, n, 3), np.float32)
    x[0, :, 0] = np.arange(n) * 1e-3
    x[0, :, 1] = 100.0
    x[0, 3::n_win, 1] = 0.0
    _assert_all_equal(x, 8, band=512, n_win=n_win, cap=4)


def test_exact_budget_overflow_falls_back_flat(rng):
    x = grid_cloud(rng, 1, 1600, 4)
    x[..., 0] = 1.0  # every band edge at distance 0: every query fails
    _assert_all_equal(x, 8, repair_budget=64, **WRAP)


def test_exact_small_input_uses_flat(rng):
    _assert_all_equal(grid_cloud(rng, 1, 24, 4), 8, **WRAP)


def test_exact_band_narrower_than_query_tile(rng, monkeypatch):
    """band < the default 512-row query tile: the tile is clamped to the
    band (else every tile edge query would fail its certificate and the
    flat fallback would run on top of the banded pass)."""
    calls = []
    real = keb.knn_exact_banded_raw

    def spy(x, k, **kw):
        calls.append(dict(kw))
        return real(x, k, **kw)

    monkeypatch.setattr(keb, "knn_exact_banded_raw", spy)
    x = grid_cloud(rng, 1, 1600, 4)
    kw = dict(band=256, n_win=16, cap=8)
    _assert_all_equal(x, 8, **kw)
    assert calls and all(c["band"] == 256 and c["query_tile"] <= 256 for c in calls)


def test_exact_validation():
    x = torch.zeros(1, 1600, 4)
    with pytest.raises(ValueError, match="band"):
        knn_exact_banded(x, 8, band=500)
    with pytest.raises(ValueError, match="capacity"):
        knn_exact_banded(x, 8, band=512, n_win=2, cap=3)
    with pytest.raises(ValueError, match="exceeds"):
        knn_exact_banded(torch.zeros(1, 4, 3), 8)
