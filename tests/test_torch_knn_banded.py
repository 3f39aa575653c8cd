"""Port banded and exact kNN (dgcnn_tpu_torch) against the JAX package on
the CPU: the banded kernel's plain version against the interpreted Pallas
kernel (indices and k-th keys), the stage-1 wrapper ``knn_banded`` against
``knn_pallas_banded`` in the cases of tests/test_knn_banded.py, and the
exact kernel's plain version against ``knn_pallas(packed=False)``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_pallas import (
    _band_starts,
    _knn_banded_jit,
    knn_pallas,
    knn_pallas_banded,
)
from dgcnn_tpu_torch.kernels._build import KERNEL_WIDTHS
from dgcnn_tpu_torch.kernels.knn_banded import (
    SMEM_LIMIT,
    band_starts,
    default_query_tile,
    knn_banded,
    knn_banded_raw,
    knn_banded_raw_plain,
    launch_geometry,
    probe_rows,
    smem_bytes,
)
from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact, knn_exact_plain
from torch_port_helpers import sorted_blocks

BANDED = dict(band=512, n_win=16, cap=8, query_tile=128)


def sorted_cloud(rng, b, n, c, spans=(30, 4, 4, 4)):
    """tests/test_knn_banded.py's x-sorted integer cloud: every dot and
    norm is exact in FP32, so the two frameworks' keys are bit-equal."""
    cols = [rng.integers(0, spans[min(j, len(spans) - 1)] + 1, (b, n))
            for j in range(c)]
    x = np.stack(cols, axis=-1).astype(np.float32)
    order = np.argsort(x[..., 0], axis=1, kind="stable")
    return np.take_along_axis(x, order[..., None], axis=1)


def _port(fn, x, *a, **kw):
    return fn(torch.from_numpy(np.ascontiguousarray(x)), *a, **kw).numpy()


def _jax_banded(x, k, **kw):
    return np.asarray(knn_pallas_banded(jnp.asarray(x), k, interpret=True,
                                        **{**BANDED, **kw}))


@pytest.mark.parametrize("n, c, band, n_win, cap", [
    (1600, 4, 512, 16, 8),     # the JAX tests' banded geometry
    (1111, 3, 512, 16, 8),     # unaligned N: padding rows in the last band
    (1536, 8, 256, 64, 6),     # 4 rows per window < cap (the model's case)
])
def test_raw_plain_matches_jax_kernel_bits(n, c, band, n_win, cap):
    x = sorted_cloud(np.random.default_rng(n), 2, n, c)
    qt = 128
    want_idx, want_key = _knn_banded_jit(
        jnp.asarray(x), 8, band=band, n_win=n_win, cap=cap, query_tile=qt,
        interpret=True, hi_prec=True)
    idx, key = knn_banded_raw_plain(torch.from_numpy(x), 8, band=band,
                                    n_win=n_win, cap=cap, query_tile=qt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(key.numpy(), np.asarray(want_key))


@pytest.mark.parametrize("c, band, qt", [(64, 4096, 384), (4, 2048, 512)])
def test_raw_plain_matches_jax_kernel_at_the_production_windows(c, band, qt):
    """The default path's windows (64 of them, cap 6) at stages 2-3 (C=64,
    band 4096, query tile 384) and stage 1 (C=4, band 2048, tile 512)."""
    x = sorted_cloud(np.random.default_rng(c), 1, 4500, c)
    kw = dict(band=band, n_win=64, cap=6, query_tile=qt)
    want_idx, want_key = _knn_banded_jit(jnp.asarray(x), 30, interpret=True,
                                         hi_prec=True, **kw)
    idx, key = knn_banded_raw_plain(torch.from_numpy(x), 30, **kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(key.numpy(), np.asarray(want_key))


# (band, query tile) of the entry points (the model's bands 2048 / 4096
# and knn_banded's default 3072, at the wrappers' default tiles) and of the
# card tests (tests/test_torch_cuda.py::BANDED_CASES)
_ENTRY_TILES = [(b, default_query_tile(b)) for b in (2048, 3072, 4096)]
_TEST_TILES = [(2048, 512), (4096, 384), (512, 128), (1024, 32), (2048, 128),
               (1024, 384), (4096, 512), (256, 128), (1536, 256), (384, 384),
               (1024, 160), (1536, 384)]


@pytest.mark.parametrize("band, qt", _ENTRY_TILES + _TEST_TILES)
def test_launch_geometry_blocks_share_a_band_start(band, qt):
    """A block's queries must lie in one query tile (one band start)."""
    for cv in KERNEL_WIDTHS:
        for n_win in (16, 32, 64, 128):
            if band % n_win:
                continue
            for cap in (4, 6, 8):
                qb, jt, nbuf, two_phase = launch_geometry(cv, band, n_win, cap, qt)
                assert qt % qb == 0 and qb in (32, 64)
                assert jt >= 1 and nbuf in (1, 2) and two_phase in (0, 1)
                # the fused kernel takes 32-query blocks at C <= 8, the
                # two-phase kernel runs at C >= 16 only
                assert (qb == 32 and not two_phase) if cv <= 8 else True
                assert smem_bytes(cv, n_win, cap, qb, jt, nbuf, two_phase) <= SMEM_LIMIT


def test_launch_geometry_of_the_default_path():
    """Stages 2-3 take the two-phase kernel with 64-query blocks, stage 1
    the fused kernel with 32-query blocks and 16-j-step tiles."""
    assert launch_geometry(64, 4096, 64, 6, 384) == (64, 4, 1, 1)
    assert launch_geometry(4, 2048, 64, 6, 512) == (32, 16, 2, 0)


def _lane_kernel_smem(cv: int, n_win: int, cap: int) -> int:
    """The replaced kernel's shared memory (one query per lane, staging 16
    candidates of up to 8 windows, 32 queries' lists)."""
    rounds = -(-n_win // 8)
    nw = -(-n_win // rounds)
    return 4 * (16 * nw * cv + 16 * nw + 32 * (n_win * cap + 1))


def test_launch_geometry_fits_wherever_the_lane_kernel_did():
    """Every shape the replaced kernel (one query per lane) took, its
    shared memory within the limit, gets a geometry that fits too."""
    for cv in KERNEL_WIDTHS:
        for cap in (4, 6, 8):
            for n_win in range(1, 450):
                for band in (128 * n_win // np.gcd(128, n_win), 4096 // n_win * n_win):
                    if band < 128 or band % n_win or _lane_kernel_smem(cv, n_win, cap) > SMEM_LIMIT:
                        continue
                    g = launch_geometry(cv, band, n_win, cap, 384)
                    assert smem_bytes(cv, n_win, cap, *g) <= SMEM_LIMIT, (cv, cap, n_win, band, g)


def test_band_starts_match_jax():
    for args in ((1664, 128, 1664, 512), (7168, 512, 7040, 2048),
                 (7296, 384, 7040, 4096), (512, 256, 384, 256)):
        assert band_starts(*args) == _band_starts(*args)


def test_probe_rows_are_numpy_linspace():
    for n in (1, 5, 384, 1536, 7000):
        for s in (1, 2, 16, 64, 256):
            if s <= n:
                want = np.linspace(0, n - 1, s).round().astype(np.int64)
                np.testing.assert_array_equal(
                    probe_rows(n, s, torch.device("cpu")).numpy(), want)


def test_raw_wrapper_on_cpu_is_the_plain_version_and_honours_pred():
    x = torch.from_numpy(sorted_cloud(np.random.default_rng(2), 1, 1600, 4))
    before = knn_banded_raw.launches
    got = knn_banded_raw(x, 8, **BANDED)
    want = knn_banded_raw_plain(x, 8, **BANDED)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    skipped = knn_banded_raw(x, 8, pred=torch.tensor(False), **BANDED)
    assert not skipped[0].any() and not skipped[1].any()
    assert knn_banded_raw.launches == before  # no kernel on the CPU


def test_banded_matches_jax_on_sorted(rng):
    x = sorted_cloud(rng, 2, 1600, 4)
    np.testing.assert_array_equal(_port(knn_banded, x, 8, **BANDED),
                                  _jax_banded(x, 8))


def test_banded_unaligned_n_and_k(rng):
    x = sorted_cloud(rng, 1, 1111, 3)
    np.testing.assert_array_equal(_port(knn_banded, x, 7, **BANDED),
                                  _jax_banded(x, 7))


def test_banded_repair_matches_jax(rng):
    """Rows pushed far off in y fail the certificate; the port must repair
    exactly the rows JAX repairs, with the same exact answer."""
    x = sorted_cloud(rng, 1, 1600, 4)
    x[0, np.linspace(50, 1500, 12, dtype=int), 1] += 500.0
    before = knn_exact.launches
    got = _port(knn_banded, x, 8, **BANDED)
    np.testing.assert_array_equal(got, _jax_banded(x, 8))
    raw, _ = knn_banded_raw_plain(torch.from_numpy(x), 8, **BANDED)
    assert (raw.numpy() != got).any()  # the repair changed rows
    np.testing.assert_array_equal(got, _port(knn_exact_plain, x, 8))
    assert knn_exact.launches == before


def test_banded_unsorted_falls_back_to_capped(rng):
    x = rng.integers(0, 31, (1, 1600, 4)).astype(np.float32)  # not x-sorted
    got = _port(knn_banded, x, 8, **BANDED)
    np.testing.assert_array_equal(got, _jax_banded(x, 8))
    np.testing.assert_array_equal(got, _port(knn_capped, x, 8, cap=8))


def test_banded_budget_overflow_falls_back(rng):
    x = sorted_cloud(rng, 1, 1600, 4)
    x[..., 0] = 1.0  # every band edge at distance 0: every query fails
    got = _port(knn_banded, x, 8, repair_budget=64, **BANDED)
    np.testing.assert_array_equal(got, _jax_banded(x, 8, repair_budget=64))
    np.testing.assert_array_equal(got, _port(knn_capped, x, 8, cap=8))


def test_banded_small_input_uses_capped(rng):
    x = sorted_cloud(rng, 1, 300, 4)
    got = _port(knn_banded, x, 8, **BANDED)
    np.testing.assert_array_equal(got, _jax_banded(x, 8))
    np.testing.assert_array_equal(got, _port(knn_capped, x, 8, cap=8))


def test_banded_tie_order_matches_jax(rng):
    x = rng.integers(0, 6, (1, 800, 4)).astype(np.float32)
    x[..., 0] = np.sort(x[..., 0], axis=1)  # heavy duplicate ties
    np.testing.assert_array_equal(_port(knn_banded, x, 6, **BANDED),
                                  _jax_banded(x, 6))


def test_banded_at_the_model_geometry_agrees_on_floats():
    """Float x-sorted blocks at the default geometry (band 2048, 64 windows,
    cap 6): the two frameworks' FP32 sums may order a near-tie apart."""
    x = sorted_blocks(1, 3000, seed=6)
    kw = dict(band=2048, n_win=64, cap=6, capped_cap=8)
    got = _port(knn_banded, x, 30, **kw)
    want = np.asarray(knn_pallas_banded(jnp.asarray(x), 30, interpret=True, **kw))
    assert (got == want).mean() >= 0.999


def test_banded_validation():
    x = torch.zeros(1, 1600, 4)
    with pytest.raises(ValueError, match="band"):
        knn_banded(x, 8, band=500)
    with pytest.raises(ValueError, match="capacity"):
        knn_banded(x, 8, band=512, n_win=2, cap=3)
    with pytest.raises(ValueError, match="exceeds"):
        knn_banded(torch.zeros(1, 4, 3), 8)


@pytest.mark.parametrize("c", [3, 5, 64])
def test_exact_plain_matches_jax_kernel_self(c):
    x = np.random.default_rng(c).integers(0, 16, (2, 700, c)).astype(np.float32)
    want = np.asarray(knn_pallas(jnp.asarray(x), 12, packed=False, interpret=True))
    np.testing.assert_array_equal(_port(knn_exact_plain, x, 12), want)
    np.testing.assert_array_equal(_port(knn_exact, x, 12), want)


def test_exact_plain_matches_jax_kernel_queries():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 16, (2, 900, 4)).astype(np.float32)
    q = rng.integers(0, 16, (2, 70, 4)).astype(np.float32)
    want = np.asarray(knn_pallas(jnp.asarray(x), 10, packed=False,
                                 queries=jnp.asarray(q), interpret=True))
    got = knn_exact_plain(torch.from_numpy(x), 10, queries=torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    skipped = knn_exact(torch.from_numpy(x), 10, queries=torch.from_numpy(q),
                        pred=torch.tensor(False))
    assert skipped.shape == (2, 70, 10)


def test_capped_past_15_index_bits_is_the_exact_knn():
    """The capped wrapper's fallback past 15 index bits (n_pad > 32768) is
    the exact kNN on either device, as knn_pallas's."""
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, (1, 33000, 3)).astype(np.float32))
    q = x[:, :50]
    np.testing.assert_array_equal(
        knn_capped(x, 8, queries=q).numpy(),
        knn_exact_plain(x, 8, queries=q).numpy())
