"""The capped kNN kernel's launch geometry and the exactness of its split,
on the CPU. ``launch_geometry`` is pure Python; the kernel
(``csrc/knn_capped.cu``) is held against the plain version on the card
(``tests/test_torch_cuda.py``). The split property is what the kernel's
grid rests on: a window's top-cap needs only that window's rows, so the
windows may be split over blocks (groups) and a window's rows over
threads (parts), and the merge of the pieces is the plain selection."""

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels.knn_capped import (
    MAX_GROUP,
    SMEM_LIMIT,
    TILE_ROWS,
    capped_geometry,
    knn_capped_plain,
    launch_geometry,
    smem_bytes,
)
from dgcnn_tpu_torch.kernels.knn_packed import packed_keys

WIDTHS = (4, 8, 16, 32, 64)


def _replaced_kernel_smem(cv: int, n_win: int, cap: int) -> int:
    """Shared memory of the kernel this one replaced (one query per lane):
    its staging of 16 rows per warp and its 32 x (n_win * cap + 1) winners."""
    rounds = -(-n_win // 8)
    nwarps = -(-n_win // rounds)
    return 4 * (16 * nwarps * cv + 16 * nwarps + 32 * (n_win * cap + 1))


def _valid(cv: int, n_win: int, geometry) -> None:
    """The launcher's checks (csrc/knn_capped.cu::launch)."""
    qb, g, jt, nbuf = geometry
    assert 1 <= g <= MAX_GROUP and g <= n_win
    if cv > 8:
        assert qb in (64, 32) and jt == TILE_ROWS // g and nbuf == 1
    else:
        assert qb % 4 == 0 and qb // 4 * g <= 256 and jt >= 1 and nbuf in (1, 2)


@pytest.mark.parametrize("cv", WIDTHS)
@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("window", [128, 256, 384, 1024])
def test_launch_geometry_fits_wherever_the_replaced_kernel_did(cv, cap, window):
    for n in (130, 1001, 4500, 7000, 16385, 30000, 32768):
        n_pad, n_win, idx_bits = capped_geometry(n, window)
        if idx_bits > 15 or n_win * cap < 30:
            continue  # the wrapper's fallbacks: no capped launch
        for b, m in ((1, 1), (8, 64), (8, 200), (1, 256), (8, 256), (1, n), (8, n)):
            g = launch_geometry(cv, b, m, n_pad, n_win, cap)
            _valid(cv, n_win, g)
            # every shape fits, those the replaced kernel launched among them
            assert smem_bytes(cv, n_win, cap, *g) <= SMEM_LIMIT


def test_launch_geometry_takes_what_the_replaced_kernel_could_not():
    # window 128 at N = 32768: 256 windows; the replaced kernel's winners
    # alone took 32 x 2049 ints a block, more than a Hopper block may take
    n_pad, n_win, _ = capped_geometry(32768, 128)
    assert _replaced_kernel_smem(64, n_win, 8) > SMEM_LIMIT
    g = launch_geometry(64, 1, 32768, n_pad, n_win, 8)
    assert g[1] < n_win and smem_bytes(64, n_win, 8, *g) <= SMEM_LIMIT


def test_launch_geometry_refuses_what_does_not_fit():
    n_pad, n_win, _ = capped_geometry(7000, 256)
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(256, 8, 7000, n_pad, n_win, 8)


def test_launch_geometry_of_the_production_shapes():
    n_pad, n_win, idx_bits = capped_geometry(7000, 256)
    assert (n_pad, n_win, idx_bits) == (7168, 28, 13)
    # self-kNN: one group of all 28 windows, merged in the block
    assert launch_geometry(64, 8, 7000, n_pad, n_win, 8) == (64, 28, 9, 1)
    assert launch_geometry(4, 8, 7000, n_pad, n_win, 8) == (36, 28, 32, 2)
    # the recall guard's probes: the windows split over the grid
    assert launch_geometry(64, 8, 64, n_pad, n_win, 8) == (64, 2, 128, 1)
    assert launch_geometry(64, 8, 256, n_pad, n_win, 8) == (64, 7, 36, 1)
    # one small cloud: its few query tiles split the windows too
    n_pad, n_win, _ = capped_geometry(1001, 256)
    assert launch_geometry(64, 1, 1001, n_pad, n_win, 8) == (64, 1, 256, 1)


def _split_selection(x, q, k, cap, window, groups, parts):
    """The capped selection as the kernel's grid takes it: per group of
    windows, per window the top-cap of each of ``parts`` interleaved row
    parts (j-steps p, p + parts, ...), those merged to the window's
    top-cap; then all windows' lists merged to the top-k."""
    b, n, _ = x.shape
    n_pad, n_win, idx_bits = capped_geometry(n, window)
    keys = packed_keys(x, q, n_pad, idx_bits)  # (B, M, n_pad)
    by_window = keys.view(b, q.shape[1], window, n_win)  # column w: window w
    lists = []
    for group in groups:
        for w in group:
            rows = by_window[..., w]  # (B, M, window): j-steps in order
            part_lists = [rows[..., p::parts].topk(min(cap, rows[..., p::parts].shape[-1]),
                                                   dim=-1).values for p in range(parts)]
            lists.append(torch.cat(part_lists, -1).topk(cap, dim=-1).values)
    top = torch.cat(lists, -1).topk(k, dim=-1).values
    return (n_pad - 1 - (top & ((1 << idx_bits) - 1))).to(torch.int32)


@pytest.mark.parametrize("seed", range(25))
def test_split_over_windows_and_rows_is_the_plain_selection(seed):
    """For random shapes, any partition of the windows into groups (in any
    order) and any number of row parts give the plain selection."""
    rng = np.random.default_rng(seed)
    n, c = int(rng.integers(300, 1501)), int(rng.choice([3, 4, 8]))
    window, cap, parts = int(rng.choice([128, 256])), int(rng.choice([4, 8])), int(rng.integers(1, 5))
    n_pad, n_win, _ = capped_geometry(n, window)
    k = min(n_win * cap, 20)
    order = rng.permutation(n_win)
    cuts = np.sort(rng.choice(np.arange(1, n_win), size=min(4, n_win - 1), replace=False))
    groups = [list(g) for g in np.split(order, cuts[: int(rng.integers(0, len(cuts) + 1))])]
    x = torch.from_numpy(rng.integers(0, 8, (2, n, c)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 8, (2, 37, c)).astype(np.float32))
    want = knn_capped_plain(x, k, cap=cap, window=window, queries=q)
    assert torch.equal(_split_selection(x, q, k, cap, window, groups, parts), want)
    # ties are many on these integers: the keys' low bits still order them
    assert torch.equal(_split_selection(x, x, k, cap, window, groups, parts),
                       knn_capped_plain(x, k, cap=cap, window=window))
