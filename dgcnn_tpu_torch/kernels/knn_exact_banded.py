"""The parity mode's kNN (``knn_impl="pallas"``): banded FP32-exact
selection, the Hopper kernel, its plain PyTorch version and the wrapper
that makes every result exact.

Counterparts of ``dgcnn_tpu/kernels/knn_pallas.py``:

* :func:`knn_exact_banded_raw` / :func:`knn_exact_banded_raw_plain` —
  ``_knn_exact_jit`` (kernel ``_knn_kernel_exact_banded``): each query tile
  of ``query_tile`` rows scores the ``band`` rows from its start
  (``knn_banded.band_starts``) by the FP32 score ``2 q·x_r - |x_r|^2``
  (no ``-|q|^2`` term), keyed by the order-exact monotone int32 of the
  score; in-band row ``r`` belongs to window ``r % n_win``; each window
  gives up its top-``cap`` (key, row) pairs, larger key first and the lower
  row among equal keys; the winners merge in the same order. Returns the
  indices, the k-th winner's key and the window-overflow flag;
* :func:`knn_exact_banded` — ``knn_pallas_exact``: the band-edge
  certificate in FP32 score space, the exact repair of the failing queries
  (``knn_exact``), the flat fallback; its indices are the exact kNN's on
  every input.

As in ``knn_banded.py`` every data-dependent decision of the JAX wrapper
(a ``lax.cond``) is a 0-d bool tensor on the input's device, handed to the
kernels that only one branch needs as their predicate, and the results are
combined with ``torch.where``: the wrapper never waits for the device. The
sortedness test picks the band on the device too: the kernel scans the
full padded table when its ``banded`` flag reads False, so one launch
serves both branches.

On a CUDA tensor the kernel (``csrc/knn_exact_banded.cu``) computes its
scores with the flat exact kernel's arithmetic (``csrc/knn_common.cuh``),
so the wrapper's indices equal :func:`knn_exact`'s on the card bit for bit,
whatever the input. Its block (:func:`launch_geometry`) is 32 queries at
C >= 16 (a two-phase kernel: the dots of a tile of 512 rows into a key
tile, then the insertions) and 16 at C <= 8 (a fused kernel: each thread
scores and inserts its own 4 queries' candidates of one window, tiles of
1024 rows); the band width is read on the device, so the one geometry
serves both widths of a launch.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.knn_banded import (
    _ROW_ALIGN,
    _query_starts,
    _round_up,
    _sorted_rows,
    band_starts,
    repair_queries,
)
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact

_KERNEL_CAPS = (4, 8)
_INT_MIN = -(2 ** 31)
SMEM_LIMIT = 232448  # shared memory a Hopper block may take (bytes)
QUERIES_PER_BLOCK = 32  # the two-phase kernel's block (C >= 16)
TILE_ROWS = 512  # its staged band rows a tile: 8 j-steps of 64 window slots
FUSED_QUERIES_PER_BLOCK = 16  # the fused kernel's block (C <= 8)
FUSED_TILE_ROWS = 1024  # its staged band rows a tile (two buffers): 16 j-steps
MAX_WINDOWS = 64  # window slots of a j-step
# the JAX wrapper's query tile halves while qt * (n_pad + 2 * cap * n_win)
# int32 words exceed the TPU kernel's 12 MiB scratch budget
# (knn_pallas.py::_DEFAULT_VMEM_MB). The CUDA kernel keeps no score tile,
# and the tile never changes the wrapper's indices (they are exact): it
# only moves the band starts, and is kept so that the band starts, and so
# which queries the certificate sends to the repair, are JAX's.
_TILE_BUDGET_BYTES = 12 * 2 ** 20


def _key(scores: torch.Tensor) -> torch.Tensor:
    """The order-exact monotone int32 of an FP32 score: ``where(bits >= 0,
    bits, INT_MIN - bits)``, overflow-free."""
    bits = scores.view(torch.int32)
    return torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))


def key_to_f32(key: torch.Tensor) -> torch.Tensor:
    """``_key_to_f32``: the FP32 score of a key (the transform is an
    involution on the bit pattern)."""
    k64 = key.to(torch.int64)
    bits = torch.where(k64 >= 0, k64, _INT_MIN - k64).to(torch.int32)
    return bits.view(torch.float32)


def launch_block(cv: int) -> int:
    """Queries a block of the kernel at width ``cv``: 16 (fused, C <= 8)
    or 32 (two-phase)."""
    return FUSED_QUERIES_PER_BLOCK if cv <= 8 else QUERIES_PER_BLOCK


def smem_bytes(cv: int, n_win: int, cap: int) -> int:
    """The kernel's shared memory, as ``csrc/knn_exact_banded.cu::smem_bytes``
    computes it: the staging or, if larger, the per-window lists that alias
    it (``cap + 1`` keys as int32 and rows as uint16 per query and window).
    The staging at C >= 16: the block's 32 queries and one tile of 512 rows,
    in rows of an odd float4 stride, the rows' norms, the key tile of 520
    ints a query; at C <= 8: two tiles of 1024 rows and their norms."""
    v = cv // 4
    xs4 = v if v % 2 else v + 1
    if cv <= 8:
        staging = 2 * FUSED_TILE_ROWS * (16 * xs4 + 4)
    else:
        staging = (16 * (QUERIES_PER_BLOCK + TILE_ROWS) * xs4 + 4 * TILE_ROWS
                   + 4 * QUERIES_PER_BLOCK * (TILE_ROWS + 8))
    return max(staging, 6 * launch_block(cv) * n_win * (cap + 1))


def launch_geometry(cv: int, n_win: int, cap: int, query_tile: int) -> int:
    """Queries a block of the kernel (:func:`launch_block`), the one
    geometry of a width. A block's queries share one band start, so the
    query tile must be a multiple of the block; the kernel takes multiples
    of 32, which every block divides. Raises ValueError for a shape the
    kernel does not take."""
    if query_tile % QUERIES_PER_BLOCK:
        raise ValueError(f"the CUDA kernel takes a query tile that is a multiple of "
                         f"{QUERIES_PER_BLOCK}, not {query_tile}")
    if n_win > MAX_WINDOWS:
        raise ValueError(f"the CUDA kernel takes n_win <= {MAX_WINDOWS}, not {n_win}")
    if smem_bytes(cv, n_win, cap) > SMEM_LIMIT:
        raise ValueError(f"the CUDA kernel cannot take C={cv}, n_win={n_win}, cap={cap}: "
                         f"{smem_bytes(cv, n_win, cap)} bytes of shared memory")
    return launch_block(cv)


def _check_raw(n: int, k: int, band: int, n_win: int, cap: int,
               query_tile: int) -> int:
    n_pad = _round_up(n, _ROW_ALIGN)
    if k > n:
        raise ValueError(f"k={k} exceeds number of points {n}")
    if band % n_win or band < _ROW_ALIGN or band > n_pad:
        raise ValueError(f"band {band} must be a multiple of n_win {n_win} in "
                         f"[128, {n_pad}]")
    if n_win * cap < k or band < k:
        raise ValueError(f"extraction capacity n_win*cap={n_win * cap} or "
                         f"band {band} < k={k}")
    if query_tile < 1:
        raise ValueError(f"query_tile {query_tile} must be positive")
    return n_pad


def knn_exact_banded_raw_plain(
    x: torch.Tensor, k: int, *, band: int, n_win: int, cap: int,
    query_tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact banded kernel in plain PyTorch: the same int32 keys, bit
    for bit, then ``torch.topk`` per window and for the merge over an int64
    (key, reversed row) composite, which orders ties by the lower row.
    Returns ``(idx (B, N, k) int32, kth_key (B, N) int32, ovf (B, N)
    int32)``."""
    b, n, _ = x.shape
    n_pad = _check_raw(n, k, band, n_win, cap, query_tile)
    qt = query_tile
    x = x.float()
    cn = (x * x).sum(-1)
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
    cnp = torch.nn.functional.pad(cn, (0, n_pad - n))
    w_sz = band // n_win
    keep = min(cap, w_sz)
    rev = (band - 1 - torch.arange(band, device=x.device)).to(torch.int64)
    idx_out, kth_out, ovf_out = [], [], []
    for i, s in enumerate(band_starts(_round_up(n, qt), qt, n_pad, band)):
        q = x[:, i * qt:(i + 1) * qt]
        scores = 2.0 * torch.matmul(q, xp[:, s:s + band].transpose(1, 2)) \
            - cnp[:, None, s:s + band]
        if s + band > n:  # the padding rows score -inf
            scores[..., n - s:] = float("-inf")
        key = _key(scores).to(torch.int64)
        comp = key * (1 << 32) + rev  # larger first: key desc, then row asc
        m = comp.shape[1]
        # (band,) -> (w_sz, n_win): column w is window w (r % n_win == w)
        per_win = comp.view(b, m, w_sz, n_win).topk(keep, dim=2).values
        if keep == cap:  # the cap-th winners, before the merge
            cap_max = (per_win[:, :, cap - 1] >> 32).amax(-1)
        else:  # short windows' last slots hold knocked-out INT_MIN keys
            cap_max = torch.full((b, m), _INT_MIN, dtype=torch.int64, device=x.device)
        top = per_win.reshape(b, m, keep * n_win).topk(k, dim=-1).values
        kth = top[..., k - 1] >> 32
        idx_out.append((s + band - 1 - (top & 0xFFFFFFFF)).to(torch.int32))
        kth_out.append(kth.to(torch.int32))
        ovf_out.append((cap_max >= kth).to(torch.int32))
    return (torch.cat(idx_out, dim=1), torch.cat(kth_out, dim=1),
            torch.cat(ovf_out, dim=1))


def knn_exact_banded_raw(
    x: torch.Tensor, k: int, *, band: int, n_win: int, cap: int,
    query_tile: int, pred: torch.Tensor | None = None,
    banded: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact banded self-kNN of ``x`` (B, N, C): ``(idx (B, N, k) int32,
    kth_key (B, N) int32, ovf (B, N) int32)``. Launches the CUDA kernel on a
    CUDA tensor (counted in ``knn_exact_banded_raw.launches``) and the plain
    version on a CPU tensor.

    ``banded``: an optional 0-d bool tensor; where it is False the scan is
    full width (``band`` = the padded row count). ``pred``: an optional 0-d
    bool tensor; where it is False no work is done and the result is
    undefined."""
    b, n, c = x.shape
    n_pad = _round_up(n, _ROW_ALIGN)
    if x.device.type == "cpu":
        if _build.skipped(pred):
            z = torch.zeros((b, n), dtype=torch.int32)
            return torch.zeros((b, n, k), dtype=torch.int32), z, z.clone()
        if banded is not None and not bool(banded):
            band = n_pad
        return knn_exact_banded_raw_plain(x, k, band=band, n_win=n_win, cap=cap,
                                          query_tile=query_tile)
    if x.device.type != "cuda":
        raise ValueError(f"knn_exact_banded_raw runs on cpu or cuda, not {x.device}")
    _check_raw(n, k, band, n_win, cap, query_tile)
    if banded is not None:
        _check_raw(n, k, n_pad, n_win, cap, query_tile)
    if cap not in _KERNEL_CAPS:
        raise ValueError(f"the CUDA kernel takes cap in {_KERNEL_CAPS}, not {cap}")
    if (n_pad if banded is not None else band) // n_win > 65536:
        raise ValueError("the CUDA kernel takes at most 65536 rows per window")
    if x.dtype != torch.float32:
        raise ValueError("x must be float32")
    cv = _build.kernel_width(c)
    launch_geometry(cv, n_win, cap, query_tile)
    cn = (x * x).sum(-1).contiguous()  # knn_exact's reduction, bit for bit
    if cv != c:
        x = torch.nn.functional.pad(x, (0, cv - c))
    x = x.contiguous()
    flag = _build.predicate(pred, x.device)
    sel = _build.predicate(banded, x.device)
    idx = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    kth = torch.empty((b, n), dtype=torch.int32, device=x.device)
    ovf = torch.empty((b, n), dtype=torch.int32, device=x.device)
    err = _build.lib().dgcnn_knn_exact_banded(
        x.data_ptr(), cn.data_ptr(), idx.data_ptr(), kth.data_ptr(),
        ovf.data_ptr(), None if flag is None else flag.data_ptr(),
        None if sel is None else sel.data_ptr(), b, n, cv, k, n_pad, band,
        n_win, cap, query_tile,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(err, "knn_exact_banded")
    knn_exact_banded_raw.launches += 1
    return idx, kth, ovf


knn_exact_banded_raw.launches = 0


def exact_query_tile(n_pad: int, band: int, n_win: int, cap: int) -> int:
    """``knn_pallas_exact``'s default query tile: 512 rows when ``band <=
    2048`` and 256 otherwise, halved (down to 64) while the TPU kernel's
    scratch of ``qt * (n_pad + 2 * cap * n_win)`` int32 words exceeds 12
    MiB, then clamped to the padded rows."""
    qt = 512 if max(band, 1) <= 2048 else 256
    scr_bytes = (n_pad + 2 * cap * n_win) * 4
    while qt > 64 and qt * scr_bytes > _TILE_BUDGET_BYTES:
        qt //= 2
    return min(qt, n_pad)


def knn_exact_banded(
    x: torch.Tensor, k: int, *, band: int = 2048, n_win: int = 64,
    cap: int = 8, repair_budget: int = 256,
) -> torch.Tensor:
    """Exact kNN of ``x`` (B, N, C), (B, N, k) int32, nearest first, ties
    to the lower row — the exact kNN's indices on every input — at banded
    speed. As ``knn_pallas_exact``:

    * on x-sorted rows (a device test) each query tile scores only ``band``
      rows, and each query is certified in FP32 score space against the
      band edge: its k-th score must exceed ``-gap^2 + |q|^2 + (max|q|^2 +
      |q|^2) * 2^-13``, ``gap`` the x distance to the nearest row outside
      its band;
    * on any rows the kernel's window-overflow flag certifies the
      per-window extraction; unsorted rows, and ``band=0`` (the feature
      stages), scan the full width;
    * queries failing either certificate are re-solved by :func:`knn_exact`
      (at most ``repair_budget`` per batch element, in ``lax.top_k``'s
      order over the fail flags); more failures in any element take the
      flat :func:`knn_exact` for the whole batch;
    * inputs too small to window (``n < 2k``, or too few rows per window)
      take the flat :func:`knn_exact` at once.

    The JAX wrapper falls back to the chunked XLA kNN where its query tile
    cannot fit the TPU kernel's scratch budget even at 64 rows; the CUDA
    kernel keeps no score tile, so that case has no counterpart here and
    runs the kernel at a 64-row tile."""
    b, n, c = x.shape
    if k > n:
        raise ValueError(f"k={k} exceeds number of points {n}")
    if band and (band % _ROW_ALIGN or band % n_win):
        raise ValueError("band must be a multiple of 128 and of n_win")
    if n_win * cap < k:
        raise ValueError(f"extraction capacity n_win*cap={n_win * cap} < k={k}")
    n_pad = _round_up(n, _ROW_ALIGN)
    x = x.detach().float()
    if n_pad % n_win or (n_pad // n_win) * cap < k or n < 2 * k:
        # too small to window: the flat kernel is cheap there anyway
        return knn_exact(x, k)
    qt = exact_query_tile(n_pad, band, n_win, cap)
    banded_ok = bool(band) and n_pad > band and band - (n_pad - n) >= k
    sorted_ok = None
    if banded_ok:
        # a tile wider than its band would leave its edge queries outside
        # their own band: every certificate would fail
        qt = min(qt, band)
        x0 = x[..., 0]
        sorted_ok = _sorted_rows(x0)
    idx, kth, ovf = knn_exact_banded_raw(
        x, k, band=band if banded_ok else n_pad, n_win=n_win, cap=cap,
        query_tile=qt, banded=sorted_ok)
    fail = ovf > 0
    if banded_ok:
        # an out-of-band row's FP32 score is at most -gap^2 + |q|^2 up to
        # rounding; the margin covers the rounding of the dot
        s_q = _query_starts(n, qt, n_pad, band, x.device)
        x_lo = x0[:, (s_q - 1).clamp(0, n - 1)]
        x_hi = x0[:, (s_q + band).clamp(0, n - 1)]
        inf = float("inf")
        d_lo, d_hi = x0 - x_lo, x_hi - x0
        bound_lo = torch.where(s_q > 0, d_lo * d_lo, inf)
        bound_hi = torch.where(s_q + band < n, d_hi * d_hi, inf)
        gap2 = torch.minimum(bound_lo, bound_hi)
        qnorm = (x * x).sum(-1)
        margin = (qnorm.amax(1, keepdim=True) + qnorm) * (2.0 ** -13)
        cert = key_to_f32(kth) > (-gap2 + qnorm + margin)
        fail = fail | (sorted_ok & ~cert)
    r_budget = min(repair_budget, n)
    within = (fail.sum(1) <= r_budget).all()
    repaired = repair_queries(x, k, idx, fail, r_budget, pred=within & fail.any())
    flat = knn_exact(x, k, pred=~within)
    return torch.where(within, repaired, flat)
