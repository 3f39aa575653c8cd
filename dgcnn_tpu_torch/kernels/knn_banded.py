"""Banded kNN over x-sorted rows: the Hopper kernel, its plain PyTorch
version, and the two wrappers that make it safe to use.

Counterparts of ``dgcnn_tpu/kernels/knn_pallas.py``:

* :func:`knn_banded_raw` / :func:`knn_banded_raw_plain` — ``_knn_banded_jit``
  (kernel ``_knn_kernel_banded``): each query tile of ``query_tile`` rows
  scores only the ``band`` rows from its start (:func:`band_starts`), with
  the capped kernel's packed keys (low bits ``band - 1 - r``, r the row in
  the band) and per-window top-``cap`` (window ``r % n_win``), and returns
  the indices and the k-th winner's packed key;
* :func:`knn_banded` — ``knn_pallas_banded``, the stage-1 (coordinate)
  kNN: certifies each query against the sorted-order band-edge bound and
  repairs the failures FP32-exactly (``knn_exact``), falling back to the
  capped kNN on unsorted input, small input, or too many failures;
* :func:`knn_feature_banded` — ``knn_pallas_feature_banded``, the stage-2/3
  (feature) kNN: uncertified, defended by the sampled-recall guard, whose
  probes are the capped kernel's ``queries=`` variant.

The JAX wrappers take every data-dependent decision on the device with
``lax.cond``. Here each decision is a 0-d bool tensor on the input's
device: every kernel that only one branch needs takes it as a predicate
(its blocks return at once when it is False) and the results are combined
with ``torch.where``. So the forward never waits for the device, and a
branch not taken costs a launch, not its work. On the CPU the plain
versions read the predicate and skip the work.

``query_tile`` is part of the result (it sets the band starts): as in the
JAX wrappers, 512 rows when ``band <= 2048``, else 384 (the JAX package's
off-TPU default tile), clamped to the band.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact

_KERNEL_CAPS = (4, 6, 8)
_ROW_ALIGN = 128  # rows are padded, and bands start, at multiples of this
_SLOTS = 64  # the kernel's windows per round: the rows of one j-step
_TILE_ROWS = 4 * _SLOTS  # the two-phase kernel's tile: 4 j-steps
SMEM_LIMIT = 232448  # shared memory a Hopper block may take (bytes)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def default_query_tile(band: int) -> int:
    """The JAX wrappers' query tile for ``band`` (clamped to the band)."""
    return min(512 if band <= 2048 else 384, band)


def band_starts(n_q_pad: int, qt: int, n_pad: int, band: int) -> list[int]:
    """``_band_starts``: the first band row of each query tile — the tile's
    centre minus half a band, floored to a multiple of 128 and clipped to
    ``[0, n_pad - band]``."""
    starts = []
    for i in range(n_q_pad // qt):
        raw = i * qt + qt // 2 - band // 2
        raw = (raw // _ROW_ALIGN) * _ROW_ALIGN
        starts.append(int(np.clip(raw, 0, n_pad - band)))
    return starts


def _query_starts(n: int, qt: int, n_pad: int, band: int,
                  device: torch.device) -> torch.Tensor:
    """(n,) int64: :func:`band_starts` of each query's tile, computed on
    ``device`` (a host array would need a copy, which waits for the
    device)."""
    raw = torch.arange(n, device=device) // qt * qt + (qt // 2 - band // 2)
    raw = torch.div(raw, _ROW_ALIGN, rounding_mode="floor") * _ROW_ALIGN
    return raw.clamp(0, n_pad - band)


def _key(scores: torch.Tensor) -> torch.Tensor:
    """The monotone int32 of an FP32 score, shifted right by one:
    ``where(bits >= 0, bits, INT_MIN - bits) >> 1``, overflow-free."""
    bits = scores.view(torch.int32)
    return torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF)) >> 1


def _check_raw(n: int, k: int, band: int, n_win: int, query_tile: int) -> int:
    n_pad = _round_up(n, _ROW_ALIGN)
    if k > n:
        raise ValueError(f"k={k} exceeds number of points {n}")
    if band % n_win or band < _ROW_ALIGN:
        raise ValueError(f"band {band} must be a multiple of n_win {n_win} and >= 128")
    if n_pad < band:
        raise ValueError(f"band {band} exceeds the padded rows {n_pad}")
    if query_tile < 1:
        raise ValueError(f"query_tile {query_tile} must be positive")
    return n_pad


def _row_stride4(cv: int) -> int:
    """A staged row's stride in float4 (odd: conflict-free 16-byte reads)."""
    v = cv // 4
    return v if v % 2 else v + 1


def smem_bytes(cv: int, n_win: int, cap: int, qb: int, jt: int, nbuf: int,
               two_phase: int) -> int:
    """The kernel's shared memory for a launch geometry, as
    ``csrc/knn_banded.cu::smem_bytes`` computes it: the staging (two-phase:
    the queries, one tile of 256 rows, their norms and the key tile; fused:
    the queries at C >= 16, ``nbuf`` tiles of ``jt`` j-steps of 64 rows and
    their norms) and the per-window lists (``cap`` keys per query and
    window), which with one round of windows (``n_win <= 64``) alias the
    staging and end in a sentinel each."""
    xs4 = _row_stride4(cv)
    if two_phase:
        staging = 16 * (qb + _TILE_ROWS) * xs4 + 4 * _TILE_ROWS + 4 * qb * (_TILE_ROWS + 8)
    else:
        rows = jt * _SLOTS
        staging = 16 * ((0 if cv <= 8 else qb * xs4) + nbuf * rows * xs4) + 4 * nbuf * rows
    if n_win <= _SLOTS:
        return max(staging, 4 * qb * n_win * (cap + 1))
    return staging + 4 * qb * n_win * cap


def launch_geometry(cv: int, band: int, n_win: int, cap: int,
                    query_tile: int) -> tuple[int, int, int, int]:
    """``(qb, jt, nbuf, two_phase)`` of a kernel launch: queries per block
    (a block's queries share one band start, so ``qb`` divides the query
    tile), j-steps per staged tile, tile buffers, and which kernel. At C >=
    16 the two-phase kernel (tiles of 4 j-steps, one buffer), with 64
    queries where they divide the query tile, else 32. At C <= 8 the fused
    kernel with 32 queries and 16 j-steps, double-buffered unless one tile
    holds the band: the fastest on the H100 at the default path's two
    shapes (``scripts/torch_knn_banded.py --variants``). Where the shared
    memory would exceed :data:`SMEM_LIMIT`: 32 queries, then the fused
    kernel with 32 queries and one j-step, then one buffer: less than the
    kernel this one replaced (one query per lane) took for the same shape."""
    w_sz = band // n_win
    if cv > 8:
        qb = 64 if query_tile % 64 == 0 else 32
        tries = [(qb, 4, 1, 1), (32, 4, 1, 1)]
    else:
        jt = min(w_sz, 16)
        tries = [(32, jt, 1 if jt == w_sz else 2, 0)]
    for g in tries + [(32, 1, 2, 0), (32, 1, 1, 0)]:
        if smem_bytes(cv, n_win, cap, *g) <= SMEM_LIMIT:
            return g
    return 32, 1, 1, 0  # too large for any geometry: the launch reports it


def knn_banded_raw_plain(
    x: torch.Tensor, k: int, *, band: int, n_win: int, cap: int,
    query_tile: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The banded kernel in plain PyTorch: the same packed keys, bit for
    bit in int32, then ``torch.topk`` per window (of ``min(cap, rows per
    window)``: the TPU kernel's extra extractions repeat keys) and for the
    merge (keys are unique within a band). Returns ``(idx (B, N, k) int32,
    kth_key (B, N) int32)``."""
    b, n, _ = x.shape
    n_pad = _check_raw(n, k, band, n_win, query_tile)
    qt = query_tile
    idx_bits = (band - 1).bit_length()
    imask = (1 << idx_bits) - 1
    x = x.float()
    cn = (x * x).sum(-1)
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
    cnp = torch.nn.functional.pad(cn, (0, n_pad - n))
    w_sz = band // n_win
    keep = min(cap, w_sz)
    low = (band - 1 - torch.arange(band, device=x.device)).to(torch.int32)
    idx_out, key_out = [], []
    for i, s in enumerate(band_starts(_round_up(n, qt), qt, n_pad, band)):
        q, qn = x[:, i * qt:(i + 1) * qt], cn[:, i * qt:(i + 1) * qt]
        m = q.shape[1]
        scores = (2.0 * torch.matmul(q, xp[:, s:s + band].transpose(1, 2))
                  - cnp[:, None, s:s + band]) - qn[..., None]
        if s + band > n:  # the padding rows score -inf
            scores[..., n - s:] = float("-inf")
        packed = (_key(scores) & ~imask) | low
        # (band,) -> (w_sz, n_win): column w is window w (r % n_win == w)
        per_win = packed.view(b, m, w_sz, n_win).topk(keep, dim=2).values
        top = per_win.reshape(b, m, keep * n_win).topk(k, dim=-1).values
        idx_out.append((s + band - 1 - (top & imask)).to(torch.int32))
        key_out.append(top[..., k - 1])
    return torch.cat(idx_out, dim=1), torch.cat(key_out, dim=1)


def knn_banded_raw(
    x: torch.Tensor, k: int, *, band: int, n_win: int, cap: int,
    query_tile: int, pred: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded self-kNN of ``x`` (B, N, C): ``(idx (B, N, k) int32, kth_key
    (B, N) int32)``. Launches the CUDA kernel on a CUDA tensor (counted in
    ``knn_banded_raw.launches``) and the plain version on a CPU tensor.
    ``pred``: an optional 0-d bool tensor; where it is False no work is
    done and the result is undefined.

    On an NVIDIA H100 80GB HBM3 at 700 W, B=8, N=7000, k=30, 64 windows,
    cap 6, the kernel alone (device-only, ``scripts/torch_knn_banded.py``)
    takes 1.170-1.172 ms at C=64, band 4096 (the two-phase kernel) and
    0.2017-0.2019 ms at C=4, band 2048 (the fused one); through this
    wrapper, with its norm reduction, 1.196 and 0.208-0.209 ms."""
    b, n, c = x.shape
    _check_raw(n, k, band, n_win, query_tile)
    if x.device.type == "cpu":
        if _build.skipped(pred):
            return (torch.zeros((b, n, k), dtype=torch.int32),
                    torch.zeros((b, n), dtype=torch.int32))
        return knn_banded_raw_plain(x, k, band=band, n_win=n_win, cap=cap,
                                    query_tile=query_tile)
    if x.device.type != "cuda":
        raise ValueError(f"knn_banded_raw runs on cpu or cuda, not {x.device}")
    if cap not in _KERNEL_CAPS:
        raise ValueError(f"the CUDA kernel takes cap in {_KERNEL_CAPS}, not {cap}")
    if query_tile % 32:
        raise ValueError(f"the CUDA kernel takes a query tile that is a multiple of 32, not {query_tile}")
    cv = _build.kernel_width(c)
    if x.dtype != torch.float32:
        raise ValueError("x must be float32")
    cn = (x * x).sum(-1).contiguous()  # the plain version's reduction
    if cv != c:
        x = torch.nn.functional.pad(x, (0, cv - c))
    return launch_kernel(x.contiguous(), cn, k, band=band, n_win=n_win, cap=cap,
                         query_tile=query_tile,
                         geometry=launch_geometry(cv, band, n_win, cap, query_tile),
                         pred=pred)


def launch_kernel(
    x: torch.Tensor, cn: torch.Tensor, k: int, *, band: int, n_win: int,
    cap: int, query_tile: int, geometry: tuple[int, int, int, int],
    pred: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on prepared CUDA tensors: ``x`` (B, N, cv)
    contiguous and zero-padded to a kernel width, ``cn`` (B, N) its row
    norms; ``geometry`` as :func:`launch_geometry` returns it. Counted in
    ``knn_banded_raw.launches``. ``k`` = 0 runs the scan without the
    merge (``scripts/torch_knn_banded.py`` times the merge's share so)."""
    b, n, cv = x.shape
    flag = _build.predicate(pred, x.device)
    idx = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    kth = torch.empty((b, n), dtype=torch.int32, device=x.device)
    err = _build.lib().dgcnn_knn_banded(
        x.data_ptr(), cn.data_ptr(), idx.data_ptr(), kth.data_ptr(),
        None if flag is None else flag.data_ptr(), b, n, cv, k,
        _round_up(n, _ROW_ALIGN), band, n_win, cap, query_tile,
        (band - 1).bit_length(), *geometry,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(err, "knn_banded")
    knn_banded_raw.launches += 1
    return idx, kth


knn_banded_raw.launches = 0


def _check_wrapper(n: int, k: int, band: int, n_win: int, cap: int) -> None:
    if k > n:
        raise ValueError(f"k={k} exceeds number of points {n}")
    if band % 256 or band % n_win:
        raise ValueError("band must be a multiple of 256 and of n_win")
    if n_win * cap < k:
        raise ValueError(f"extraction capacity n_win*cap={n_win * cap} < k={k}")


def _too_small(n: int, k: int, band: int) -> bool:
    """Nothing to band (or too few real rows per band): the wrappers use
    the capped kNN."""
    n_pad = _round_up(n, _ROW_ALIGN)
    return n_pad <= band or band - (n_pad - n) < k


def _sorted_rows(x0: torch.Tensor) -> torch.Tensor:
    """0-d bool: every batch element's column is non-decreasing."""
    return (x0[:, 1:] >= x0[:, :-1]).all()


def knn_banded(
    x: torch.Tensor, k: int, *, band: int = 3072, n_win: int = 32,
    cap: int = 8, capped_cap: int | None = None, repair_budget: int = 256,
    query_tile: int | None = None,
) -> torch.Tensor:
    """Stage-1 (coordinate) kNN of ``x`` (B, N, C) exploiting x-sorted
    rows; (B, N, k) int32. As ``knn_pallas_banded``:

    * scores only ``band`` rows around each query tile;
    * certifies each query: its k-th winner's key must beat the packed
      key of the band-edge bound ``-min((x_q - x_lo)^2, (x_hi - x_q)^2)``
      by one quantum (x sorted, so every row outside the band is at least
      that far);
    * re-solves the failing queries FP32-exactly with :func:`knn_exact`,
      at most ``repair_budget`` per batch element, ordered as ``lax.top_k``
      over the fail flags orders them (failing rows ascending, then the
      rest ascending);
    * falls back to the capped kNN (cap ``capped_cap``, default ``cap``)
      when the rows are not x-sorted, when any element has more failures
      than the budget, or when the input is too small to band.
    """
    b, n, c = x.shape
    _check_wrapper(n, k, band, n_win, cap)
    full_cap = cap if capped_cap is None else capped_cap
    if _too_small(n, k, band):
        return knn_capped(x, k, cap=full_cap)
    qt = min(default_query_tile(band) if query_tile is None else query_tile, band)
    x = x.float()
    n_pad = _round_up(n, _ROW_ALIGN)
    x0 = x[..., 0]
    sorted_ok = _sorted_rows(x0)
    idx, keys = knn_banded_raw(x, k, band=band, n_win=n_win, cap=cap,
                               query_tile=qt, pred=sorted_ok)

    idx_bits = (band - 1).bit_length()
    imask = (1 << idx_bits) - 1
    s_q = _query_starts(n, qt, n_pad, band, x.device)
    x_lo = x0[:, (s_q - 1).clamp(0, n - 1)]
    x_hi = x0[:, (s_q + band).clamp(0, n - 1)]
    inf = float("inf")
    d_lo, d_hi = x0 - x_lo, x_hi - x0
    bound_lo = torch.where(s_q > 0, d_lo * d_lo, inf)
    bound_hi = torch.where(s_q + band < n, d_hi * d_hi, inf)
    s_edge = -torch.minimum(bound_lo, bound_hi)
    key_edge = _key(s_edge)
    # floor-quantized compare with a one-quantum margin: quantization can
    # only add repairs, never hide one
    fail = (keys & ~imask) < ((key_edge & ~imask) + (1 << idx_bits))
    r_budget = min(repair_budget, n)
    use_band = sorted_ok & (fail.sum(1) <= r_budget).all()
    repaired = repair_queries(x, k, idx, fail, r_budget, pred=use_band & fail.any())
    capped = knn_capped(x, k, cap=full_cap, pred=~use_band)
    return torch.where(use_band, repaired, capped)


def repair_queries(x: torch.Tensor, k: int, idx: torch.Tensor,
                   fail: torch.Tensor, r_budget: int,
                   pred: torch.Tensor) -> torch.Tensor:
    """``idx`` (B, N, k) with the rows where ``fail`` (B, N) re-solved by
    :func:`knn_exact`: the first ``r_budget`` rows of each batch element in
    ``lax.top_k``'s order over the fail flags (failing rows ascending, then
    the rest ascending), so at most ``r_budget`` failing rows per element.
    ``pred``: the exact kernel's predicate (the caller's decision that the
    repair is needed and taken)."""
    b, n, c = x.shape
    # a row's rank is its count among its own group
    f = fail.to(torch.int64)
    rank = torch.where(fail, f.cumsum(1) - 1,
                       f.sum(1, keepdim=True) + (1 - f).cumsum(1) - 1)
    order = torch.empty_like(rank).scatter_(
        1, rank, torch.arange(n, device=x.device).expand(b, n))
    pos = order[:, :r_budget]
    # the rows as the kernel's hint: it visits each query's neighbourhood first
    rep = knn_exact(x, k, queries=x.gather(1, pos[..., None].expand(-1, -1, c)),
                    pred=pred, query_rows=pos)
    rows = pos[..., None].expand(-1, -1, k)
    new = torch.where(fail.gather(1, pos)[..., None], rep, idx.gather(1, rows))
    return idx.scatter(1, rows, new)


def probe_rows(n: int, s: int, device: torch.device) -> torch.Tensor:
    """(s,) int64 rows ``np.linspace(0, n - 1, s).round()``, computed on
    ``device`` with numpy's float64 arithmetic (``i * step``, the last row
    exactly ``n - 1``, round half to even)."""
    i = torch.arange(s, dtype=torch.float64, device=device)
    if s == 1:
        return i.to(torch.int64)
    y = torch.where(i == s - 1, float(n - 1), i * ((n - 1) / (s - 1)))
    return torch.round(y).to(torch.int64)


def knn_feature_banded(
    x: torch.Tensor, k: int, *, sorted_ok: torch.Tensor, band: int = 4096,
    n_win: int = 32, cap: int = 8, capped_cap: int | None = None,
    query_tile: int | None = None, recall_guard: int = 256,
    recall_threshold: float = 0.995, guard_ok: bool | None = None,
    with_flag: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Stage-2/3 (feature) kNN of ``x`` (B, N, C) over spatially ordered
    rows, banded and uncertified, as ``knn_pallas_feature_banded``.

    ``sorted_ok``: 0-d bool tensor, whether the underlying POINTS are
    x-sorted (the feature table cannot tell); False takes the capped kNN.

    The recall guard: ``recall_guard`` probe rows (``probe_rows``) are
    re-solved with the capped kernel's ``queries=`` variant and the share
    of their neighbours found in the banded result (one float32 mean over
    B·S·k) decides. Stage A probes 64 rows and keeps the band when recall
    is at least ``1 - (1 - recall_threshold) / 2``; otherwise stage B
    probes all ``recall_guard`` rows and keeps the band at
    ``recall_threshold``, else falls back to the capped kNN (a trip).
    ``guard_ok`` (host bool): False skips the probes and keeps the band;
    None guards this call. ``with_flag`` returns ``(idx, tripped)``,
    ``tripped`` a 0-d bool tensor, True iff the guard measured recall
    below the threshold and fell back (unsorted or small input is not a
    trip)."""
    b, n, c = x.shape
    _check_wrapper(n, k, band, n_win, cap)
    full_cap = cap if capped_cap is None else capped_cap
    no_trip = torch.zeros((), dtype=torch.bool, device=x.device)
    if _too_small(n, k, band):
        idx = knn_capped(x, k, cap=full_cap)
        return (idx, no_trip) if with_flag else idx
    qt = min(default_query_tile(band) if query_tile is None else query_tile, band)
    x = x.float()
    if not isinstance(sorted_ok, torch.Tensor):
        sorted_ok = torch.full((), bool(sorted_ok), device=x.device)
    idx, _ = knn_banded_raw(x, k, band=band, n_win=n_win, cap=cap,
                            query_tile=qt, pred=sorted_ok)
    tripped = no_trip
    if recall_guard and guard_ok is not False:
        s = min(recall_guard, n)

        def recall(s_probe: int, pred: torch.Tensor) -> torch.Tensor:
            rows = probe_rows(n, s_probe, x.device)
            ref = knn_capped(x, k, cap=full_cap, queries=x[:, rows], pred=pred)
            hit = (ref[..., :, None] == idx[:, rows][..., None, :]).any(-1)
            return hit.to(torch.float32).mean()

        thr = float(np.float32(recall_threshold))
        s0 = min(64, s)
        if s0 >= s:  # small guard: one stage
            tripped = sorted_ok & ~(recall(s, sorted_ok) >= thr)
        else:
            escalate_thr = float(np.float32(1.0 - (1.0 - recall_threshold) / 2.0))
            escalate = sorted_ok & ~(recall(s0, sorted_ok) >= escalate_thr)
            tripped = escalate & ~(recall(s, escalate) >= thr)
    use_capped = ~sorted_ok | tripped
    idx = torch.where(use_capped, knn_capped(x, k, cap=full_cap, pred=use_capped), idx)
    return (idx, tripped) if with_flag else idx
