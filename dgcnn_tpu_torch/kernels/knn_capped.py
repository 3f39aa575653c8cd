"""Capped packed-key kNN: the Hopper kernel and its plain PyTorch version.

Counterpart of ``dgcnn_tpu/kernels/knn_pallas.py::knn_pallas(packed=True,
cap=...)``, whose kernel is ``_knn_kernel_packed_capped``. Per query, every
candidate row ``o`` gets the FP32 score ``(2 x_o·q - |x_o|^2) - |q|^2``,
turned into a monotone int32 key shifted right by one, whose low
``idx_bits`` carry ``n_pad - 1 - o`` (so keys are unique and ties go to
the lower row). Rows are split into ``n_win = n_pad / window`` windows,
window ``w`` being the rows with ``o % n_win == w``; each window keeps
its top-``cap`` keys and the ``n_win * cap`` winners merge to the top-k.
A query loses a true neighbour only when more than ``cap`` of its top-k
share a window (see the TPU kernel's docstring for the evidence).

:func:`knn_capped` runs the CUDA kernel (``csrc/knn_capped.cu``) on a CUDA
tensor and the plain version on a CPU tensor. It follows the TPU wrapper's
two fallbacks on either device: past 15 index bits to the flat f32-exact
kNN (``knn_exact.py``), and when ``n_win * cap < k`` to the flat packed kNN
(``knn_packed.py``).

:func:`launch_geometry` picks the kernel's launch from the shape: a block
owns a tile of queries and one group of at most 32 windows. A self-kNN
(thousands of queries) takes all windows in one group, so each block
merges its own lists; a few queries (the recall guard's probes) split the
windows over the grid, so that it fills the card, and a second kernel
merges the lists from a global buffer. The split is exact: a window's
top-cap needs only that window's rows.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact
from dgcnn_tpu_torch.kernels.knn_packed import knn_packed, packed_keys

_KERNEL_CAPS = (4, 8)
SMEM_LIMIT = 232448  # shared memory a Hopper block may take (bytes)
MAX_GROUP = 32  # windows of a block's group (the kernel's lists per thread)
TILE_ROWS = 256  # the two-phase kernel's staged rows (256 // g j-steps)
KEY_STRIDE = TILE_ROWS + 8  # its key tile's row, in ints
QUERIES_PER_THREAD = 4  # the fused kernel's
SPLIT_BLOCKS = 128  # (query tile, group) blocks a split aims at: about one per SM


def capped_geometry(n: int, window: int) -> tuple[int, int, int]:
    """(n_pad, n_win, idx_bits) of the capped kernel for ``n`` rows —
    ``knn_pallas``'s padding and index-field width."""
    n_pad = -(-n // window) * window
    return n_pad, n_pad // window, max(13, (n_pad - 1).bit_length())


def _row_stride4(cv: int) -> int:
    """A staged row's stride in float4 (odd: conflict-free 16-byte reads)."""
    v = cv // 4
    return v if v % 2 else v + 1


def smem_bytes(cv: int, n_win: int, cap: int, qb: int, g: int, jt: int,
               nbuf: int) -> int:
    """The kernel's shared memory for a launch geometry, as
    ``csrc/knn_capped.cu::smem_bytes`` computes it: the staging (C >= 16,
    the two-phase kernel: the queries, one tile of 256 rows, their norms
    and the key tile; C <= 8, the fused kernel: ``nbuf`` tiles of ``jt``
    j-steps of ``g`` rows and their norms) and, when one group holds every
    window, the per-window lists (``cap`` keys and a sentinel per query
    and window), which alias the staging."""
    xs4 = _row_stride4(cv)
    if cv > 8:
        staging = 16 * (qb + TILE_ROWS) * xs4 + 4 * TILE_ROWS + 4 * qb * KEY_STRIDE
    else:
        staging = nbuf * jt * g * (16 * xs4 + 4)
    one_group = g >= n_win
    return max(staging, 4 * qb * n_win * (cap + 1) if one_group else 0)


def launch_geometry(cv: int, b: int, m: int, n_pad: int, n_win: int,
                    cap: int) -> tuple[int, int, int, int]:
    """``(qb, g, jt, nbuf)`` of a kernel launch for ``b`` x ``m`` queries:
    queries per block, windows per block (its group), j-steps per staged
    tile and tile buffers. The windows split into groups of at most 32,
    and further where the query tiles are few: ``b * ceil(m / 64)`` tiles
    times the groups should reach :data:`SPLIT_BLOCKS` blocks (at B=8,
    N=7000, window 256: 2 windows a block at M = 64, 7 at M = 256). At C >= 16 the two-phase
    kernel: 64 queries (32 where the shared memory would not fit), tiles of
    ``256 // g`` j-steps. At C <= 8 the fused kernel: 4 queries per thread
    and ``g`` windows, at most 256 threads and 64 queries, tiles of 32
    j-steps, double-buffered unless one tile holds the window; shrunk to
    one j-step and one buffer where the shared memory would not fit. The
    fastest of ``scripts/torch_knn_capped.py --variants`` on the H100 at
    the self-kNN and at the probes (within 10%: the blocks' waves over the
    SMs decide the rest). Raises ValueError for a shape that no geometry
    fits in :data:`SMEM_LIMIT`."""
    window = n_pad // n_win
    tiles = b * -(-m // 64)
    groups = max(-(-n_win // MAX_GROUP), min(n_win, -(-SPLIT_BLOCKS // tiles)))
    g = -(-n_win // groups)
    if cv > 8:
        tries = [(64, g, TILE_ROWS // g, 1), (32, g, TILE_ROWS // g, 1)]
    else:
        qb = QUERIES_PER_THREAD * min(256 // g, 16)
        jt = min(window, 32)
        tries = [(qb, g, jt, 1 if jt == window else 2), (qb, g, 1, 2), (qb, g, 1, 1)]
    for geometry in tries:
        if smem_bytes(cv, n_win, cap, *geometry) <= SMEM_LIMIT:
            return geometry
    raise ValueError(
        f"the capped kNN kernel cannot take C={cv} with {n_win} windows and cap {cap}: "
        f"{smem_bytes(cv, n_win, cap, *tries[-1])} bytes of shared memory > {SMEM_LIMIT}")


def knn_capped_plain(
    x: torch.Tensor, k: int, *, cap: int = 8, window: int = 256,
    queries: torch.Tensor | None = None, query_chunk: int = 1024,
) -> torch.Tensor:
    """The capped kernel's selection in plain PyTorch: the same keys,
    bit for bit in int32, then ``torch.topk`` per window and for the merge
    (keys are unique, so the order is fully determined). Returns (B, M, k)
    int32. Requires ``n_win * cap >= k`` and at most 15 index bits, as the
    kernel does."""
    b, n, _ = x.shape
    q = x if queries is None else queries
    n_pad, n_win, idx_bits = capped_geometry(n, window)
    if n_win * cap < k or idx_bits > 15:
        raise ValueError(
            f"capped kNN needs n_win*cap >= k and <= 15 index bits "
            f"(n_win={n_win}, cap={cap}, k={k}, idx_bits={idx_bits})")
    imask = (1 << idx_bits) - 1
    out = []
    for s in range(0, q.shape[1], query_chunk):
        packed = packed_keys(x, q[:, s:s + query_chunk], n_pad, idx_bits)
        m = packed.shape[1]
        # (n_pad,) -> (window, n_win): column w is window w (o % n_win == w)
        per_win = packed.view(b, m, window, n_win).topk(cap, dim=2).values
        top = per_win.reshape(b, m, cap * n_win).topk(k, dim=-1).values
        out.append((n_pad - 1 - (top & imask)).to(torch.int32))
    return torch.cat(out, dim=1)


def knn_capped(
    x: torch.Tensor, k: int, *, cap: int = 8, window: int = 256,
    queries: torch.Tensor | None = None, pred: torch.Tensor | None = None,
) -> torch.Tensor:
    """k nearest rows of ``x`` (B, N, C) for each row of ``queries``
    (B, M, C; default ``x``: self-kNN), by the capped packed-key
    selection. (B, M, k) int32, nearest first. Launches the CUDA kernel
    on a CUDA tensor (counted in ``knn_capped.launches``) and the plain
    version on a CPU tensor.

    ``pred``: an optional 0-d bool tensor on ``x``'s device; where it is
    False the kernel does no work and the result is undefined (the banded
    wrappers select another result with ``torch.where``)."""
    b, n, c = x.shape
    if k > n:
        raise ValueError(f"k={k} exceeds number of points {n}")
    if window % 128:
        raise ValueError("window must be a multiple of 128")
    q = x if queries is None else queries
    if q.ndim != 3 or q.shape[0] != b or q.shape[2] != c:
        raise ValueError(f"queries {tuple(q.shape)} do not match x {tuple(x.shape)}")
    n_pad, n_win, idx_bits = capped_geometry(n, window)
    if idx_bits > 15:
        # the TPU wrapper's f32-exact fallback for wide index fields
        return knn_exact(x.float(), k, pred=pred,
                         queries=None if queries is None else q.float())
    if n_win * cap < k:
        # extraction capacity below k: the TPU wrapper falls back to the
        # flat packed kNN (small inputs, where it is cheap anyway)
        return knn_packed(x, k, queries=queries, pred=pred)
    if x.device.type == "cpu":
        if _build.skipped(pred):
            return torch.zeros((b, q.shape[1], k), dtype=torch.int32)
        x, q = x.float(), q.float()
        return knn_capped_plain(x, k, cap=cap, window=window,
                                queries=None if queries is None else q)
    if x.device.type != "cuda":
        raise ValueError(f"knn_capped runs on cpu or cuda, not {x.device}")
    if cap not in _KERNEL_CAPS:
        raise ValueError(f"the CUDA kernel takes cap in {_KERNEL_CAPS}, not {cap}")
    cv = _build.kernel_width(c)
    for t, name in ((x, "x"), (q, "queries")):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 on {x.device}")
    cn = (x * x).sum(-1).contiguous()
    qn = (q * q).sum(-1).contiguous()
    if cv != c:
        x = torch.nn.functional.pad(x, (0, cv - c))
        q = x if queries is None else torch.nn.functional.pad(q, (0, cv - c))
    x, q = x.contiguous(), q.contiguous()
    return launch_kernel(x, q, cn, qn, k, window=window, cap=cap,
                         geometry=launch_geometry(cv, b, q.shape[1], n_pad, n_win, cap),
                         pred=pred)


def launch_kernel(
    x: torch.Tensor, q: torch.Tensor, cn: torch.Tensor, qn: torch.Tensor, k: int,
    *, window: int, cap: int, geometry: tuple[int, int, int, int],
    pred: torch.Tensor | None = None,
) -> torch.Tensor:
    """One launch of the kernel on prepared CUDA tensors: ``x`` (B, N, cv)
    and ``q`` (B, M, cv) contiguous and zero-padded to a kernel width,
    ``cn`` / ``qn`` their row norms; ``geometry`` as
    :func:`launch_geometry` returns it (a split geometry also takes a
    (B, M, n_win, cap) buffer of lists and launches the merge kernel).
    Counted in ``knn_capped.launches``."""
    b, n, cv = x.shape
    m = q.shape[1]
    n_pad, n_win, idx_bits = capped_geometry(n, window)
    flag = _build.predicate(pred, x.device)
    out = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
    split = geometry[1] < n_win
    lists = (torch.empty((b, m, n_win, cap), dtype=torch.int32, device=x.device)
             if split else None)
    err = _build.lib().dgcnn_knn_capped(
        x.data_ptr(), q.data_ptr(), cn.data_ptr(), qn.data_ptr(), out.data_ptr(),
        None if lists is None else lists.data_ptr(),
        None if flag is None else flag.data_ptr(),
        b, n, m, cv, k, n_pad, window, cap, idx_bits, *geometry,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(err, "knn_capped")
    knn_capped.launches += 1
    return out


knn_capped.launches = 0
