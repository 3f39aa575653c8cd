"""Flat FP32-exact kNN: the Hopper kernel and its plain PyTorch version.

Counterpart of ``dgcnn_tpu/kernels/knn_pallas.py::knn_pallas(packed=False)``,
whose kernel is ``_knn_kernel``: rank every row ``o`` of ``x`` for each
query by ``2 q·x_o - |x_o|^2`` in FP32 and take the k largest, nearest
first, ties to the lower row. The port runs it where the JAX package does:
the stage-1 banded kNN's repair of the queries that fail the band-edge
certificate (``kernels/knn_banded.py::knn_banded``), and the capped kNN's
fallback past 15 index bits (``kernels/knn_capped.py``).

:func:`knn_exact` runs the CUDA kernel (``csrc/knn_exact.cu``) on a CUDA
tensor and :func:`knn_exact_plain` on a CPU tensor. :func:`launch_geometry`
picks the kernel's slices (warps per query) from the shape;
:func:`launch_kernel` launches it on prepared tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.ops.knn import knn

_KERNEL_MAX_K = 64
_LANES = 32  # rows a warp scores at once: one chunk
_SLICES = (8, 4, 2, 1)  # warps per query the kernel takes
SMS = 132  # the H100's SMs
# csrc/knn_exact.cu: the cloud kernel's warps a block, and the shared memory
# its block may take beside the slices' lists
CLOUD_WARPS = 32
_CLOUD_SMEM = 232448 - (2 * 4 * CLOUD_WARPS * 2 * _LANES + 16)


def cloud_fits(n: int, cv: int) -> bool:
    """Whether the cloud kernel (C <= 8, the cloud's rows and norms in
    shared memory) takes ``n`` rows at kernel width ``cv``: else the kernel
    that reads rows from L1 / L2 runs."""
    return cv <= 8 and 4 * n * (cv + 1) <= _CLOUD_SMEM


def knn_exact_plain(x: torch.Tensor, k: int, *,
                    queries: torch.Tensor | None = None) -> torch.Tensor:
    """The exact kernel's selection in plain PyTorch: the exact kNN of
    ``ops/knn.py`` (the same scores, a stable descending sort). (B, M, k)
    int32."""
    return knn(x, k, queries=queries)


def launch_geometry(b: int, m: int, n: int, cv: int) -> int:
    """Slices (warps per query) of a launch for ``b * m`` queries against
    ``n`` rows at kernel width ``cv``. The cloud kernel's blocks of 32 warps
    each stage their cloud and hold ``32 / slices`` queries: the most
    slices whose blocks still fit on the SMs at one block each, at most
    one a chunk of 32 rows; 1 where the queries alone fill the card (a
    self-kNN). The other kernel reads rows from L2 by each warp: 1."""
    if not cloud_fits(n, cv):
        return 1
    chunks = -(-n // _LANES)
    return next((s for s in _SLICES
                 if b * -(-m * s // CLOUD_WARPS) <= SMS and s <= chunks), 1)


def launch_kernel(x, q, cn, k: int, *, rows=None, own_rows: bool = False, slices: int = 1,
                  pred=None) -> torch.Tensor:
    """The kernel alone, on the wrapper's prepared CUDA tensors: ``x`` (B,
    N, cv) and ``q`` (B, M, cv) at a kernel width, ``cn`` the rows' norms
    (B, N); the walk's start: ``rows``, a (B, M) int64 hint (rows
    contiguous, any batch stride), or with ``own_rows`` each query's own
    row (a self-kNN), else row 0. Not counted: :func:`knn_exact` counts
    its launches."""
    b, n, cv = x.shape
    m = q.shape[1]
    flag = _build.predicate(pred, x.device)
    out = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
    err = _build.lib().dgcnn_knn_exact(
        x.data_ptr(), q.data_ptr(), cn.data_ptr(), None if rows is None else rows.data_ptr(),
        out.data_ptr(), None if flag is None else flag.data_ptr(), b, n, m, cv, k,
        int(own_rows) if rows is None else rows.stride(0), slices,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(err, "knn_exact")
    return out


def _hint(query_rows, b: int, m: int, dev) -> torch.Tensor | None:
    """``query_rows`` checked: (B, M) integer rows on the device, as int64
    with contiguous rows (the repair's slice of a wider tensor is taken as
    it is, without a copy)."""
    if query_rows is None:
        return None
    if query_rows.shape != (b, m) or query_rows.dtype not in (torch.int32, torch.int64) \
            or query_rows.device != dev:
        raise ValueError(f"query_rows must be ({b}, {m}) integers on {dev}, not "
                         f"{query_rows.dtype} {tuple(query_rows.shape)} on {query_rows.device}")
    rows = query_rows.to(torch.int64)
    return rows if rows.stride(1) == 1 or m == 1 else rows.contiguous()


def knn_exact(x: torch.Tensor, k: int, *, queries: torch.Tensor | None = None,
              pred: torch.Tensor | None = None,
              query_rows: torch.Tensor | None = None) -> torch.Tensor:
    """k nearest rows of ``x`` (B, N, C) for each row of ``queries`` (B, M,
    C; default ``x``: self-kNN), FP32-exact. (B, M, k) int32, nearest
    first, ties to the lower row. Launches the CUDA kernel on a CUDA tensor
    (counted in ``knn_exact.launches``) and the plain version on a CPU
    tensor.

    ``pred``: an optional 0-d bool tensor on ``x``'s device; where it is
    False the kernel does no work and the result is undefined (the caller
    selects another result with ``torch.where``).

    ``query_rows``: an optional (B, M) integer tensor on ``x``'s device,
    the row each query sits at (the repair passes the repaired rows; a
    self-kNN's queries sit at ``arange(N)``, taken without it). The kernel
    then walks the rows from there, rightward, then leftward, which in an
    x-sorted cloud meets the nearest rows first: it takes far fewer
    candidates and can stop early; (score, row) is a total order, so the
    hint changes no result. The plain version ignores it."""
    b, n, c = x.shape
    if k > n:
        raise ValueError(f"k={k} exceeds number of points {n}")
    q = x if queries is None else queries
    if q.ndim != 3 or q.shape[0] != b or q.shape[2] != c:
        raise ValueError(f"queries {tuple(q.shape)} do not match x {tuple(x.shape)}")
    m = q.shape[1]
    rows = _hint(query_rows, b, m, x.device)
    if x.device.type == "cpu":
        if _build.skipped(pred):
            return torch.zeros((b, m, k), dtype=torch.int32)
        return knn_exact_plain(x, k, queries=queries)
    if x.device.type != "cuda":
        raise ValueError(f"knn_exact runs on cpu or cuda, not {x.device}")
    if k > _KERNEL_MAX_K:
        raise ValueError(f"the CUDA kernel takes k <= {_KERNEL_MAX_K}, not {k}")
    cv = _build.kernel_width(c)
    for t, name in ((x, "x"), (q, "queries")):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 on {x.device}")
    cn = (x * x).sum(-1).contiguous()  # the plain version's reduction
    if cv != c:
        x = torch.nn.functional.pad(x, (0, cv - c))
        q = x if queries is None else torch.nn.functional.pad(q, (0, cv - c))
    x, q = x.contiguous(), q.contiguous()
    # the kernel reads rows and queries 16 bytes at a time
    x, q = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, q))
    out = launch_kernel(x, q, cn, k, rows=rows, own_rows=queries is None,
                        slices=launch_geometry(b, m, n, cv), pred=pred)
    knn_exact.launches += 1
    return out


knn_exact.launches = 0
