"""Row scatter-adds of the training backward: Hopper kernels and their
plain PyTorch versions.

Counterparts of ``dgcnn_tpu/kernels/scatter_pallas.py``:

* :func:`scatter_add_rows` (``_kernel``): ``out[b, idx[b, m]] += dy[b, m]``,
  the VJP of the EdgeConv gather (``ops/edgeconv.py::gather_neighbors``;
  in a train step, stage 2's: stage 1 gathers the input points, which
  need no gradient);
* :func:`scatter_stage_tail_rows` (``_stage_tail_kernel``):
  ``out[b, idx[b, q, j]] += u[b, q] * (am[b, q] == j) + w[b, q]`` and the
  hit count per row, stage 3's fused BN + max tail backward
  (``ops/edgeconv.py::edge_stage_tail_train``), with the (B, N, k, C)
  cotangent computed as it is added.

Each wrapper launches its CUDA kernel (``csrc/scatter_rows.cu``) on CUDA
tensors, counted in ``<wrapper>.launches``, and runs its plain version on
CPU tensors. Indices are clamped to [0, N), where the forward gather reads
them (the JAX scatter drops an index >= N instead; the port's gather
clamps, so its adjoint clamps too). The kernels add with atomics, so the
FP32 sum order changes from run to run.

The tail kernel cuts the global reductions the TPU kernel avoids by
keeping its accumulator in VMEM: a block sorts the entries of a tile of
``qt`` neighbouring queries by target row in shared memory, sums each row's
entries in registers and adds one sum per (row, channel) of the tile into
the output; stage 3's neighbours are local, so a tile's entries fall on far
fewer rows than entries. Rows past the tile's histogram take the first
design (a warp per query, a reduction per entry). :func:`tail_plan` chooses
the route and ``qt`` from the shape.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import _build

_TAIL_MAX_K = 127  # argmax slots travel as int8
_TAIL_GLOBAL_MAX_C = 128  # the global route keeps <= 4 channels per lane
SMEM_LIMIT = 232448  # shared memory a Hopper block may take (bytes)
SMS = 132  # the H100 SXM's streaming multiprocessors
TAIL_MAX_ROWS = 32768  # the tile route's rows (15 bits in a sorted entry)
TAIL_MAX_QUERIES = 512  # its queries a tile (9 bits)
TAIL_TILE_ENTRIES = 2048  # the entries (qt * k) a tile takes at most; the kernel takes <= 8192


def tile_smem_bytes(n: int, k: int, c: int, qt: int) -> int:
    """The tile kernel's shared memory, as ``csrc/scatter_rows.cu::
    tile_smem_bytes`` computes it: the histogram of ``n`` rows and two int
    arrays of the tile's ``qt * k`` entries (rounded up to 16 bytes), then
    the tile's ``qt`` rows of u and w (FP32) and of argmax slots (int8)."""
    return 4 * -(-(n + 2 * qt * k) // 4) * 4 + 9 * qt * c


def tail_plan(b: int, n: int, k: int, c: int, budget: int = SMEM_LIMIT,
              entries: int = TAIL_TILE_ENTRIES, sms: int = SMS) -> int:
    """Queries a tile of the tail kernel for (b, n, c) tables and k
    neighbours: as many as keep the tile's entries within ``entries`` (at
    most :data:`TAIL_MAX_QUERIES` and ``n``) and the ``b * n / qt`` tiles
    at least the card's ``sms`` where the batch allows, halved until the
    tile's shared memory fits the ``budget`` bytes a block may take; or 0,
    the global route, where ``n`` exceeds :data:`TAIL_MAX_ROWS` or not even
    one query fits."""
    if n > TAIL_MAX_ROWS:
        return 0
    qt = max(1, min(TAIL_MAX_QUERIES, entries // k, n, b * n // sms))
    while qt > 1 and tile_smem_bytes(n, k, c, qt) > budget:
        qt //= 2
    return qt if tile_smem_bytes(n, k, c, qt) <= budget else 0


def _flat_targets(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) indices, clamped, as rows of the flattened (B * n) table."""
    b = idx.shape[0]
    rows = idx.long().clamp(0, n - 1).reshape(b, -1)
    return (rows + torch.arange(b, device=idx.device)[:, None] * n).reshape(-1)


def scatter_add_rows_plain(dy: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row scatter-add in plain PyTorch: ``index_add_`` on the
    flattened (B * n, C) table. (B, n, C)."""
    b, _, c = dy.shape
    out = torch.zeros((b * n, c), dtype=dy.dtype, device=dy.device)
    out.index_add_(0, _flat_targets(idx, n), dy.reshape(-1, c))
    return out.reshape(b, n, c)


def scatter_stage_tail_rows_plain(u, w, am, idx) -> tuple[torch.Tensor, torch.Tensor]:
    """The stage-tail scatter in plain PyTorch: builds the (B, N, k, C)
    rows ``where(am == j, u, 0) + w`` and adds them with ``index_add_``.
    Returns ``(sums (B, N, C), count (B, N))``."""
    b, n, c = u.shape
    k = idx.shape[-1]
    slots = torch.arange(k, device=u.device)[None, None, :, None]
    rows = torch.where(am.long()[:, :, None, :] == slots, u[:, :, None, :], 0.0) \
        + w[:, :, None, :]
    targets = _flat_targets(idx, n)
    sums = torch.zeros((b * n, c), dtype=u.dtype, device=u.device)
    sums.index_add_(0, targets, rows.reshape(-1, c))
    count = torch.zeros((b * n,), dtype=u.dtype, device=u.device)
    count.index_add_(0, targets, torch.ones_like(targets, dtype=u.dtype))
    return sums.reshape(b, n, c), count.reshape(b, n)


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def scatter_add_rows(dy: torch.Tensor, idx: torch.Tensor, n: int, *,
                     pred: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b, idx[b, m]] += dy[b, m]``: dy (B, M, C) float32, idx (B, M)
    int -> (B, n, C). Launches the CUDA kernel on CUDA tensors (counted in
    ``scatter_add_rows.launches``), the plain version on CPU tensors.
    ``pred``: an optional 0-d bool tensor on dy's device; where it is False
    the kernel does no work and the result is zeros."""
    if dy.ndim != 3 or idx.shape != dy.shape[:2]:
        raise ValueError(f"dy {tuple(dy.shape)} and idx {tuple(idx.shape)} do not match")
    if dy.device.type == "cpu":
        if _build.skipped(pred):
            return torch.zeros((dy.shape[0], n, dy.shape[2]), dtype=dy.dtype)
        return scatter_add_rows_plain(dy, idx, n)
    if dy.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cpu or cuda, not {dy.device}")
    if dy.dtype != torch.float32 or idx.dtype != torch.int32 or idx.device != dy.device:
        raise ValueError(f"dy must be float32 and idx int32, both on {dy.device}")
    b, m, c = dy.shape
    dy, idx = dy.contiguous(), idx.contiguous()
    flag = _build.predicate(pred, dy.device)
    out = torch.zeros((b, n, c), dtype=torch.float32, device=dy.device)
    err = _build.lib().dgcnn_scatter_add_rows(
        dy.data_ptr(), idx.data_ptr(), out.data_ptr(),
        None if flag is None else flag.data_ptr(), b, m, n, c, _stream(dy.device))
    _build.check(err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


def scatter_stage_tail_rows(u: torch.Tensor, w: torch.Tensor, am: torch.Tensor,
                            idx: torch.Tensor, *, pred: torch.Tensor | None = None,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sums[b, idx[b,q,j]] += u[b,q] * (am[b,q] == j) + w[b,q]`` and
    ``count[b, idx[b,q,j]] += 1``: u, w (B, N, C) float32, am (B, N, C)
    argmax k-slots, idx (B, N, k) int -> ``(sums (B, N, C), count (B, N))``.
    Launches the CUDA kernel on CUDA tensors (counted in
    ``scatter_stage_tail_rows.launches``), with the tile :func:`tail_plan`
    gives, the plain version on CPU tensors. ``pred`` as for
    :func:`scatter_add_rows`."""
    if u.ndim != 3 or w.shape != u.shape or am.shape != u.shape or \
            idx.ndim != 3 or idx.shape[:2] != u.shape[:2]:
        raise ValueError(f"u {tuple(u.shape)}, w {tuple(w.shape)}, am {tuple(am.shape)} "
                         f"and idx {tuple(idx.shape)} do not match")
    if u.device.type == "cpu":
        if _build.skipped(pred):
            return torch.zeros_like(u), torch.zeros(u.shape[:2], dtype=u.dtype)
        return scatter_stage_tail_rows_plain(u, w, am, idx)
    if u.device.type != "cuda":
        raise ValueError(f"scatter_stage_tail_rows runs on cpu or cuda, not {u.device}")
    b, n, c = u.shape
    k = idx.shape[-1]
    qt = tail_plan(b, n, k, c)
    if k > _TAIL_MAX_K or (qt == 0 and c > _TAIL_GLOBAL_MAX_C):
        raise ValueError(f"the CUDA stage-tail kernel takes k <= {_TAIL_MAX_K}, and C <= "
                         f"{_TAIL_GLOBAL_MAX_C} past {TAIL_MAX_ROWS} rows, not k={k}, C={c}, "
                         f"N={n}")
    for t in (u, w, am, idx):
        if t.device != u.device:
            raise ValueError(f"operands must all be on {u.device}")
    if u.dtype != torch.float32 or w.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("u and w must be float32, idx int32")
    u, w, idx = u.contiguous(), w.contiguous(), idx.contiguous()
    am = am.to(torch.int8).contiguous()
    return launch_tail(u, w, am, idx, qt=qt, pred=pred)


def launch_tail(u: torch.Tensor, w: torch.Tensor, am: torch.Tensor, idx: torch.Tensor, *,
                qt: int, pred: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the tail kernel on prepared CUDA tensors (u, w float32,
    am int8, idx int32, all contiguous) with ``qt`` queries a tile
    (:func:`tail_plan`'s; 0: the global route), into zeroed outputs.
    Counted in ``scatter_stage_tail_rows.launches``."""
    b, n, c = u.shape
    k = idx.shape[-1]
    flag = _build.predicate(pred, u.device)
    sums = torch.zeros((b, n, c), dtype=torch.float32, device=u.device)
    count = torch.zeros((b, n), dtype=torch.float32, device=u.device)
    err = _build.lib().dgcnn_scatter_stage_tail(
        u.data_ptr(), w.data_ptr(), am.data_ptr(), idx.data_ptr(), sums.data_ptr(),
        count.data_ptr(), None if flag is None else flag.data_ptr(), b, n, k, c, qt,
        _stream(u.device))
    _build.check(err, "scatter_stage_tail_rows")
    scatter_stage_tail_rows.launches += 1
    return sums, count


scatter_add_rows.launches = 0
scatter_stage_tail_rows.launches = 0
