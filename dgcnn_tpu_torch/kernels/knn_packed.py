"""Packed-key kNN (``knn_impl="pallas_packed"``): the Hopper kernels and
their plain PyTorch versions.

Counterpart of ``dgcnn_tpu/kernels/knn_pallas.py::knn_pallas(packed=True,
cap=0)``, whose kernel is ``_knn_kernel_packed``. Rows are padded to a
multiple of 128 (``n_pad``; the padding scores -inf); every row ``o`` gets
the recentred FP32 score ``(2 q·x_o - |x_o|^2) - |q|^2``, turned into a
monotone int32 key shifted right by one whose low ``idx_bits = max(13, bit
length of n_pad - 1)`` bits carry ``n_pad - 1 - o``. Keys are unique, so
the k largest are fully determined (score ties go to the lower row). Past
15 index bits the wrapper takes the flat f32-exact kNN (``knn_exact.py``),
as the TPU wrapper does. It is also the capped kNN's fallback when
``n_win * cap < k`` (``knn_capped.py``).

``splits > 1`` selects the split kernel where the TPU wrapper does
(``knn_pallas(packed=True, splits=s)``: n_pad <= 8192 and n_pad % s == 0),
the counterpart of ``_knn_kernel_packed_split``. Its keys are NOT shifted
and carry a fixed 13-bit index field (:func:`packed_keys` with
``shift=0``): 19 bits of score where the flat kernel keeps 18, so the two
select differently wherever two distances agree in 18 bits but not in 19
(the TPU docstrings' "identical to splits=1" holds only where they do
not). The slices only shape the work: keys are unique, so the result is
the top-k of the split keys over all N rows, and the split kernel is the
flat kernel's body on the split key (``dgcnn_knn_packed_split``: one
launch, no scratch), its float prefilter derived for that key
(:func:`score_bound`).

:func:`knn_packed` runs the CUDA kernels (``csrc/knn_packed.cu``) on a
CUDA tensor, counted in ``knn_packed.launches`` (flat) and
``_knn_packed_split.launches`` (split), and :func:`knn_packed_plain` or
:func:`knn_packed_split_plain` on a CPU tensor.

The flat kernel's block takes ``qb`` queries (:func:`launch_geometry`: 64,
or 32 for a small grid at C <= 8), a warp 8 of them, each query's top-k list
spread over the warp's lanes; a candidate below the query's k-th key so far
is dropped, which is exact because the k-th largest key of any subset of the
rows is at most the k-th largest of all. At C <= 8 a fused kernel scores in
the warps themselves and drops a score below the float its query's k-th key
starts at before making its key.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.knn_exact import knn_exact

_ROW_ALIGN = 128
_KERNEL_MAX_K = 64
SMEM_LIMIT = 232448  # shared memory a Hopper block may take (bytes)
THREADS = 256  # the two-phase kernel's block (C >= 16) ...
QUERIES_PER_BLOCK = 64  # ... and its queries, 8 a warp
TILE_ROWS = 64 * THREADS // QUERIES_PER_BLOCK  # its rows a tile: 8 x 8 dots a thread
FUSED_TILE_ROWS = 256  # the fused kernel's (C <= 8) staged rows a tile
SMALL_GRID = 128  # blocks below which a fused (C <= 8) launch takes 32-query blocks (132 SMs)
_QUERY_CHUNK = 1024  # plain version: queries per (B, chunk, n_pad) key tile
_SPLIT_IDX_BITS = 13  # the split kernel's fixed index field (n_pad <= 8192)


def packed_geometry(n: int) -> tuple[int, int]:
    """(n_pad, idx_bits) of the packed kernel for ``n`` rows."""
    n_pad = -(-n // _ROW_ALIGN) * _ROW_ALIGN
    return n_pad, max(13, (n_pad - 1).bit_length())


def _row_stride4(cv: int) -> int:
    """A staged row's stride in float4 (odd: conflict-free 16-byte reads)."""
    v = cv // 4
    return v if v % 2 else v + 1


def smem_bytes(cv: int) -> int:
    """The flat kernel's shared memory, as
    ``csrc/knn_packed.cu::flat_smem_bytes`` computes it: at C >= 16 (the
    two-phase kernel) its 64 queries and one tile of :data:`TILE_ROWS` rows
    (rows of an odd float4 stride), the rows' norms, and the key tile of
    ``TILE_ROWS + 8`` ints a query; at C <= 8 (the fused kernel, queries in
    registers) two tiles of :data:`FUSED_TILE_ROWS` rows and their norms,
    whatever its block."""
    xs4 = _row_stride4(cv)
    if cv <= 8:
        return 2 * FUSED_TILE_ROWS * (16 * xs4 + 4)
    qb = QUERIES_PER_BLOCK
    return 16 * (qb + TILE_ROWS) * xs4 + 4 * TILE_ROWS + 4 * qb * (TILE_ROWS + 8)


def launch_geometry(cv: int, b: int, m: int) -> int:
    """Queries a block of the flat kernel (its launch geometry) for ``b`` x
    ``m`` queries: 64 (8 warps of 8 queries), the two-phase kernel's only
    block at C >= 16; at C <= 8 the fused kernel takes 32 (4 warps) where
    64 would leave the card's SMs idle (fewer than :data:`SMALL_GRID`
    blocks). Raises ValueError where the shared memory would exceed
    :data:`SMEM_LIMIT` (no width the kernel takes does)."""
    qb = 32 if cv <= 8 and b * -(-m // 64) < SMALL_GRID else QUERIES_PER_BLOCK
    if smem_bytes(cv) > SMEM_LIMIT:
        raise ValueError(f"the packed kNN kernel cannot take C={cv}: "
                         f"{smem_bytes(cv)} bytes of shared memory")
    return qb


def packed_keys(x: torch.Tensor, q: torch.Tensor, n_pad: int,
                idx_bits: int, shift: int = 1) -> torch.Tensor:
    """(B, M, n_pad) int32 packed keys of the queries ``q`` (B, M, C)
    against the rows of ``x`` (B, N, C) padded to ``n_pad`` rows, bit for
    bit the TPU kernels' (the capped kernel's too, on its own padding).
    The split kernel's keys (``_knn_kernel_packed_split``) are
    ``shift=0`` with 13 index bits: its monotone int32 is not shifted."""
    b, n, _ = x.shape
    imask = (1 << idx_bits) - 1
    cn = (x * x).sum(-1)
    qn = (q * q).sum(-1)
    scores = torch.full((b, q.shape[1], n_pad), float("-inf"), device=x.device)
    scores[..., :n] = (2.0 * torch.matmul(q, x.transpose(1, 2))
                       - cn[:, None, :]) - qn[..., None]
    bits = scores.view(torch.int32)
    # where(bits >= 0, bits, INT_MIN - bits) >> shift, overflow-free
    key = torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF)) >> shift
    inv = (n_pad - 1 - torch.arange(n_pad, device=x.device)).to(torch.int32)
    return (key & ~imask) | inv


def _top_by_keys(x, q, k, n_pad, idx_bits, shift) -> torch.Tensor:
    """``torch.topk`` of the packed keys over query chunks, decoded to row
    indices (keys are unique, so the order is fully determined)."""
    imask = (1 << idx_bits) - 1
    out = []
    for s in range(0, q.shape[1], _QUERY_CHUNK):
        top = packed_keys(x, q[:, s:s + _QUERY_CHUNK], n_pad, idx_bits,
                          shift).topk(k, dim=-1).values
        out.append((n_pad - 1 - (top & imask)).to(torch.int32))
    return torch.cat(out, dim=1)


def knn_packed_plain(x: torch.Tensor, k: int, *,
                     queries: torch.Tensor | None = None) -> torch.Tensor:
    """The packed kernel's selection in plain PyTorch: the same keys, bit
    for bit in int32, then ``torch.topk``. (B, M, k) int32. Requires at
    most 15 index bits, as the kernel does."""
    n_pad, idx_bits = packed_geometry(x.shape[1])
    if idx_bits > 15:
        raise ValueError(f"the packed kNN takes at most 15 index bits, not {idx_bits}")
    return _top_by_keys(x, x if queries is None else queries, k, n_pad, idx_bits, 1)


def knn_packed_split_plain(x: torch.Tensor, k: int, *,
                           queries: torch.Tensor | None = None) -> torch.Tensor:
    """The split kernel's selection in plain PyTorch: its keys (not
    shifted, 13 index bits), then ``torch.topk``; the slicing does not change the result, so it
    takes no ``splits``. (B, M, k) int32. Requires n_pad <= 8192, as the
    kernel does."""
    n_pad, _ = packed_geometry(x.shape[1])
    if n_pad > 1 << _SPLIT_IDX_BITS:
        raise ValueError(f"the split kNN takes n_pad <= {1 << _SPLIT_IDX_BITS}, not {n_pad}")
    return _top_by_keys(x, x if queries is None else queries, k, n_pad, _SPLIT_IDX_BITS, 0)


def score_bound(kth: int, keep_mask: int, shift: int) -> np.float32:
    """The fused kernel's float prefilter, as ``csrc/knn_packed.cu::
    score_bound<SHIFT>`` computes it: the least score whose packed key
    ``((monotone_int(score) >> shift) & keep_mask) | low`` can reach the
    int32 key ``kth`` (shift 1: the flat key, 0: the split key). A score
    below it has a key below ``kth``; -inf where nothing is excluded, NaN
    (which excludes nothing) where the bound's bits are a NaN's."""
    hi = kth & keep_mask
    if kth == -(1 << 31) or hi <= (-0x3fffffff if shift else -(1 << 31)):
        return np.float32(-np.inf)
    m = hi << shift
    bits = m if m >= 0 else 0x80000000 | -m
    return np.array([bits], np.uint32).view(np.float32)[0]


def _checked(x: torch.Tensor, k: int, queries: torch.Tensor | None):
    """(x, q) as float32 after the wrappers' shape checks."""
    b, n, c = x.shape
    if k > n:
        raise ValueError(f"k={k} exceeds number of points {n}")
    q = x if queries is None else queries
    if q.ndim != 3 or q.shape[0] != b or q.shape[2] != c:
        raise ValueError(f"queries {tuple(q.shape)} do not match x {tuple(x.shape)}")
    x = x.float()
    return x, x if queries is None else q.float()


def _operands(x: torch.Tensor, q: torch.Tensor, self_knn: bool, k: int):
    """The CUDA kernels' operands ``(x, q, |x|^2, |q|^2, width)``: x and q
    zero-padded to the kernel width and contiguous, the norms taken before
    the padding (zeros change none)."""
    if x.device.type != "cuda":
        raise ValueError(f"the packed kNN runs on cpu or cuda, not {x.device}")
    if k > _KERNEL_MAX_K:
        raise ValueError(f"the CUDA kernel takes k <= {_KERNEL_MAX_K}, not {k}")
    if q.device != x.device:
        raise ValueError(f"queries must be on {x.device}")
    c = x.shape[2]
    cv = _build.kernel_width(c)
    cn = (x * x).sum(-1).contiguous()
    qn = (q * q).sum(-1).contiguous()
    if cv != c:
        x = torch.nn.functional.pad(x, (0, cv - c))
        q = x if self_knn else torch.nn.functional.pad(q, (0, cv - c))
    return x.contiguous(), q.contiguous(), cn, qn, cv


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def knn_packed(x: torch.Tensor, k: int, *, queries: torch.Tensor | None = None,
               pred: torch.Tensor | None = None, splits: int = 1) -> torch.Tensor:
    """k nearest rows of ``x`` (B, N, C) for each row of ``queries`` (B, M,
    C; default ``x``: self-kNN) by the packed keys. (B, M, k) int32,
    nearest first. Launches the CUDA kernel on a CUDA tensor (counted in
    ``knn_packed.launches``) and the plain version on a CPU tensor.

    ``splits`` is routed as the TPU wrapper routes it: past 15 index bits
    the f32-exact kNN; else the split kernel where ``splits > 1``,
    n_pad <= 8192 and ``splits`` divides n_pad; else the flat kernel.
    ``pred``: an optional 0-d bool tensor on ``x``'s device; where it is
    False the kernel does no work and the result is undefined."""
    x, q = _checked(x, k, queries)
    b, n, _ = x.shape
    queries = None if queries is None else q
    n_pad, idx_bits = packed_geometry(n)
    if idx_bits > 15:
        # the TPU wrapper's f32-exact fallback for wide index fields
        return knn_exact(x, k, queries=queries, pred=pred)
    if split_applies(n, splits):
        return _knn_packed_split(x, k, splits, queries, pred)
    if x.device.type == "cpu":
        if _build.skipped(pred):
            return torch.zeros((b, q.shape[1], k), dtype=torch.int32)
        return knn_packed_plain(x, k, queries=queries)
    x, q, cn, qn, cv = _operands(x, q, queries is None, k)
    return launch_kernel(x, q, cn, qn, k, qb=launch_geometry(cv, b, q.shape[1]), pred=pred)


def launch_kernel(x: torch.Tensor, q: torch.Tensor, cn: torch.Tensor, qn: torch.Tensor,
                  k: int, *, qb: int, pred: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the flat kernel on prepared CUDA tensors: ``x`` (B, N,
    cv) and ``q`` (B, M, cv) contiguous and zero-padded to a kernel width,
    ``cn`` / ``qn`` their row norms, ``qb`` queries a block (as
    :func:`launch_geometry` returns it). (B, M, k) int32. Counted in
    ``knn_packed.launches``."""
    b, n, cv = x.shape
    m = q.shape[1]
    n_pad, idx_bits = packed_geometry(n)
    flag = _build.predicate(pred, x.device)
    out = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
    err = _build.lib().dgcnn_knn_packed(
        x.data_ptr(), q.data_ptr(), cn.data_ptr(), qn.data_ptr(), out.data_ptr(),
        None if flag is None else flag.data_ptr(), b, n, m, cv, k, n_pad, idx_bits, qb,
        _stream(x.device))
    _build.check(err, "knn_packed")
    knn_packed.launches += 1
    return out


def split_applies(n: int, splits: int) -> bool:
    """Whether ``knn_pallas(packed=True, splits=splits)`` runs the split
    kernel on ``n`` rows: ``splits > 1``, n_pad <= 8192 (beyond, the TPU
    wrapper sets ``splits = 1``) and ``splits`` divides n_pad."""
    n_pad, _ = packed_geometry(n)
    return splits > 1 and n_pad <= 1 << _SPLIT_IDX_BITS and n_pad % splits == 0


def _knn_packed_split(x: torch.Tensor, k: int, splits: int,
                      queries: torch.Tensor | None,
                      pred: torch.Tensor | None) -> torch.Tensor:
    """The split kernel (``_knn_kernel_packed_split``), reached through
    :func:`knn_packed` where :func:`split_applies`, on its checked float32
    operands: the top-k of the split keys, which the TPU kernel takes over
    ``splits`` contiguous slices of the rows and one merge, and which does
    not depend on the slicing (keys are unique), so ``splits`` shapes no
    work here. (B, M, k) int32, nearest first. Launches the CUDA kernel on
    a CUDA tensor (:func:`launch_split`) and :func:`knn_packed_split_plain`
    on a CPU tensor."""
    b, n, _ = x.shape
    q = x if queries is None else queries
    if x.device.type == "cpu":
        if _build.skipped(pred):
            return torch.zeros((b, q.shape[1], k), dtype=torch.int32)
        return knn_packed_split_plain(x, k, queries=queries)
    x, q, cn, qn, cv = _operands(x, q, queries is None, k)
    return launch_split(x, q, cn, qn, k, qb=launch_geometry(cv, b, q.shape[1]), pred=pred)


def launch_split(x: torch.Tensor, q: torch.Tensor, cn: torch.Tensor, qn: torch.Tensor,
                 k: int, *, qb: int, pred: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the split kernel (the flat kernel on the split key) on
    prepared CUDA tensors, as :func:`launch_kernel` takes them; n_pad <=
    8192. (B, M, k) int32. Counted in ``_knn_packed_split.launches``."""
    b, n, cv = x.shape
    m = q.shape[1]
    n_pad, _ = packed_geometry(n)
    flag = _build.predicate(pred, x.device)
    out = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
    err = _build.lib().dgcnn_knn_packed_split(
        x.data_ptr(), q.data_ptr(), cn.data_ptr(), qn.data_ptr(), out.data_ptr(),
        None if flag is None else flag.data_ptr(), b, n, m, cv, k, n_pad, qb,
        _stream(x.device))
    _build.check(err, "knn_packed_split")
    _knn_packed_split.launches += 1
    return out


knn_packed.launches = 0
_knn_packed_split.launches = 0
