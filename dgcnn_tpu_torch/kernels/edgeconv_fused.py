"""Fused eval EdgeConv stages with the neighbour gather inside the kernel.

Counterparts of ``dgcnn_tpu/kernels/edgeconv_pallas.py``:

* :func:`edgeconv_fused_stage` (stages 1-2):
  ``max_k lrelu(BN_b(W2 · lrelu(BN_a(table[idx] + bvec))))``;
* :func:`edgeconv_fused_extrema` (stage 3):
  ``lrelu(scale · sel + shift)``, ``sel = (gamma >= 0 ? max_k : min_k)
  (table[idx]) + bvec``;
* :func:`fold_bn`: eval BatchNorm as per-channel (scale, shift).

Each wrapper launches its CUDA kernel (``csrc/edgeconv_fused.cu``) on CUDA
tensors, counted in ``<wrapper>.launches``, and runs its plain PyTorch
version on CPU tensors. The plain versions build the (B, N, k, C)
gathered tensor that the kernels never write to device memory.
Neighbour indices are clamped to [0, N), as the unfused chain's gather
does. :func:`launch_geometry` picks the stage kernel's warps per block and
staging buffers; :func:`launch_stage` launches it at a given geometry;
:func:`launch_extrema` launches the extrema kernel at a given grid.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.gather_rows import gather_rows_plain
from dgcnn_tpu_torch.ops.edgeconv import lrelu

_WIDTH = 64  # the kernels' table and W2 width
UNIT_ROWS = 32  # gathered rows the stage kernel's warp multiplies at once
_UNIT_BYTES = 4 * (UNIT_ROWS + 1) * (_WIDTH + 4)  # a staging buffer: rows + bvec
# (warps per block, staging buffers per warp) of every launch: 12 warps, 3
# on each of the SM's 4 schedulers, the fastest on the H100
# (scripts/exp_edgeconv_stage_variants.py)
STAGE_GEOMETRY = (12, 2)


def _gathered(table, idx) -> torch.Tensor:
    """(B, N, k, C) rows of ``table`` at the clamped ``idx``, by ``torch.gather``."""
    b, _, c = table.shape
    return gather_rows_plain(table, idx.reshape(b, -1)).reshape(*idx.shape, c)


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as per-channel ``(scale, shift)``."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def edgeconv_fused_stage_plain(table, idx, bvec, w2, scale_a, shift_a,
                               scale_b, shift_b) -> torch.Tensor:
    """The fused stage in plain PyTorch; (B, N, C2)."""
    e = _gathered(table, idx) + bvec[:, :, None, :]
    e = lrelu(e * scale_a + shift_a)
    h = torch.matmul(e, w2)
    return lrelu(h * scale_b + shift_b).amax(dim=2)


def edgeconv_fused_extrema_plain(table, idx, bvec, gamma, scale,
                                 shift) -> torch.Tensor:
    """The fused stage-3 extrema in plain PyTorch; (B, N, C)."""
    g = _gathered(table, idx)
    mx = g.amax(dim=2) + bvec
    mn = g.amin(dim=2) + bvec
    sel = torch.where(gamma >= 0, mx, mn)
    return lrelu(sel * scale + shift)


def _check_cuda(table, idx, bvec, vectors):
    b, n, c = table.shape
    dev = table.device
    if c != _WIDTH:
        raise ValueError(f"the CUDA stage kernels take {_WIDTH} channels, not {c}")
    if idx.ndim != 3 or idx.shape[:2] != (b, n):
        raise ValueError(f"idx {tuple(idx.shape)} does not match table {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.device != dev:
        raise ValueError(f"idx must be int32 on {dev}")
    if bvec.shape != table.shape:
        raise ValueError(f"bvec {tuple(bvec.shape)} != table {tuple(table.shape)}")
    for t in (table, bvec, *vectors):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"operands must be float32 on {dev}")
    for v in vectors:
        if v.shape != (_WIDTH,):
            raise ValueError(f"per-channel vectors must be ({_WIDTH},)")


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def smem_bytes(warps: int, nbuf: int) -> int:
    """The stage kernel's shared memory, as ``csrc/edgeconv_fused.cu::
    stage_smem_bytes`` computes it: W2 (64 x 64) and ``nbuf`` staging
    buffers per warp, each 32 gathered rows and the query's bvec at a row
    stride of 68 floats."""
    return 4 * _WIDTH * _WIDTH + warps * nbuf * _UNIT_BYTES


def launch_extrema(table, idx, bvec, vectors, grid: int = 0) -> torch.Tensor:
    """The extrema kernel on checked, contiguous CUDA tensors: ``grid``
    blocks, each a contiguous range of queries (0: one an SM). Not counted:
    :func:`edgeconv_fused_extrema` counts its launches."""
    b, n, _ = table.shape
    if idx.shape[-1] < 1 or grid < 0:
        raise ValueError(f"the extrema kernel needs k >= 1 neighbours and a grid >= 0, not "
                         f"k={idx.shape[-1]}, grid={grid}")
    out = torch.empty((b, n, _WIDTH), dtype=torch.float32, device=table.device)
    err = _build.lib().dgcnn_edgeconv_extrema(
        table.data_ptr(), idx.data_ptr(), bvec.data_ptr(),
        *(v.data_ptr() for v in vectors), out.data_ptr(), b, n, idx.shape[-1], grid,
        _stream(table.device),
    )
    _build.check(err, "edgeconv_fused_extrema")
    return out


def launch_geometry(k: int) -> tuple[int, int]:
    """``(warps, nbuf)`` of a stage-kernel launch for ``k`` neighbours:
    warps per block (one query each at a time) and staging buffers per
    warp, :data:`STAGE_GEOMETRY`. The kernel multiplies 32 gathered rows
    at a time (``k`` rows in ``ceil(k / 32)`` units), so its shared memory
    does not grow with ``k``: every ``k >= 1`` launches."""
    if k < 1:
        raise ValueError(f"the fused stage needs k >= 1 neighbours, not {k}")
    return STAGE_GEOMETRY


def launch_stage(table, idx, bvec, w2, vectors, geometry: tuple[int, int],
                 grid: int = 0) -> torch.Tensor:
    """The stage kernel on checked, contiguous CUDA tensors at ``geometry``
    (``(warps, nbuf)``); ``grid`` blocks, 0 for as many as the SMs hold at
    once. Not counted: :func:`edgeconv_fused_stage` counts its launches."""
    b, n, _ = table.shape
    warps, nbuf = geometry
    # the kernel reads rows, W2 and BN_a's vectors 16 bytes at a time
    table, bvec, w2, *vectors = (t if t.data_ptr() % 16 == 0 else t.clone()
                                 for t in (table, bvec, w2, *vectors))
    out = torch.empty((b, n, _WIDTH), dtype=torch.float32, device=table.device)
    err = _build.lib().dgcnn_edgeconv_stage(
        table.data_ptr(), idx.data_ptr(), bvec.data_ptr(), w2.data_ptr(),
        *(v.data_ptr() for v in vectors), out.data_ptr(), b, n, idx.shape[-1],
        warps, nbuf, grid, _stream(table.device),
    )
    _build.check(err, "edgeconv_fused_stage")
    return out


def edgeconv_fused_stage(table, idx, bvec, w2, scale_a, shift_a, scale_b,
                         shift_b, *, bf16_mm: bool = False) -> torch.Tensor:
    """``max_k(lrelu(BN_b(W2 @ lrelu(BN_a(table[idx] + bvec)))))`` ->
    (B, N, C2), with the gather inside the kernel.

    table, bvec: (B, N, C) first-conv terms ``x@W_d`` and ``x@(W_x-W_d)``;
    idx: (B, N, k) int32; w2: (C, C2); scale/shift: folded eval BN."""
    if bf16_mm:
        raise NotImplementedError(
            "bf16_mm: FP32 is the only compute mode of the port so far "
            "(ROADMAP Queue 1 item 12)")
    if table.device.type == "cpu":
        return edgeconv_fused_stage_plain(table, idx, bvec, w2, scale_a,
                                          shift_a, scale_b, shift_b)
    if table.device.type != "cuda":
        raise ValueError(f"edgeconv_fused_stage runs on cpu or cuda, not {table.device}")
    vectors = (scale_a, shift_a, scale_b, shift_b)
    _check_cuda(table, idx, bvec, vectors)
    if w2.shape != (_WIDTH, _WIDTH) or w2.dtype != torch.float32 or w2.device != table.device:
        raise ValueError(f"w2 must be float32 ({_WIDTH}, {_WIDTH}) on {table.device}")
    geometry = launch_geometry(idx.shape[-1])
    table, idx, bvec, w2 = (t.contiguous() for t in (table, idx, bvec, w2))
    out = launch_stage(table, idx, bvec, w2, [v.contiguous() for v in vectors], geometry)
    edgeconv_fused_stage.launches += 1
    return out


def edgeconv_fused_extrema(table, idx, bvec, gamma, scale,
                           shift) -> torch.Tensor:
    """Stage-3 fused ``lrelu(BN(select_by_sign(gamma, max_k, min_k of
    table[idx] + bvec)))`` -> (B, N, C), with the gather inside the
    kernel."""
    if table.device.type == "cpu":
        return edgeconv_fused_extrema_plain(table, idx, bvec, gamma, scale,
                                            shift)
    if table.device.type != "cuda":
        raise ValueError(f"edgeconv_fused_extrema runs on cpu or cuda, not {table.device}")
    vectors = (gamma, scale, shift)
    _check_cuda(table, idx, bvec, vectors)
    table, idx, bvec = (t.contiguous() for t in (table, idx, bvec))
    out = launch_extrema(table, idx, bvec, [v.contiguous() for v in vectors])
    edgeconv_fused_extrema.launches += 1
    return out


edgeconv_fused_stage.launches = 0
edgeconv_fused_extrema.launches = 0
