"""Fused eval EdgeConv stages with the neighbour gather inside the kernel.

Counterparts of ``dgcnn_tpu/kernels/edgeconv_pallas.py``:

* :func:`edgeconv_fused_stage` (stages 1-2):
  ``max_k lrelu(BN_b(W2 · lrelu(BN_a(table[idx] + bvec))))``; with
  ``bf16_mm`` (the model's ``compute_dtype="bfloat16"``) the second conv's
  operands are rounded to bf16 and multiplied with an FP32 result, by
  :func:`edgeconv_fused_stage_bf16`'s tensor-core kernel; with ``tf32_mm``
  (the model's ``matmul_precision="default"``) they are rounded to TF32
  (``ops/matmul.py::round_tf32``), by :func:`edgeconv_fused_stage_tf32`'s;
* :func:`edgeconv_fused_extrema` (stage 3):
  ``lrelu(scale · sel + shift)``, ``sel = (gamma >= 0 ? max_k : min_k)
  (table[idx]) + bvec``;
* :func:`fold_bn`: eval BatchNorm as per-channel (scale, shift).

Each wrapper launches its CUDA kernel (``csrc/edgeconv_fused.cu``) on CUDA
tensors, counted in ``<wrapper>.launches`` (the bf16 kernel in
``edgeconv_fused_stage_bf16.launches``, the TF32 one in
``edgeconv_fused_stage_tf32.launches``), and runs its plain PyTorch
version on CPU tensors. The plain versions build the (B, N, k, C)
gathered tensor that the kernels never write to device memory.
Neighbour indices are clamped to [0, N), as the unfused chain's gather
does. :func:`launch_geometry` picks the FP32 stage kernel's warps per block
and staging buffers, :func:`launch_geometry_bf16` the bf16 kernel's warps
and queries per block (the TF32 kernel's too); :func:`launch_stage`,
:func:`launch_stage_bf16` and :func:`launch_stage_tf32` launch them at a
given geometry; :func:`launch_extrema` launches the
extrema kernel at a given grid.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.gather_rows import gather_rows_plain
from dgcnn_tpu_torch.ops.edgeconv import lrelu
from dgcnn_tpu_torch.ops.matmul import round_tf32, rounded

_WIDTH = 64  # the kernels' table and W2 width
UNIT_ROWS = 32  # gathered rows the stage kernel's warp multiplies at once
_UNIT_BYTES = 4 * (UNIT_ROWS + 1) * (_WIDTH + 4)  # a staging buffer: rows + bvec
# (warps per block, staging buffers per warp) of every launch of the FP32
# stage kernel: 12 warps, 3 on each of the SM's 4 schedulers, the fastest
# on the H100 (scripts/exp_edgeconv_stage_variants.py)
STAGE_GEOMETRY = (12, 2)
# the bf16 stage kernel's warps a block (csrc: kBfWarps): each lane holds
# W2's fragments, 255 registers a thread, so one block of 8 warps an SM
BF16_WARPS = 8
# its shared memory: none (W2 in registers, the rows loaded straight into
# the mma fragments), so L1 takes all of the SM's on-chip memory
BF16_SMEM_BYTES = 0
# the TF32 stage kernel's warps a block (csrc: kTfWarps), one block an SM
# (254 registers a thread; W2^T's TF32 fragments and BN_a's vectors take
# 16,896 bytes of its shared memory)
TF32_WARPS = 8
H100_SMS = 132  # the H100 SXM's SMs


def _gathered(table, idx) -> torch.Tensor:
    """(B, N, k, C) rows of ``table`` at the clamped ``idx``, by ``torch.gather``."""
    b, _, c = table.shape
    return gather_rows_plain(table, idx.reshape(b, -1)).reshape(*idx.shape, c)


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as per-channel ``(scale, shift)``."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def edgeconv_fused_stage_plain(table, idx, bvec, w2, scale_a, shift_a,
                               scale_b, shift_b, *, bf16_mm: bool = False) -> torch.Tensor:
    """The fused stage in plain PyTorch; (B, N, C2). ``bf16_mm`` rounds the
    second conv's operands to bf16 and multiplies them in FP32: each
    product of two bf16 values is exact in FP32, so only the sum order
    differs from a bf16 product with an FP32 result. Before that rounding
    BN_a's ``e * scale + shift`` is rounded once, as a fused multiply-add
    (here exactly in float64, then to float32): the JAX package's stage
    computes it so on the CPU, and an ulp there would move a value across
    a bf16 rounding midpoint now and then."""
    e = _gathered(table, idx) + bvec[:, :, None, :]
    if not bf16_mm:
        e = lrelu(e * scale_a + shift_a)
        return lrelu(torch.matmul(e, w2) * scale_b + shift_b).amax(dim=2)
    e = lrelu((e.double() * scale_a.double() + shift_a.double()).float())
    h = torch.matmul(rounded(e, torch.bfloat16), rounded(w2, torch.bfloat16))
    return lrelu(h * scale_b + shift_b).amax(dim=2)


def edgeconv_fused_stage_tf32_plain(table, idx, bvec, w2, scale_a, shift_a, scale_b,
                                    shift_b) -> torch.Tensor:
    """The TF32 stage in plain PyTorch: the FP32 chain (BN_a as two
    roundings, as the FP32 kernel computes it) with the activated rows and
    W2 rounded to TF32 by :func:`round_tf32` and multiplied in FP32 (TF32
    off, as the package sets): each product of two TF32 values is exact in
    FP32, so only the sum order differs from the kernel's."""
    e = _gathered(table, idx) + bvec[:, :, None, :]
    e = lrelu(e * scale_a + shift_a)
    h = torch.matmul(round_tf32(e), round_tf32(w2))
    return lrelu(h * scale_b + shift_b).amax(dim=2)


def stage_bf16_tolerance(table, idx, bvec, w2, scale_a, shift_a, scale_b) -> torch.Tensor:
    """(B, N, C2) bound on ``|kernel - plain|`` of the bf16 stage: both sum
    a row's 64 exact bf16 products in FP32, in different orders (the
    tensor cores a k-step at once, truncating), and a sum of n terms in any
    order is within (n - 1) ulps of its terms' absolute sum ``S``; so each
    output is within ``2^-16 |scale_b| max_k S`` of the other (two sums'
    2 * 63 * 2^-23 < 2^-16, BN_b's scale on top; the max over k and the
    monotone epilogue add nothing)."""
    e = _gathered(table, idx) + bvec[:, :, None, :]
    e = lrelu((e.double() * scale_a.double() + shift_a.double()).float())
    s = torch.matmul(rounded(e, torch.bfloat16).abs(),
                     rounded(w2, torch.bfloat16).abs()).amax(dim=2)
    return 2.0 ** -16 * scale_b.abs() * s


def stage_tf32_tolerance(table, idx, bvec, w2, scale_a, shift_a, scale_b,
                         shift_b) -> torch.Tensor:
    """(B, N, C2) bound on ``|kernel - plain|`` of the TF32 stage: both sum
    a row's 64 exact TF32 products in FP32 in different orders (the tensor
    cores eight at a time, truncating), so, as for
    :func:`stage_bf16_tolerance`, the two sums lie within ``2^-16 S`` of
    each other, ``S`` the absolute sum ``|e| . |W2|`` of the rounded
    operands, and BN_b's scale multiplies that; BN_b's two roundings, the
    same monotone maps on both sides, add at most an FP32 ulp each of their
    result, within ``2^-22 (|scale_b| S + |shift_b|)``."""
    e = _gathered(table, idx) + bvec[:, :, None, :]
    e = lrelu(e * scale_a + shift_a)
    s = torch.matmul(round_tf32(e).abs(), round_tf32(w2).abs()).amax(dim=2)
    return 2.0 ** -16 * scale_b.abs() * s + 2.0 ** -22 * (scale_b.abs() * s + shift_b.abs())


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
    """The FP32 stage kernel's shared memory, as ``csrc/edgeconv_fused.cu::
    stage_smem_bytes`` computes it: W2 (64 x 64) and ``nbuf`` staging
    buffers per warp, each 32 gathered rows and the query's bvec at a row
    stride of 68 floats. The bf16 kernel takes none (:data:`BF16_SMEM_BYTES`)."""
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
    """``(warps, nbuf)`` of an FP32 stage-kernel launch for ``k`` neighbours:
    warps per block (one query each at a time) and staging buffers per
    warp, :data:`STAGE_GEOMETRY`. The kernel multiplies 32 gathered rows
    at a time (``k`` rows in ``ceil(k / 32)`` units), so its shared memory
    does not grow with ``k``: every ``k >= 1`` launches."""
    if k < 1:
        raise ValueError(f"the fused stage needs k >= 1 neighbours, not {k}")
    return STAGE_GEOMETRY


def launch_geometry_bf16(b: int, n: int, k: int, sms: int = H100_SMS) -> tuple[int, int]:
    """``(warps, per)`` of a bf16 stage-kernel launch on ``b * n`` queries of
    ``k`` neighbours on a card of ``sms`` SMs: :data:`BF16_WARPS` warps a
    block and ``per`` queries a block, a contiguous range, so that one block
    runs on each SM (``ceil(b * n / per)`` blocks, the last range shorter
    where ``per`` does not divide ``b * n``). The kernel takes no shared
    memory (:data:`BF16_SMEM_BYTES`), so no budget bounds it, and its
    registers do not grow with ``k`` (32 rows at a time): every ``k >= 1``
    launches."""
    if k < 1:
        raise ValueError(f"the fused stage needs k >= 1 neighbours, not {k}")
    if b * n < 1 or sms < 1:
        raise ValueError(f"no queries to launch for: b={b}, n={n}, sms={sms}")
    return BF16_WARPS, -(-(b * n) // sms)


def launch_stage(table, idx, bvec, w2, vectors, geometry: tuple[int, int],
                 grid: int = 0) -> torch.Tensor:
    """The FP32 stage kernel on checked, contiguous CUDA tensors at
    ``geometry`` (``(warps, nbuf)``); ``grid`` blocks, 0 for as many as the
    SMs hold at once. Not counted: the wrapper counts its launches."""
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


def launch_stage_bf16(table, idx, bvec, w2, vectors,
                      geometry: tuple[int, int]) -> torch.Tensor:
    """The bf16 stage kernel on checked, contiguous CUDA tensors at
    ``geometry`` (``(warps, per)``: warps a block, queries a block). Not
    counted: :func:`edgeconv_fused_stage_bf16` counts its launches."""
    b, n, _ = table.shape
    warps, per = geometry
    # the kernel reads rows, bvec and BN_a's vectors 8 bytes at a time
    table, bvec, *vectors = (t if t.data_ptr() % 8 == 0 else t.clone()
                             for t in (table, bvec, *vectors))
    out = torch.empty((b, n, _WIDTH), dtype=torch.float32, device=table.device)
    err = _build.lib().dgcnn_edgeconv_stage_bf16(
        table.data_ptr(), idx.data_ptr(), bvec.data_ptr(), w2.data_ptr(),
        *(v.data_ptr() for v in vectors), out.data_ptr(), b, n, idx.shape[-1],
        warps, per, _stream(table.device),
    )
    _build.check(err, "edgeconv_fused_stage_bf16")
    return out


def launch_stage_tf32(table, idx, bvec, w2, vectors,
                      geometry: tuple[int, int]) -> torch.Tensor:
    """The TF32 stage kernel on checked, contiguous CUDA tensors at
    ``geometry`` (``(warps, per)``, as :func:`launch_geometry_bf16` gives it
    with :data:`TF32_WARPS`). Not counted: :func:`edgeconv_fused_stage_tf32`
    counts its launches."""
    b, n, _ = table.shape
    warps, per = geometry
    # the kernel reads rows, bvec and BN_a's vectors 16 bytes at a time
    table, bvec, *vectors = (t if t.data_ptr() % 16 == 0 else t.clone()
                             for t in (table, bvec, *vectors))
    out = torch.empty((b, n, _WIDTH), dtype=torch.float32, device=table.device)
    err = _build.lib().dgcnn_edgeconv_stage_tf32(
        table.data_ptr(), idx.data_ptr(), bvec.data_ptr(), w2.data_ptr(),
        *(v.data_ptr() for v in vectors), out.data_ptr(), b, n, idx.shape[-1],
        warps, per, _stream(table.device),
    )
    _build.check(err, "edgeconv_fused_stage_tf32")
    return out


def _launch_checked(table, idx, bvec, w2, vectors, mode: str) -> torch.Tensor:
    """Check the operands of a stage-kernel launch and launch the ``mode``
    ("fp32", "bf16" or "tf32") kernel."""
    _check_cuda(table, idx, bvec, vectors)
    if w2.shape != (_WIDTH, _WIDTH) or w2.dtype != torch.float32 or w2.device != table.device:
        raise ValueError(f"w2 must be float32 ({_WIDTH}, {_WIDTH}) on {table.device}")
    table, idx, bvec, w2 = (t.contiguous() for t in (table, idx, bvec, w2))
    vectors = [v.contiguous() for v in vectors]
    b, n, k = idx.shape
    if mode == "fp32":
        return launch_stage(table, idx, bvec, w2, vectors, launch_geometry(k))
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    _, per = launch_geometry_bf16(b, n, k, sms)
    if mode == "bf16":
        return launch_stage_bf16(table, idx, bvec, w2, vectors, (BF16_WARPS, per))
    return launch_stage_tf32(table, idx, bvec, w2, vectors, (TF32_WARPS, per))


def _stage_on(mode: str, plain, wrapper, args) -> torch.Tensor:
    """A stage wrapper's body: the plain version on CPU tensors, the
    ``mode`` kernel on CUDA ones (counted on ``wrapper``)."""
    table = args[0]
    if table.device.type == "cpu":
        return plain(*args)
    if table.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {table.device}")
    out = _launch_checked(*args[:4], args[4:], mode)
    wrapper.launches += 1
    return out


def edgeconv_fused_stage_bf16(table, idx, bvec, w2, scale_a, shift_a, scale_b,
                              shift_b) -> torch.Tensor:
    """:func:`edgeconv_fused_stage` with ``bf16_mm``: the activated rows and
    W2 rounded to bf16 (to nearest even), their product on the tensor cores
    with an FP32 result; gather, BN, LeakyReLU and max in FP32. The kernel
    on CUDA tensors (counted here), the plain version on CPU tensors."""
    return _stage_on("bf16", functools.partial(edgeconv_fused_stage_plain, bf16_mm=True),
                     edgeconv_fused_stage_bf16,
                     (table, idx, bvec, w2, scale_a, shift_a, scale_b, shift_b))


def edgeconv_fused_stage_tf32(table, idx, bvec, w2, scale_a, shift_a, scale_b,
                              shift_b) -> torch.Tensor:
    """:func:`edgeconv_fused_stage` with ``tf32_mm``: the activated rows and
    W2 rounded to TF32 (:func:`round_tf32`), their product on the tensor
    cores with FP32 sums; gather, BN, LeakyReLU and max in FP32. The kernel
    on CUDA tensors (counted here), the plain version on CPU tensors."""
    return _stage_on("tf32", edgeconv_fused_stage_tf32_plain, edgeconv_fused_stage_tf32,
                     (table, idx, bvec, w2, scale_a, shift_a, scale_b, shift_b))


def edgeconv_fused_stage(table, idx, bvec, w2, scale_a, shift_a, scale_b,
                         shift_b, *, bf16_mm: bool = False,
                         tf32_mm: bool = False) -> torch.Tensor:
    """``max_k(lrelu(BN_b(W2 @ lrelu(BN_a(table[idx] + bvec)))))`` ->
    (B, N, C2), with the gather inside the kernel.

    table, bvec: (B, N, C) first-conv terms ``x@W_d`` and ``x@(W_x-W_d)``;
    idx: (B, N, k) int32; w2: (C, C2); scale/shift: folded eval BN.
    ``bf16_mm``: the second conv in bf16 with an FP32 result, by
    :func:`edgeconv_fused_stage_bf16`; ``tf32_mm``: in TF32, by
    :func:`edgeconv_fused_stage_tf32` (each counts its own launches)."""
    args = (table, idx, bvec, w2, scale_a, shift_a, scale_b, shift_b)
    if bf16_mm and tf32_mm:
        raise ValueError("bf16_mm and tf32_mm are exclusive")
    if bf16_mm:
        return edgeconv_fused_stage_bf16(*args)
    if tf32_mm:
        return edgeconv_fused_stage_tf32(*args)
    return _stage_on("fp32", edgeconv_fused_stage_plain, edgeconv_fused_stage, args)


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
edgeconv_fused_stage_bf16.launches = 0
edgeconv_fused_stage_tf32.launches = 0
edgeconv_fused_extrema.launches = 0
