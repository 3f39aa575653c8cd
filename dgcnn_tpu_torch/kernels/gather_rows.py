"""Row gather of the training forward: the Hopper kernel and its plain
PyTorch version.

Counterpart of ``dgcnn_tpu/kernels/gather_pallas.py::gather_rows``
(kernel ``_kernel``): ``out[b, m] = table[b, idx[b, m]]``. The JAX
package reaches it from ``ops/edgeconv.py::_gather_impl`` when the
environment sets ``DGCNN_GATHER_IMPL=pallas``; the port's
``ops/edgeconv.py::_gather`` sends every gather of the training forward
here (stages 1-2 in ``gather_neighbors``, stage 3 in
``edge_stage_tail_train``), with no knob: the kernel returns
``torch.gather``'s bits and is faster at both widths the port runs
(``scripts/torch_row_kernels.py``, B=8, M=210000, kNN-of-blocks and
uniform indices, on an H100 80GB HBM3 at 700 W: 0.0125-0.0170 against
0.0302-0.0304 ms at C=4, 0.156-0.160 against 0.317-0.318 ms at C=64).

:func:`gather_rows` launches the CUDA kernel (``csrc/gather_rows.cu``) on
CUDA tensors, counted in ``gather_rows.launches``, and runs
:func:`gather_rows_plain` on CPU tensors. Indices are clamped to [0, N),
as the port's plain gather and its backward scatters clamp them (the TPU
kernel reads a zero padding row for an index in [N, n_pad) instead).
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import _build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather in plain PyTorch: ``torch.gather`` on the clamped
    indices. (B, M, C)."""
    b, n, c = table.shape
    flat = idx.long().clamp(0, n - 1).reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(table, 1, flat)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, m] = table[b, clamp(idx[b, m], 0, N - 1)]``: table (B, N, C)
    float32, idx (B, M) int -> (B, M, C). Launches the CUDA kernel on CUDA
    tensors (idx int32) and the plain version on CPU tensors."""
    if table.ndim != 3 or idx.ndim != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"table {tuple(table.shape)} and idx {tuple(idx.shape)} do not match")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {table.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32 or idx.device != table.device:
        raise ValueError(f"table must be float32 and idx int32, both on {table.device}")
    b, n, c = table.shape
    m = idx.shape[1]
    table, idx = table.contiguous(), idx.contiguous()
    out = torch.empty((b, m, c), dtype=torch.float32, device=table.device)
    err = _build.lib().dgcnn_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, m, n, c,
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream))
    _build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
