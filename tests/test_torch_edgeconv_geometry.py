"""The fused stage kernel's launch geometry and its epilogue, on the CPU.

``launch_geometry`` is pure Python; the kernel (``csrc/edgeconv_fused.cu``)
runs only on a card. Its epilogue takes the max over a query's rows before
BN_b and the LeakyReLU, on W2 columns negated where the scale is negative,
and keeps the per-row order for lanes whose channels are not all regular:
``_kernel_epilogue`` mirrors that arithmetic in float32 PyTorch, and is held
equal to the replaced kernel's order (BN_b and LeakyReLU on every row, then
the max) on inputs with NaN and infinite rows, zero and non-finite scales
and non-finite shifts. The bf16 kernel (``edgeconv_stage_bf16_kernel``)
keeps the same rule, chosen for the whole warp: the max before BN_b where
all 64 channels are regular, else BN_b on every row. Its geometry
(``launch_geometry_bf16``: 8 warps, a contiguous range of queries a block)
takes no shared memory; ``tests/test_torch_edgeconv_bf16_layout.py`` pins
it at its edges."""

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels.edgeconv_fused import (
    BF16_SMEM_BYTES,
    BF16_WARPS,
    STAGE_GEOMETRY,
    launch_geometry,
    launch_geometry_bf16,
    smem_bytes,
)
from dgcnn_tpu_torch.kernels.knn_banded import SMEM_LIMIT

# the replaced kernel held 8 queries' k rows (padded to a multiple of 8),
# 256 bytes each, beside W2 in shared memory: it launched for k <= 104
_REPLACED_K_MAX = 104


KS = [1, 8, 20, 30, 32, 33, 40, 64, 103, _REPLACED_K_MAX, 105, 1000]


@pytest.mark.parametrize("k", KS)
def test_every_k_fits(k):
    """The shared memory does not grow with k: every k the replaced kernel
    took, and every larger one, gets a geometry within the limit."""
    warps, nbuf = launch_geometry(k)
    assert smem_bytes(warps, nbuf) <= SMEM_LIMIT
    assert 1 <= warps <= 12 and 1 <= nbuf <= 2


@pytest.mark.parametrize("k", KS)
def test_every_k_fits_bf16(k):
    """The bf16 kernel's geometry does not grow with k, and it takes no
    shared memory."""
    warps, per = launch_geometry_bf16(1, 7000, k)
    assert (warps, per) == (BF16_WARPS, 54) and 1 <= warps <= 8
    assert BF16_SMEM_BYTES == 0 <= SMEM_LIMIT


@pytest.mark.parametrize("k", [0, -1])
def test_k_below_one_raises(k):
    with pytest.raises(ValueError, match="k >= 1"):
        launch_geometry(k)


def test_geometry_at_the_production_shape():
    """B=8, N=7000, k=30: 12 warps a block, 2 staging buffers a warp, one
    231 808-byte block per SM."""
    assert launch_geometry(30) == (12, 2) == STAGE_GEOMETRY
    assert smem_bytes(12, 2) == 231808 <= SMEM_LIMIT
    # the bf16 kernel: 8 warps and 425 queries a block (132 blocks, one an
    # SM), W2 in registers, no shared memory
    assert launch_geometry_bf16(8, 7000, 30) == (8, 425)


def test_smem_bytes_matches_the_source():
    """``smem_bytes`` restates ``stage_smem_bytes`` of the source: W2 and
    ``warps * nbuf`` buffers of (32 + 1) rows of 68 floats."""
    src = (_build.CSRC / "edgeconv_fused.cu").read_text()
    for line in ("constexpr int kUnitRows = 32;", "constexpr int kRowStride = kC + 4;",
                 "constexpr int kUnitFloats = (kUnitRows + 1) * kRowStride;",
                 "constexpr int kMaxStageWarps = 12;", "constexpr int kMaxBuffers = 2;",
                 "return sizeof(float) * ((size_t)kC * kC + (size_t)warps * nbuf * kUnitFloats);",
                 f"constexpr int kBfWarps = {BF16_WARPS};"):
        assert line in src, line
    # the largest geometry the launcher takes fits a Hopper block
    assert smem_bytes(12, 2) <= SMEM_LIMIT


def _lrelu(v):
    return torch.where(v >= 0, v, 0.2 * v)


def _affine(v, s, t):
    return v * s + t  # two float32 ops, each rounded


def _fmax_rows(v):
    """fmaxf over dim 1 from -inf: NaN rows are skipped."""
    m = torch.full_like(v[:, 0], float("-inf"))
    for j in range(v.shape[1]):
        m = torch.fmax(m, v[:, j])
    return m


def _replaced_epilogue(h, s, t):
    return _fmax_rows(_lrelu(_affine(h, s, t)))


# the channels that share the choice of the max before BN_b: the FP32
# kernel's lane (rg, cg) holds channels 4cg..4cg+3 and 32+4cg..32+4cg+3 (8
# groups); the bf16 kernel chooses for its whole warp (one group of 64)
LANE_GROUPS = {"fp32": (lambda c: c % 32 // 4, 8), "bf16": (lambda c: 0, 1)}


def _kernel_epilogue(h, s, t, kernel="fp32"):
    """The kernel's epilogue: h (Q, rows, 64) accumulators of W2's columns
    as loaded (negated where ``flipped``), a lane fast when all the
    channels of its group (:data:`LANE_GROUPS`) are regular."""
    regular = torch.isfinite(s) & (s != 0) & torch.isfinite(t)
    flipped = regular & (s < 0)
    hp = torch.where(flipped, -h, h)  # the chain of -W2 is -h
    sp = torch.where(flipped, -s, s)
    group, n_groups = LANE_GROUPS[kernel]
    lane_of = torch.tensor([group(c) for c in range(64)])
    fast = torch.stack([regular[lane_of == g].all() for g in range(n_groups)])[lane_of]
    out_fast = _lrelu(_affine(_fmax_rows(hp), sp, t))
    out_slow = _fmax_rows(_lrelu(_affine(hp, sp, t)))
    return torch.where(fast, out_fast, out_slow)


@pytest.mark.parametrize("special", [False, True])
def test_epilogue_max_first_equals_replaced_order(special, kernel="fp32"):
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.standard_normal((64, 32, 64)).astype(np.float32) * 4)
    s = torch.from_numpy((rng.uniform(0.5, 1.5, 64) * rng.choice([-1.0, 1.0], 64))
                         .astype(np.float32))
    t = torch.from_numpy(rng.normal(0.0, 0.5, 64).astype(np.float32))
    h[:, 3] = h[:, 5]  # repeated rows (the padding)
    if special:
        h[0, :, :] = float("nan")          # a query with no row left
        h[1, 7] = float("nan")             # NaN rows
        h[2, 4] = float("inf")
        h[3, 9] = float("-inf")
        h[4, :, 5] = 0.0
        s[1], s[2], s[3] = 0.0, -0.0, float("inf")      # irregular scales
        s[40], t[41], t[42] = float("nan"), float("-inf"), float("nan")
        t[43] = float("inf")
    got = _kernel_epilogue(h, s, t, kernel)
    want = _replaced_epilogue(h, s, t)
    # equal as floats (NaN where both are NaN): a zero's sign may differ
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


@pytest.mark.parametrize("special", [False, True])
def test_bf16_epilogue_max_first_equals_replaced_order(special):
    """The same rule in the bf16 kernel, chosen for all 64 channels at once."""
    test_epilogue_max_first_equals_replaced_order(special, kernel="bf16")
