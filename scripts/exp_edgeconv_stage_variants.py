"""Build variants of the fused stage kernels (``csrc/edgeconv_fused.cu`` with
a constant or a line changed) and time them beside each other, on one GPU.

    python scripts/exp_edgeconv_stage_variants.py [--ceiling] [NAME ...]
    python scripts/exp_edgeconv_stage_variants.py --bf16 [--root DIR] [--sharing] [NAME ...]
    python scripts/exp_edgeconv_stage_variants.py --tf32 [--root DIR] [--sharing] [NAME ...]

Each variant is a list of text replacements (``shipped`` has none) applied
to a copy of ``csrc/`` under ``build/edgeconv_stage_variants/NAME/``; the
copy's ``edgeconv_fused.cu`` and ``knn_capped.cu`` (which holds the
error-string entry point) are compiled with the port's flags into one
library, all variants at once. The script prints the compiler's register
and spill lines of the kernel's instances, holds each variant's output
``torch.equal`` to the shipped kernel's (except the ``diag_`` variants,
which leave a part of the kernel out to see what it costs), and times it
device-only (``chip_smoke.cuda_ms_many`` of the kernel's launcher).

The FP32 kernel (``VARIANTS``) is timed at the production shape (B=8,
N=7000, k=30, ``knn_capped`` indices: the first of
``chip_smoke.stage_cases``) at the geometries of ``GEOMETRIES``.
``--ceiling`` also times cuBLAS FP32 SGEMM at 8192^3 (what FP32 SIMT
reaches on the card) and samples the SM clock and power while it and the
stage kernel run.

``--bf16`` times the bf16 kernel (``edgeconv_stage_bf16_kernel``) on the
four production cases of ``chip_smoke.stage_cases`` (``knn_capped``,
banded stage 1 and 2, the default forward's stage-3 indices), at its
wrapper's geometry and at ``BF16_GEOMETRIES``. ``--root DIR`` takes the
package and the sources of another checkout (unpacked with ``git
archive``): a checkout whose bf16 kernel is the first design (warps a
grid apart, cp.async staging, no ``launch_geometry_bf16`` in its wrapper)
gets ``FIRST_BF16_VARIANTS``, one with the present design
``BF16_VARIANTS``. ``--sharing`` also prints, per case, the share of
distinct rows among Q = 32, 64 and 128 consecutive queries' indices
(``scripts/torch_edgeconv_fused.py::sharing``). ``--tf32`` does the same
for the TF32 kernel (``edgeconv_stage_tf32_kernel``) with
``TF32_VARIANTS``: what each part costs, the W2 fragments' shared-memory
reads, the activations rounded by the integer rule, how many fragments
the lanes hold in registers, the next unit's rows loaded before the
products, 12 warps a block, and the unit's n-tiles activated two or four
at a time and then multiplied m-tile by m-tile (the order the redesign
tried first). Without names it runs every variant of the chosen set.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

import kernel_variants as kv  # noqa: E402

_DK_LOOP = "#pragma unroll 2\n    for (int dk = 0; dk < kC / 4; ++dk) {"
VARIANTS = {
    "shipped": [],
    # the product's 4-channel steps unrolled 1, 4 and 16 (fully) times
    "unroll1": [(_DK_LOOP, _DK_LOOP.replace("unroll 2", "unroll 1"))],
    "unroll4": [(_DK_LOOP, _DK_LOOP.replace("unroll 2", "unroll 4"))],
    "unroll16": [(_DK_LOOP, _DK_LOOP.replace("unroll 2", "unroll"))],
    # what each part costs: no product, no transform, no gather, neither
    "diag_no_product": [(_DK_LOOP, _DK_LOOP.replace("dk < kC / 4", "dk < 0"))],
    "diag_no_transform": [("for (int i = 0; i < kUnitRows / 2; ++i) {\n        float4 v",
                           "for (int i = 0; i < 0; ++i) {\n        float4 v")],
    "diag_no_gather": [("    cp_async16(buf + r * kRowStride + 4 * c4, tab + (size_t)row * kC"
                        " + 4 * c4, true);", "    (void)row;")],
    # what the product's shared-memory reads cost: W2's (or the tile's)
    # operands read once per unit instead of per channel step
    "diag_w_reg": [("const float4 wa = w4[(4 * dk + x) * (kC / 4)];\n"
                    "        const float4 wb = w4[(4 * dk + x) * (kC / 4) + 8];",
                    "const float4 wa = w4[x * (kC / 4)];\n"
                    "        const float4 wb = w4[x * (kC / 4) + 8];")],
    "diag_e_reg": [("e[i] = e4[4 * i * kRowStride4 + dk];", "e[i] = e4[4 * i * kRowStride4];")],
    # the gather's 16-byte copies allocated in L1 as well as L2 (neighbour
    # rows shared by the block's queries)
    "gather_ca": [
        ("// cp.async of a unit's 32 rows",
         "__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem) {\n"
         "  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));\n"
         "  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 16;\\n\" ::\"r\"(s), "
         "\"l\"(gmem) : \"memory\");\n}\n\n// cp.async of a unit's 32 rows"),
        ("    cp_async16(buf + r * kRowStride + 4 * c4, tab + (size_t)row * kC + 4 * c4, true);",
         "    cp_async16_ca(buf + r * kRowStride + 4 * c4, tab + (size_t)row * kC + 4 * c4);")],
    "diag_product_only": [
        ("for (int i = 0; i < kUnitRows / 2; ++i) {\n        float4 v",
         "for (int i = 0; i < 0; ++i) {\n        float4 v"),
        ("    cp_async16(buf + r * kRowStride + 4 * c4, tab + (size_t)row * kC + 4 * c4, true);",
         "    (void)row;")],
}
# the product loop as shipped, and two rewrites of it
_FMAS = """        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(ev(i), wa.x, acc[i][0]);
          acc[i][1] = fmaf(ev(i), wa.y, acc[i][1]);
          acc[i][2] = fmaf(ev(i), wa.z, acc[i][2]);
          acc[i][3] = fmaf(ev(i), wa.w, acc[i][3]);
          acc[i][4] = fmaf(ev(i), wb.x, acc[i][4]);
          acc[i][5] = fmaf(ev(i), wb.y, acc[i][5]);
          acc[i][6] = fmaf(ev(i), wb.z, acc[i][6]);
          acc[i][7] = fmaf(ev(i), wb.w, acc[i][7]);
        }"""
_LOOP = """#pragma unroll 2
    for (int dk = 0; dk < kC / 4; ++dk) {
      float4 e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = e4[4 * i * kRowStride4 + dk];
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // input channel d = 4 dk + x, in order
        const float4 wa = w4[(4 * dk + x) * (kC / 4)];
        const float4 wb = w4[(4 * dk + x) * (kC / 4) + 8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ev = x == 0 ? e[i].x : x == 1 ? e[i].y : x == 2 ? e[i].z : e[i].w;
          acc[i][0] = fmaf(ev, wa.x, acc[i][0]);
          acc[i][1] = fmaf(ev, wa.y, acc[i][1]);
          acc[i][2] = fmaf(ev, wa.z, acc[i][2]);
          acc[i][3] = fmaf(ev, wa.w, acc[i][3]);
          acc[i][4] = fmaf(ev, wb.x, acc[i][4]);
          acc[i][5] = fmaf(ev, wb.y, acc[i][5]);
          acc[i][6] = fmaf(ev, wb.z, acc[i][6]);
          acc[i][7] = fmaf(ev, wb.w, acc[i][7]);
        }
      }
    }"""
# the tile's next 4 channels read one step ahead (registers double-buffered)
_PIPE = """    float4 e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = e4[4 * i * kRowStride4];
#pragma unroll 2
    for (int dk = 0; dk < kC / 4; ++dk) {
      float4 en[8];
      const int dn = dk + 1 < kC / 4 ? dk + 1 : dk;
#pragma unroll
      for (int i = 0; i < 8; ++i) en[i] = e4[4 * i * kRowStride4 + dn];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 wa = w4[(4 * dk + x) * (kC / 4)];
        const float4 wb = w4[(4 * dk + x) * (kC / 4) + 8];
        auto ev = [&](int i) {
          return x == 0 ? e[i].x : x == 1 ? e[i].y : x == 2 ? e[i].z : e[i].w;
        };
#pragma unroll
""" + _FMAS + """
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = en[i];
    }"""
# two channels a read of the tile (8-byte loads): fewer registers, for 16 warps
_HALF = """    const float2* e2 = reinterpret_cast<const float2*>(e4);
#pragma unroll 2
    for (int dh = 0; dh < kC / 2; ++dh) {
      float2 e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = e2[8 * i * kRowStride4 + dh];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float4 wa = w4[(2 * dh + x) * (kC / 4)];
        const float4 wb = w4[(2 * dh + x) * (kC / 4) + 8];
        auto ev = [&](int i) { return x == 0 ? e[i].x : e[i].y; };
#pragma unroll
""" + _FMAS + """
      }
    }"""
VARIANTS["pipe"] = [(_LOOP, _PIPE)]
VARIANTS["half"] = [(_LOOP, _HALF)]
# a 16-warp launch bound (128 registers a thread), alone and with `half`
_WARPS16 = ("constexpr int kMaxStageWarps = 12;", "constexpr int kMaxStageWarps = 16;")
VARIANTS["warps16"] = [_WARPS16]
VARIANTS["half16"] = [(_LOOP, _HALF), _WARPS16]

# (warps, nbuf, grid) timed for every variant; grid 0 is the persistent grid
GEOMETRIES = [(8, 2, 0), (10, 2, 0), (12, 1, 0), (12, 2, 0)]
WARPS16 = {"warps16", "half16"}  # these also run 16 warps with one buffer

# The first bf16 design (a checkout whose wrapper has no
# launch_geometry_bf16): what the gather, the transform and the product
# each cost, the gather's 16-byte copies allocated in L1, and a contiguous
# range of queries a block (its warps on neighbouring queries) in that frame
FIRST_BF16_VARIANTS = {
    "shipped": [],
    "diag_no_gather": VARIANTS["diag_no_gather"],
    "diag_no_transform": [("for (int h = 0; h < 2; ++h) {  // rows 0..15, then 16..31",
                           "for (int h = 0; h < 0; ++h) {  // rows 0..15, then 16..31")],
    "diag_no_product": [("    for (int ks = 0; ks < kC / 16; ++ks) {\n      uint32_t a0[4], a1[4];",
                         "    for (int ks = 0; ks < 0; ++ks) {\n      uint32_t a0[4], a1[4];")],
    "gather_ca": VARIANTS["gather_ca"],
    "contiguous": [(
        "  const int rows = B * N;  // at most INT_MAX / 8 (the launcher): q + 3G stays an int\n"
        "  const int G = gridDim.x * warps;\n"
        "  const int nch = (K + kUnitRows - 1) / kUnitRows;\n"
        "  Unit cur{(int)blockIdx.x * warps + warp, 0, 0};  // the unit multiplied\n"
        "  Unit st = cur;                                   // the next unit staged\n"
        "  int nb = st.q < rows ? unit_index(idx, st.q, st.c, K, N, lane) : 0;  // st's rows\n"
        "  auto stage_next = [&]() {",
        "  const int per = (B * N + gridDim.x - 1) / gridDim.x;\n"
        "  const int rows = min(B * N, (int)blockIdx.x * per + per);  // this block's end\n"
        "  const int G = warps;\n"
        "  const int nch = (K + kUnitRows - 1) / kUnitRows;\n"
        "  Unit cur{(int)blockIdx.x * per + warp, 0, 0};  // the unit multiplied\n"
        "  Unit st = cur;                                   // the next unit staged\n"
        "  int nb = st.q < rows ? unit_index(idx, st.q, st.c, K, N, lane) : 0;  // st's rows\n"
        "  auto stage_next = [&]() {")],
}
_BF16_NEXT_LOAD = ("      load_share(x[j], tab1 + (size_t)__shfl_sync(kFull, nb1, 8 * j + g) * kC, "
                   "t);")
_BF16_ACT = ("        b[s][0] = activate(x[j][s][0], bv[s][0], L.sa[s][0], L.ta[s][0]);\n"
             "        b[s][1] = activate(x[j][s][1], bv[s][1], L.sa[s][1], L.ta[s][1]);")
_BF16_BARE = ("        b[s][0] = pack_bf16(x[j][s][0].x, x[j][s][0].y);\n"
              "        b[s][1] = pack_bf16(x[j][s][1].x, x[j][s][1].y);")
_BF16_MMA = "for (int s = 0; s < 4; ++s) mma_bf16(d[m], L.a[m][s], b[s][0], b[s][1]);"
_BF16_NO_MMA = ("for (int s = 0; s < 4; ++s) d[m][s] = __uint_as_float(L.a[m][s][0] ^ b[s][0] ^ "
                "b[s][1]);")
_LOAD_SHARE = ("    p[s][0] = kStream ? __ldcs(r2 + 8 * s) : __ldg(r2 + 8 * s);\n"
               "    p[s][1] = kStream ? __ldcs(r2 + 8 * s + 4) : __ldg(r2 + 8 * s + 4);")
_ROW_LOADS = (
    _BF16_NEXT_LOAD,
    "{\n#pragma unroll\n        for (int r = 0; r < 8; ++r)\n          x[j][r / 2][r % 2] = "
    "__ldg(reinterpret_cast<const float2*>(tab1 + (size_t)__shfl_sync(kFull, nb1, 8 * j + r) "
    "* kC) + L.lane);\n      }")
# The present bf16 design: each part left out (the gather keeps the first
# unit's rows; the transform becomes a bare bf16 pack; the product a xor
# that keeps its operands alive), alone or in pairs, half the products (two
# k-steps of four: what the tensor cores' mma.sync rate costs), the rows
# read past L1 (L2 only: what L1's reuse is worth), each load a whole row
# (256 bytes, two lines) instead of 32 bytes of eight rows (the rows land
# in the wrong lanes: the access pattern alone), and the products issued
# k-step by k-step across the m-tiles (each accumulator's chain still
# k-steps 0..3 in order)
BF16_VARIANTS = {
    "shipped": [],
    "diag_no_gather": [(_BF16_NEXT_LOAD, "      (void)tab1;")],
    "diag_no_transform": [(_BF16_ACT, _BF16_BARE)],
    "diag_no_product": [(_BF16_MMA, _BF16_NO_MMA)],
    "diag_gather_only": [(_BF16_ACT, _BF16_BARE), (_BF16_MMA, _BF16_NO_MMA)],
    "diag_product_only": [(_BF16_NEXT_LOAD, "      (void)tab1;"), (_BF16_ACT, _BF16_BARE)],
    "diag_activation_only": [(_BF16_NEXT_LOAD, "      (void)tab1;"), (_BF16_MMA, _BF16_NO_MMA)],
    "diag_half_product": [(_BF16_MMA, _BF16_MMA.replace("s < 4", "s < 2"))],
    "diag_rows_past_l1": [(_LOAD_SHARE, _LOAD_SHARE.replace("__ldg(", "__ldcg("))],
    "diag_row_loads": [_ROW_LOADS],
    "s_outer": [("#pragma unroll\n      for (int m = 0; m < 4; ++m) {\n"
                 "        d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;\n#pragma unroll\n"
                 "        " + _BF16_MMA + "\n      }",
                 "#pragma unroll\n      for (int m = 0; m < 4; ++m) d[m][0] = d[m][1] = d[m][2] = "
                 "d[m][3] = 0.f;\n#pragma unroll\n      for (int s = 0; s < 4; ++s)\n"
                 "#pragma unroll\n        for (int m = 0; m < 4; ++m) "
                 "mma_bf16(d[m], L.a[m][s], b[s][0], b[s][1]);")],
}
# The TF32 design: each part left out as for BF16_VARIANTS (the products
# replaced by a xor that keeps their operands alive); no shared reads in the
# unit loop (every m-tile multiplied by m-tile 0's fragments, held in
# registers); the activations rounded by the integer rule (tf32_bits, seven
# integer instructions) instead of the card's conversion; none, a half, one
# and a half or two m-tiles' fragments held in registers for the walk
# instead of one; the next unit's rows loaded as the first design did,
# each n-tile's right after its activation, before its products, instead
# of after all the products (more registers in flight); 12 warps a
# block (168 registers a thread) with no fragment held; and the unit's
# n-tiles activated two or four at a time and then multiplied m-tile by
# m-tile, k-step by k-step, n-tile by n-tile (at four, each fragment read
# once a unit whatever the compiler keeps)
_TF32_ACT = """        b[2 * i][0] = tf32_rn(lrelu(affine(__fadd_rn(v.x, bb.x), s.x, h.x)));
        b[2 * i][1] = tf32_rn(lrelu(affine(__fadd_rn(v.y, bb.y), s.y, h.y)));
        b[2 * i + 1][0] = tf32_rn(lrelu(affine(__fadd_rn(v.z, bb.z), s.z, h.z)));
        b[2 * i + 1][1] = tf32_rn(lrelu(affine(__fadd_rn(v.w, bb.w), s.w, h.w)));"""
_TF32_BARE = """        b[2 * i][0] = __float_as_uint(v.x);
        b[2 * i][1] = __float_as_uint(v.y);
        b[2 * i + 1][0] = __float_as_uint(v.z);
        b[2 * i + 1][1] = __float_as_uint(v.w);"""
_TF32_A = "m == 0 ? w0[s] : w2f[(8 * m + s) * kLanes + lane]"
_TF32_MMA = f"          mma_tf32(d, {_TF32_A}, b[s][0], b[s][1]);"
_TF32_XOR = ("          {\n            const float4 a = " + _TF32_A + ";\n"
             "            d[s % 4] = __uint_as_float(__float_as_uint(d[s % 4]) ^ "
             "__float_as_uint(a.x) ^ __float_as_uint(a.y) ^ __float_as_uint(a.z) ^ "
             "__float_as_uint(a.w) ^ b[s][0] ^ b[s][1]);\n          }")
_TF32_NEXT_LOAD = ("      load_share4(x[j], tab1 + (size_t)__shfl_sync(kFull, nb1, 8 * j + g) * kC, "
                   "t);")
_TF32_HELD = ("  float4 w0[8];  // m-tile 0's A fragments, read from shared memory once for the "
              "walk\n#pragma unroll\n  for (int s = 0; s < 8; ++s) w0[s] = w2f[s * kLanes + lane];\n")
_TF32_LOADS = ("    load_share4<true>(bv, bvec + (size_t)qv * kC, t);\n#pragma unroll\n"
               "    for (int j = 0; j < 4; ++j)\n" + _TF32_NEXT_LOAD + "\n")
_TF32_UNIT = "    // n-tile by n-tile: its rows activated and rounded, then multiplied\n"
_TF32_BODY_END = "          mx[m][h] = fmaxf(mx[m][h], fmaxf(v0, v1));\n        }\n      }\n    }\n"


def _tf32_held(n: int) -> list[tuple[str, str]]:
    """The first ``n`` of the 32 A fragments (k-step by k-step, m-tile by
    m-tile) held in registers for the walk, instead of m-tile 0's 8."""
    if n == 0:
        return [(_TF32_HELD, ""), (_TF32_A, "w2f[(8 * m + s) * kLanes + lane]")]
    return [(_TF32_HELD, f"  float4 w0[{n}];\n#pragma unroll\n  for (int f = 0; f < {n}; ++f) "
                         "w0[f] = w2f[f * kLanes + lane];\n"),
            (_TF32_A, f"8 * m + s < {n} ? w0[8 * m + s < {n} ? 8 * m + s : 0] : "
                      "w2f[(8 * m + s) * kLanes + lane]")]


def _tf32_m_outer(n: int) -> list[tuple[str, str]]:
    """The unit's n-tiles activated ``n`` at a time (2 or 4), then
    multiplied m-tile by m-tile, k-step by k-step, n-tile by n-tile: each
    fragment read from shared memory once a group; the running max still
    folded over n-tiles in order."""
    old_start = _TF32_UNIT
    new = f"""#pragma unroll
    for (int jp = 0; jp < 4; jp += {n}) {{
      uint32_t b[4][8][2];
#pragma unroll
      for (int j = jp; j < jp + {n}; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {{
          const float4 v = x[j][i], bb = bv[i], s = L.sa[4 * i], h = L.ta[4 * i];
          b[j][2 * i][0] = tf32_rn(lrelu(affine(__fadd_rn(v.x, bb.x), s.x, h.x)));
          b[j][2 * i][1] = tf32_rn(lrelu(affine(__fadd_rn(v.y, bb.y), s.y, h.y)));
          b[j][2 * i + 1][0] = tf32_rn(lrelu(affine(__fadd_rn(v.z, bb.z), s.z, h.z)));
          b[j][2 * i + 1][1] = tf32_rn(lrelu(affine(__fadd_rn(v.w, bb.w), s.w, h.w)));
        }}
#pragma unroll
      for (int m = 0; m < 4; ++m) {{
        float d[4][4];
#pragma unroll
        for (int j = jp; j < jp + {n}; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
        for (int s = 0; s < 8; ++s) {{
          const float4 a = {_TF32_A};
#pragma unroll
          for (int j = jp; j < jp + {n}; ++j) mma_tf32(d[j], a, b[j][s][0], b[j][s][1]);
        }}
#pragma unroll
        for (int j = jp; j < jp + {n}; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {{
            float v0 = d[j][2 * h], v1 = d[j][2 * h + 1];
            if (!kMaxFirst) {{
              const int ch = 16 * m + g + 8 * h;
              const float s0 = ld_in_place(sb + ch), sh = ld_in_place(tb + ch);
              const float sc = regular(s0, sh) && s0 < 0.f ? -s0 : s0;
              v0 = lrelu(affine(v0, sc, sh));
              v1 = lrelu(affine(v1, sc, sh));
            }}
            mx[m][h] = fmaxf(mx[m][h], fmaxf(v0, v1));
          }}
      }}
    }}
"""
    return [("__BLOCK__", (old_start, _TF32_BODY_END, new))]


TF32_VARIANTS = {
    "shipped": [],
    "diag_no_gather": [(_TF32_NEXT_LOAD, "      (void)tab1;")],
    "diag_no_activation": [(_TF32_ACT, _TF32_BARE)],
    "diag_no_product": [(_TF32_MMA, _TF32_XOR)],
    "diag_no_lds": [(_TF32_A, "w0[s]")],
    "bits": [(_TF32_ACT, _TF32_ACT.replace("tf32_rn(", "tf32_bits("))],
    "held0": _tf32_held(0),
    "held4": _tf32_held(4),
    "held12": _tf32_held(12),
    "held16": _tf32_held(16),
    "early_loads": [(_TF32_LOADS, ""), (_TF32_ACT + "\n      }\n", _TF32_ACT + "\n      }\n"
                    "      if (j == 3) load_share4<true>(bv, bvec + (size_t)qv * kC, t);\n"
                    "  " + _TF32_NEXT_LOAD + "\n")],
    "held0_warps12": _tf32_held(0) + [("constexpr int kTfWarps = 8;",
                                       "constexpr int kTfWarps = 12;")],
    "m_outer": _tf32_m_outer(4),
    "m_outer2": _tf32_m_outer(2),
}
# the warps a block each variant is also timed at, beside the wrapper's 8
TF32_VARIANT_WARPS = {"held0_warps12": 12}
# --bf16, the present design: (warps, queries a block) beside the wrapper's,
# 0 for the wrapper's range
BF16_GEOMETRIES = [(4, 0), (6, 0), (8, 64), (8, 212)]


def _blocks(patches: list) -> list[tuple[str, str]]:
    """The patches with each block patch, ``("__BLOCK__", (start, end,
    new))``, made a text patch: the imported source's text from ``start``
    through the first ``end`` after it, replaced by ``new``."""
    from dgcnn_tpu_torch.kernels import _build

    src = (_build.CSRC / "edgeconv_fused.cu").read_text()
    out = []
    for old, new in patches:
        if old == "__BLOCK__":
            start, end, new = new
            i = src.index(start)
            old = src[i:src.index(end, i) + len(end)]
        out.append((old, new))
    return out


def _start_build(name: str, patches: list, out_dir: Path):
    """A patched copy of the imported package's ``csrc/`` (``--root``'s)."""
    return kv.start_build(name, _blocks(patches), out_dir, ("edgeconv_fused.cu",),
                          ("edgeconv_fused.cu",))


def _finish_build(name: str, started, kernel: str):
    handle, log = kv.finish_build(name, *started)
    return handle, kv.ptxas_lines(log, {kernel: None})


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--ceiling", action="store_true")
    ap.add_argument("--bf16", action="store_true", help="the bf16 kernel's variants")
    ap.add_argument("--tf32", action="store_true", help="the TF32 kernel's variants")
    ap.add_argument("--root", default=str(HERE), help="checkout whose kernel is patched")
    ap.add_argument("--sharing", action="store_true", help="distinct rows among queries")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # the patched tree's package first
    spec = importlib.util.spec_from_file_location("chip_smoke_variants", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel variants run on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import edgeconv_fused as mod

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    if args.bf16 or args.tf32:
        return _main_bf16(args, cs, mod, _build)
    variants = {name: VARIANTS[name] for name in (args.names or VARIANTS)}
    out_dir = HERE / "build" / "edgeconv_stage_variants"
    started = {name: _start_build(name, patches, out_dir)
               for name, patches in variants.items()}
    case = next(iter(cs.stage_cases(torch.device("cuda")).values()))
    t, i, bv, w2 = (case[key] for key in ("table", "idx", "bvec", "w2"))
    vec = [case[key] for key in ("sa", "ta", "sb", "tb")]
    want = mod.edgeconv_fused_stage(*cs.stage_args(case))
    results = {}
    for vname, build in started.items():
        handle, lines = _finish_build(vname, build, "edgeconv_stage_kernel")
        print(vname, *lines, sep="\n  ", file=sys.stderr)
        _build._lib = handle
        try:
            row = {}
            for warps, nbuf, grid in GEOMETRIES + [(16, 1, 0)] * (vname in WARPS16):
                def run(g=(warps, nbuf), grid=grid):
                    return mod.launch_stage(t, i, bv, w2, vec, g, grid)
                if not vname.startswith("diag_") and not torch.equal(run(), want):
                    raise AssertionError(f"{vname} {(warps, nbuf, grid)}: outputs differ")
                row[f"warps={warps} nbuf={nbuf} grid={grid}"] = cs.cuda_ms_many(run)
        finally:
            _build._lib = None
        row["ptxas"] = lines
        results[vname] = row
        print(f"{vname}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                       if isinstance(v, float)), file=sys.stderr)
    out = {"device": _smi(), "variants": results}
    if args.ceiling:
        out["ceiling"] = _ceiling(cs, lambda: mod.edgeconv_fused_stage(*cs.stage_args(case)))
    print(json.dumps(out))
    return 0


def _main_bf16(args, cs, mod, _build) -> int:
    """The bf16 (or, with ``--tf32``, the TF32) kernel's variants on the four
    production cases."""
    import torch

    tf32 = args.tf32
    first = not tf32 and not hasattr(mod, "launch_geometry_bf16")
    table = TF32_VARIANTS if tf32 else FIRST_BF16_VARIANTS if first else BF16_VARIANTS
    variants = {name: table[name] for name in (args.names or table)}
    out_dir = HERE / "build" / ("edgeconv_tf32_variants" if tf32 else "edgeconv_bf16_first"
                                if first else "edgeconv_bf16_variants")
    kernel = "edgeconv_stage_tf32_kernel" if tf32 else "edgeconv_stage_bf16_kernel"
    launch = mod.launch_stage_tf32 if tf32 else getattr(mod, "launch_stage_bf16", None)
    wrapper = mod.edgeconv_fused_stage_tf32 if tf32 else mod.edgeconv_fused_stage_bf16
    started = {name: _start_build(name, patches, out_dir)
               for name, patches in variants.items()}
    dev = torch.device("cuda")
    cases = {label: case for label, case in cs.stage_cases(dev).items()
             if not label.startswith("ragged")}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launcher(case, geometry):
        t, i, bv, w2 = (case[key] for key in ("table", "idx", "bvec", "w2"))
        vec = [case[key] for key in ("sa", "ta", "sb", "tb")]
        if first:
            return lambda: mod.launch_stage(t, i, bv, w2, vec, (12, 2), 0, bf16_mm=True)
        return lambda: launch(t, i, bv, w2, vec, geometry)

    geometries = {"wrapper": None}
    if not first:
        b, n, k = next(iter(cases.values()))["idx"].shape
        warps, per = mod.launch_geometry_bf16(b, n, k, sms)
        geometries = {f"warps={w} per={p or per}": (w, p or per)
                      for w, p in [(warps, per), *BF16_GEOMETRIES]}
    want = {label: wrapper(*cs.stage_args(case)) for label, case in cases.items()}
    results = {}
    for vname, build in started.items():
        handle, lines = _finish_build(vname, build, kernel)
        print(vname, *lines, sep="\n  ", file=sys.stderr)
        _build._lib = handle
        try:
            row = {}
            for label, case in cases.items():
                gs = (geometries.items() if vname == "shipped"
                      else list(geometries.items())[:1])
                if tf32 and vname in TF32_VARIANT_WARPS:
                    w = TF32_VARIANT_WARPS[vname]
                    per = next(iter(geometries.values()))[1]
                    gs = [*gs, (f"warps={w} per={per}", (w, per))]
                for gname, geometry in gs:
                    run = launcher(case, geometry)
                    if not vname.startswith("diag_") and not torch.equal(run(), want[label]):
                        raise AssertionError(f"{vname} {label} {gname}: outputs differ")
                    row[f"{label} {gname}"] = cs.cuda_ms_many(run)
        finally:
            _build._lib = None
        row["ptxas"] = lines
        results[vname] = row
        print(f"{vname}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                       if isinstance(v, float)), file=sys.stderr)
    out = {"device": _smi(), "root": str(Path(args.root).resolve()),
           "kernel": kernel, "design": "first" if first else "present", "variants": results}
    if args.sharing:
        spec = importlib.util.spec_from_file_location(
            "torch_edgeconv_fused_sharing", HERE / "scripts" / "torch_edgeconv_fused.py")
        fused = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fused)
        out["sharing"] = {label: {q: fused.sharing(case["idx"], case["idx"].shape[1], q)
                                  for q in (32, 64, 128)} for label, case in cases.items()}
    print(json.dumps(out))
    return 0


def _clocks_while(fn, seconds: float = 2.0) -> list[str]:
    """``nvidia-smi`` SM clock (MHz) and power draw (W), sampled every 200 ms
    while ``fn()`` runs back to back for ``seconds``."""
    import time

    import torch

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "200"],
                            stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    proc.terminate()
    return [line.strip() for line in proc.communicate()[0].splitlines() if line.strip()]


def _ceiling(cs, stage) -> dict:
    """What FP32 SIMT reaches on this card: cuBLAS SGEMM (TF32 off) at
    8192^3, its TFLOP/s, and the SM clock and power while it runs and while
    the stage kernel runs back to back."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = (torch.randn(8192, 8192, device="cuda") for _ in range(2))
    ms = cs.cuda_ms_many(lambda: torch.mm(a, b), 3, 5)
    return {"sgemm_8192_ms": ms, "sgemm_tflops": 2 * 8192 ** 3 / ms / 1e9,
            "sgemm_clocks": _clocks_while(lambda: torch.mm(a, b)),
            "stage_clocks": _clocks_while(stage)}


if __name__ == "__main__":
    sys.exit(main())
