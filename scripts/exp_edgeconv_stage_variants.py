"""Build variants of the fused stage kernel (``csrc/edgeconv_fused.cu`` with
a constant or a line changed) and time them beside each other, on one GPU,
at the production shape (B=8, N=7000, k=30, ``knn_capped`` indices: the
first of ``chip_smoke.stage_cases``).

    python scripts/exp_edgeconv_stage_variants.py [--ceiling] [NAME ...]

Each variant is a list of text replacements (``VARIANTS``; ``shipped`` has
none) applied to a copy of ``csrc/`` under
``build/edgeconv_stage_variants/NAME/``; the copy's ``edgeconv_fused.cu`` and
``knn_capped.cu`` (which holds the error-string entry point) are compiled
with the port's flags into one library, all variants at once. The script
prints the compiler's register and spill lines of the stage kernel's
instances, holds each variant's output ``torch.equal`` to the shipped
kernel's (except the ``diag_`` variants, which leave a part of the kernel
out to see what it costs), and times it device-only
(``chip_smoke.cuda_ms_many`` of ``launch_stage``) at the geometries of
``GEOMETRIES``. Without arguments it runs every variant. ``--ceiling``
also times cuBLAS FP32 SGEMM at 8192^3 (what FP32 SIMT reaches on the
card) and samples the SM clock and power while it and the stage kernel run.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

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


def _start_build(name: str, patches: list[tuple[str, str]], out_dir: Path):
    return kv.start_build(name, patches, out_dir, ("edgeconv_fused.cu",),
                          ("edgeconv_fused.cu",))


def _finish_build(name: str, *started):
    handle, log = kv.finish_build(name, *started)
    return handle, kv.ptxas_lines(log, {"edgeconv_stage_kernel": None})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ceiling = "--ceiling" in argv
    argv = [a for a in argv if a != "--ceiling"]
    variants = {name: VARIANTS[name] for name in (argv or VARIANTS)}
    spec = importlib.util.spec_from_file_location("chip_smoke_variants", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel variants run on one GPU")
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import edgeconv_fused as mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "edgeconv_stage_variants"
    started = {name: _start_build(name, patches, out_dir) for name, patches in variants.items()}
    case = next(iter(cs.stage_cases(torch.device("cuda")).values()))
    t, i, bv, w2 = (case[key] for key in ("table", "idx", "bvec", "w2"))
    vec = [case[key] for key in ("sa", "ta", "sb", "tb")]
    want = mod.edgeconv_fused_stage(*cs.stage_args(case))
    results = {}
    for vname, build in started.items():
        handle, lines = _finish_build(vname, *build)
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
    out = {"device": smi, "variants": results}
    if ceiling:
        out["ceiling"] = _ceiling(cs, lambda: mod.edgeconv_fused_stage(*cs.stage_args(case)))
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
