"""Build variants of the banded kNN kernel (``csrc/knn_banded.cu`` with a
constant or a line changed) and time them beside the shipped build, on one
GPU, at the default path's two shapes.

    python scripts/exp_knn_banded_variants.py [NAME ...]

Each variant is a list of text replacements (``VARIANTS``) applied to a
copy of ``csrc/`` under ``build/knn_banded_variants/NAME/`` (in
``knn_banded.cu`` or in the header it shares, ``knn_select.cuh``); the copy's
``knn_banded.cu`` and ``knn_capped.cu`` (which holds the error-string
entry point) are compiled with the port's flags into one library. The
script prints the compiler's register, stack and spill lines of the C=4
and C=64 cap-6 instances, holds the variant's indices and k-th keys
``torch.equal`` to the shipped kernel's (except the ``diag_`` variants,
which change the result to see what a part of the kernel costs), and times
it device-only (``chip_smoke.cuda_ms_many`` of the kernel alone) at the
shipped ``launch_geometry`` and ``torch_knn_banded.GEOMETRIES``,
and with k = 0 (the scan without the merge). Without arguments it runs
every variant. Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

import kernel_variants as kv  # noqa: E402


VARIANTS = {
    # the fused kernel (C <= 8) with 4 windows per thread instead of 2
    "fused_rm4": [("return CV <= 8 ? 2 : 4;", "return 4;")],
    # the two-phase kernel's 2-channel steps of the dot loop unrolled
    "tile_unroll1": [("constexpr int kC2Unroll = 4;", "constexpr int kC2Unroll = 1;")],
    "tile_unroll2": [("constexpr int kC2Unroll = 4;", "constexpr int kC2Unroll = 2;")],
    # the two-phase kernel's dot tile written out in its phase A, as before
    # the capped kernel shared it (knn_select.cuh::tile_dots)
    "own_dots": [(
        "  float acc[8][8];\n  tile_dots<CV>(acc, qs4, xs4, ty, TY, tx);\n",
        "  constexpr int XS2 = 2 * row_stride4<CV>();\n"
        "  const float2* q2 = reinterpret_cast<const float2*>(qs4) + ty * XS2;\n"
        "  const float2* x2 = reinterpret_cast<const float2*>(xs4) + tx * XS2;\n"
        "  float acc[8][8];\n"
        "#pragma unroll\n  for (int a = 0; a < 8; ++a)\n#pragma unroll\n"
        "    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;\n"
        "#pragma unroll (kC2Unroll)\n  for (int c2 = 0; c2 < CV / 2; ++c2) {\n"
        "    float2 qf[8], xf[8];\n"
        "#pragma unroll\n    for (int a = 0; a < 8; ++a) qf[a] = q2[a * TY * XS2 + c2];\n"
        "#pragma unroll\n    for (int c = 0; c < 8; ++c) xf[c] = x2[c * 32 * XS2 + c2];\n"
        "#pragma unroll\n    for (int a = 0; a < 8; ++a)\n#pragma unroll\n"
        "      for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(qf[a].x, xf[c].x, acc[a][c]);\n"
        "#pragma unroll\n    for (int a = 0; a < 8; ++a)\n#pragma unroll\n"
        "      for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(qf[a].y, xf[c].y, acc[a][c]);\n"
        "  }\n")],
    # the shared header's functions with internal linkage, as they had in
    # the banded kernel's source
    "select_internal": [
        ('#include "knn_common.cuh"  // score_key, cp.async helpers\n',
         '#include "knn_common.cuh"  // score_key, cp.async helpers\nnamespace {\n'),
        ("kth[(size_t)b * M + qq] = prev;\n  }\n}\n",
         "kth[(size_t)b * M + qq] = prev;\n  }\n}\n}  // namespace\n")],
    # what the insertions cost: each key is folded into the list's head instead
    "diag_no_insert": [
        ("insert<CAP>(top[a][c], v);", "top[a][c][0] ^= v;"),
        ("insert<CAP>(top[i], keys[(pq + pstep * i) * kKeyStride + jj * kSlots + pw]);",
         "top[i][0] ^= keys[(pq + pstep * i) * kKeyStride + jj * kSlots + pw];")],
}



def _build_variant(name: str, patches: list[tuple[str, str]], out_dir: Path):
    """The variant's library (in the kernel's source or the header it
    shares) and its compiler lines of the cap-6 instances."""
    started = kv.start_build(name, patches, out_dir, ("knn_banded.cu", "knn_select.cuh"),
                             ("knn_banded.cu",))
    handle, log = kv.finish_build(name, *started)
    keep = {f"knn_banded{kind}ILi6ELi{c}E": f"{label} cap 6, C={c}"
            for kind, label in (("_tile_kernel", "two-phase"), ("_kernel", "fused"))
            for c in (64, 4)}
    return handle, kv.ptxas_lines(log, keep)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    variants = {name: VARIANTS[name] for name in (argv or VARIANTS)}
    spec = importlib.util.spec_from_file_location("chip_smoke_variants", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    spec = importlib.util.spec_from_file_location("torch_knn_banded", HERE / "scripts" /
                                                  "torch_knn_banded.py")
    tkb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tkb)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel variants run on one GPU")
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import knn_banded as mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev, k = torch.device("cuda"), cs.K
    rng = np.random.default_rng(0)
    shapes = {
        "C=4 band 2048": (torch.from_numpy(cs.make_blocks(cs.B, cs.N, seed=0)).to(dev), 2048, 512),
        "C=64 band 4096": (torch.from_numpy(rng.standard_normal((cs.B, cs.N, 64), np.float32)).to(dev),
                           4096, 384)}
    want = {name: mod.knn_banded_raw(x, k, band=band, query_tile=qt, **cs.BANDS)
            for name, (x, band, qt) in shapes.items()}
    shipped = _build.lib()
    results = {}
    for vname, patches in variants.items():
        handle, lines = _build_variant(vname, patches, HERE / "build" / "knn_banded_variants")
        print(vname, *lines, sep="\n  ", file=sys.stderr)
        _build._lib = handle
        try:
            row = {}
            for name, (x, band, qt) in shapes.items():
                cn = (x * x).sum(-1).contiguous()
                kw = dict(band=band, query_tile=qt, **cs.BANDS)
                g0 = mod.launch_geometry(x.shape[-1], band, kw["n_win"], kw["cap"], qt)
                for g in sorted({g0, *tkb.GEOMETRIES[name]}):
                    got = mod.launch_kernel(x, cn, k, geometry=g, **kw)
                    if not vname.startswith("diag_") and not all(
                            torch.equal(a, b) for a, b in zip(got, want[name])):
                        raise AssertionError(f"{vname} {name} {g}: outputs differ")
                    row[f"{name} " + "qb={} jt={} nbuf={} two_phase={}".format(*g)] = cs.cuda_ms_many(
                        lambda g=g: mod.launch_kernel(x, cn, k, geometry=g, **kw))
                row[f"{name} scan only"] = cs.cuda_ms_many(
                    lambda: mod.launch_kernel(x, cn, 0, geometry=g0, **kw))
            results[vname] = {"ptxas": lines, "ms": row}
            print(json.dumps(row), file=sys.stderr)
        finally:
            _build._lib = shipped
    print(json.dumps({"device": smi, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
