"""Build variants of the exact banded and packed kNN kernels
(``csrc/knn_exact_banded.cu``, ``csrc/knn_packed.cu`` with a constant or a
line changed) and time them beside the shipped build, on one GPU, at the
parity and packed forwards' shapes.

    python scripts/exp_knn_third_path_variants.py [NAME ...]

Each variant is a source file and a list of text replacements
(``VARIANTS``) applied to a copy of ``csrc/`` under
``build/knn_third_path_variants/NAME/`` and built by
``scripts/kernel_variants.py``. The script prints the compiler's register,
stack and spill lines of the variant's production instances (cap 8 at C=4,
the fused kernel, and at C=64; KMAX 32 at C=4, the fused kernel, and at
C=64), holds the variant's outputs ``torch.equal`` to the shipped kernel's
(except the ``diag_`` variants, which leave a part of the kernel out to see
what it costs), and times both device-only (``chip_smoke.cuda_ms_many`` of
the kernel alone) at B=8, N=7000, k=30: the exact banded kernel at C=64
full width (seeded features) and C=4 band 2048 (``make_blocks`` points and
an integer cloud), the packed kernel at C=64 and C=4 and on an integer C=4
cloud. Without arguments it runs every variant. Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
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

K = 30

VARIANTS = {
    # the exact banded kernel's two-phase body (key tile, 32 queries a
    # block) at C <= 8 too, in place of the fused one
    "eb_two_phase_c4": ("knn_exact_banded.cu", [
        ("  const bool fused = cv <= 8;", "  const bool fused = false;"),
        ("constexpr int qb = CV <= 8 ? kFQB : kQB, threads = CV <= 8 ? kFThreads : kThreads;",
         "constexpr int qb = kQB, threads = kThreads;"),
        ("if constexpr (CV <= 8) {  // the fused kernel", "if constexpr (false) {")]),
    # the fused kernel without its insertions (the scores, keys and merge):
    # what the selection costs there
    "diag_eb_fused_no_insert": ("knn_exact_banded.cu", [(
        "insert_pair<CAP>(tk[a], ts[a], score_key(sc), j0 + jj);",
        "tk[a][0] = max(tk[a][0], score_key(sc));")]),
    # the fused kernel without its merge: what the merge costs there
    "diag_eb_fused_no_merge": ("knn_exact_banded.cu", [(
        "  merge_lists_lex<CAP, kFQB / (kFThreads / 32)>(lkeys, lrows, q0, b, N, K, n_win, start, out,\n"
        "                                                 kth, ovf);",
        "  if (lkeys[threadIdx.x] == 12345) out[threadIdx.x] = lrows[threadIdx.x];")]),
    # the packed two-phase kernel (C >= 16) with 32 queries a block (tiles
    # of 512 rows)
    "pk_qb32": ("knn_packed.cu", [("constexpr int kQB = 64;", "constexpr int kQB = 32;"),
                                  ("    if (qb != kQB) return cudaErrorInvalidValue;\n", "")]),
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the production instances whose compiler lines are printed
RESOURCES = {"knn_exact_banded_fusedILi8ELi4E": "exact banded fused cap 8, C=4",
             "knn_exact_banded_kernelILi8ELi4E": "exact banded two-phase cap 8, C=4",
             "knn_exact_banded_kernelILi8ELi64E": "exact banded two-phase cap 8, C=64",
             "knn_packed_kernel_fusedILi32ELi4E": "packed fused KMAX 32, C=4",
             "knn_packed_kernelILi32ELi64E": "packed two-phase KMAX 32, C=64"}


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    cs = _load("chip_smoke_variants", HERE / "chip_smoke.py")

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels run on one GPU")
    from dgcnn_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "knn_third_path_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = _build.lib()
    builds = {n: kv.start_build(n, VARIANTS[n][1], out_dir, (VARIANTS[n][0], "knn_select.cuh"),
                                (VARIANTS[n][0],)) for n in names}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    feats = on(rng.standard_normal((8, 7000, 64), np.float32))
    pts = on(cs.make_blocks(8, 7000, seed=0))
    int4 = on(rng.integers(0, 16, (8, 7000, 4)).astype(np.float32))
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731

    def exact_run(lib, x, band):
        b, n, cv = x.shape
        cn = (x * x).sum(-1).contiguous()
        outs = [torch.empty((b, n, K), dtype=torch.int32, device=dev),
                torch.empty((b, n), dtype=torch.int32, device=dev),
                torch.empty((b, n), dtype=torch.int32, device=dev)]

        def run():
            err = lib.dgcnn_knn_exact_banded(
                x.data_ptr(), cn.data_ptr(), *[o.data_ptr() for o in outs], None, None, b, n,
                cv, K, 7040, band, 64, 8, 256, stream())
            if err:
                raise RuntimeError(f"dgcnn_knn_exact_banded: CUDA error {err}")
        return run, lambda: torch.cat([o.flatten() for o in outs])

    def packed_run(lib, x):
        b, n, cv = x.shape
        cn = (x * x).sum(-1).contiguous()
        out = torch.empty((b, n, K), dtype=torch.int32, device=dev)

        def run():
            err = lib.dgcnn_knn_packed(x.data_ptr(), x.data_ptr(), cn.data_ptr(), cn.data_ptr(),
                                       out.data_ptr(), None, b, n, n, cv, K, 7040, 13, 64,
                                       stream())
            if err:
                raise RuntimeError(f"dgcnn_knn_packed: CUDA error {err}")
        return run, lambda: out.clone()

    cases = {"knn_exact_banded.cu": {"C=64 full width": lambda lib: exact_run(lib, feats, 7040),
                                     "C=4 band 2048 (blocks)": lambda lib: exact_run(lib, pts, 2048),
                                     "int C=4 band 2048": lambda lib: exact_run(lib, int4, 2048)},
             "knn_packed.cu": {"C=64": lambda lib: packed_run(lib, feats),
                               "C=4 (blocks)": lambda lib: packed_run(lib, pts),
                               "int C=4": lambda lib: packed_run(lib, int4)}}
    result = {}
    for name, build in builds.items():
        lib, log = kv.finish_build(name, *build)
        src = VARIANTS[name][0]
        row = {"resources": kv.ptxas_lines(log, RESOURCES)}
        for case, make in cases[src].items():
            (run_s, res_s), (run_v, res_v) = make(shipped), make(lib)
            run_s()
            run_v()
            torch.cuda.synchronize()
            if not name.startswith("diag_") and not torch.equal(res_v(), res_s()):
                raise AssertionError(f"{name} {case}: outputs differ from the shipped kernel's")
            row[case] = {"ms": cs.cuda_ms_many(run_v, 10), "shipped_ms": cs.cuda_ms_many(run_s, 10)}
        result[name] = row
        print(name, json.dumps(row), file=sys.stderr)
    print(json.dumps({"device": smi, "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
