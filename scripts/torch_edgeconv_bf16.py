"""Check and time the port's bf16 fused stage kernel
(``csrc/edgeconv_fused.cu::edgeconv_stage_bf16_kernel``, the stage's
``bf16_mm`` mode) on one GPU, and hold its outputs against another tree's.

    python scripts/torch_edgeconv_bf16.py [--root DIR] [--label NAME] [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``
(under ``build/``).

On ``chip_smoke.stage_cases`` (B=8, N=7000, k=30 with ``knn_capped``,
banded and the default forward's own stage-3 indices; then B=1, N=1001,
k = 20, 30, 40 with indices outside [0, N)):

* the kernel's outputs against its plain version
  (``edgeconv_fused_stage_plain(..., bf16_mm=True)``) within
  ``stage_bf16_tolerance`` (the two FP32 sums' orders), with the largest
  share of that tolerance used and the max abs difference;
* the bf16 kernel's, the FP32 stage kernel's and the extrema kernel's
  outputs written to ``--out`` (with their SHA-256 digests) by the first
  tree, and held ``torch.equal`` to them by the second;
* at B=8: each of the three kernels' device-only time (each wrapper's call
  timed by ``chip_smoke.cuda_ms_many``: back-to-back calls queued behind a
  device sleep, 50 a pair of CUDA events, median of 10 runs); on the first
  case the plain version's (``cuda_ms``), cuBLAS's bf16 GEMM with an FP32
  output for the bare (B*N*k, 64) x (64, 64) product (a ceiling: it neither
  gathers nor reduces) and cuBLAS FP32 for the same product, and the
  bounds: operations at 989 TFLOP/s of dense bf16, bytes at 3.35 TB/s, and
  the gather's rows at the card's L2 read rate measured in the same run
  (``chip_smoke.l2_gather_rate``).

It also prints what was compiled, for the bf16 kernel, the FP32 stage
kernel and the extrema kernel: registers, stack and spills (``nvcc
-Xptxas -v``, the build log) and their SASS opcodes counted by
``cuobjdump -sass`` (HMMA: the tensor cores; LDSM: ldmatrix; FFMA), and
the route of the trunk's bf16 products (``ops/matmul.py::bf16_route``).
``--variants`` times other launch geometries, each held ``torch.equal`` to
the wrapper's. Prints one JSON line (and writes it to ``--out`` as
``bf16_<label>.json``) with the card's ``nvidia-smi`` name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 (700 W)
KERNELS = {"bf16": "edgeconv_stage_bf16_kernel", "f32": "edgeconv_stage_kernel",
           "extrema": "edgeconv_extrema_kernel"}
OPCODES = ("HMMA", "HGMMA", "LDSM", "FFMA", "LDG", "LDS", "STS", "SHFL")
# --variants, beside the wrapper's geometry: the first design's (warps,
# nbuf, grid); the present design's (warps, queries a block), 0 for the
# wrapper's range
FIRST_GEOMETRIES = [(12, 1, 0), (8, 2, 0), (10, 2, 0)]
GEOMETRIES = [(4, 0), (6, 0), (8, 64), (8, 212)]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nvcc() -> str:
    from dgcnn_tpu_torch.kernels import _build

    return _build.nvcc_path()


def sass_counts(lib: Path) -> dict:
    """Opcode counts of the SASS of each kernel of :data:`KERNELS`."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {key: collections.Counter() for key in KERNELS}
    inside = None
    for line in text.splitlines():
        if "Function : " in line:
            inside = next((k for k, sym in KERNELS.items() if sym in line.split()[-1]), None)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[inside][m.group(1).split(".")[0]] += 1
    return {key: {op: c[op] for op in OPCODES if c[op]} for key, c in counts.items()}


def ptxas_lines(log: str) -> dict:
    """The build log's ptxas lines of each kernel of :data:`KERNELS`."""
    lines = {key: [] for key in KERNELS}
    keep = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            keep = next((k for k, sym in KERNELS.items() if sym in name), None)
        elif keep and ("Used" in line or "spill" in line):
            lines[keep].append(line.strip())
    return lines


def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _hold(out: Path | None, name: str, tensors: dict, root: str):
    """Save ``tensors`` under ``name`` or hold them ``torch.equal`` to the
    saved ones; returns the root that saved them first, or None."""
    import torch

    if out is None:
        return None
    path = out / (re.sub(r"[^A-Za-z0-9_.-]+", "_", name) + ".pt")
    if not path.exists():
        torch.save({**{k: v.cpu() for k, v in tensors.items()}, "root": root}, path)
        return None
    other = torch.load(path)
    for key, v in tensors.items():
        if not torch.equal(v.cpu(), other[key]):
            raise AssertionError(f"{name}: {key} differs from {other['root']}'s")
    return other["root"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", default="", help="directory of the outputs to hold trees against")
    ap.add_argument("--variants", action="store_true", help="also time other launch geometries")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    cs = _load("chip_smoke_bf16", HERE / "chip_smoke.py")

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bf16 stage kernel runs on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import edgeconv_fused as mod
    from dgcnn_tpu_torch.ops.matmul import bf16_route

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    lib = _build.build()
    _build.lib()
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    compiled = {"ptxas": ptxas_lines(log), "sass": sass_counts(lib)}
    print(json.dumps(compiled), file=sys.stderr, flush=True)
    if not any(op in compiled["sass"]["bf16"] for op in ("HMMA", "HGMMA")):
        raise AssertionError("the bf16 stage kernel has no tensor-core instruction")
    if any("spill" in ln and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
           for lines in compiled["ptxas"].values() for ln in lines):
        raise AssertionError(f"a stage kernel spills: {compiled['ptxas']}")
    route = bf16_route("cuda")
    present = hasattr(mod, "launch_geometry_bf16")  # else the first design

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    diag = cs.start_l2_diag(HERE / "build" / "torch_edgeconv_bf16")
    inputs = cs.stage_cases(dev)
    l2 = cs.l2_gather_rate(diag, inputs["capped C=64"]["table"], cs.K)
    cases = []
    for label, case in inputs.items():
        a, ex = cs.stage_args(case), cs.extrema_args(case)
        got = mod.edgeconv_fused_stage_bf16(*a)
        f32, extrema = mod.edgeconv_fused_stage(*a), mod.edgeconv_fused_extrema(*ex)
        torch.cuda.synchronize()
        want = mod.edgeconv_fused_stage_plain(*a, bf16_mm=True)
        tol = mod.stage_bf16_tolerance(*a[:7])
        err = (got - want).abs()
        row = {"case": label, "max_abs_err": err.max().item(),
               "tol_share": (err / tol.clamp_min(1e-30)).max().item(),
               "digests": {"bf16": digest(got), "f32": digest(f32), "extrema": digest(extrema)}}
        if not (err <= tol).all():
            raise AssertionError(f"{label}: kernel vs plain beyond the tolerance: {row}")
        del want, tol, err
        row["equal_to"] = _hold(out, f"bf16 {label}",
                                {"bf16": got, "f32": f32, "extrema": extrema}, root)
        if not label.startswith("ragged"):
            row["ms"] = cs.cuda_ms_many(lambda a=a: mod.edgeconv_fused_stage_bf16(*a))
            row["f32_ms"] = cs.cuda_ms_many(lambda a=a: mod.edgeconv_fused_stage(*a))
            row["extrema_ms"] = cs.cuda_ms_many(lambda ex=ex: mod.edgeconv_fused_extrema(*ex))
            b, n, k = a[1].shape
            if not cases:
                rows = b * n * k
                row["plain_ms"] = cs.cuda_ms(
                    lambda a=a: mod.edgeconv_fused_stage_plain(*a, bf16_mm=True), 5)
                x = torch.randn(rows, 64, device=dev)
                xb, wb = x.to(torch.bfloat16), a[3].to(torch.bfloat16)
                if route == "mm_out_dtype":
                    row["cublas_bf16_ms"] = cs.cuda_ms_many(
                        lambda: torch.mm(xb, wb, out_dtype=torch.float32))
                row["cublas_bf16_out_bf16_ms"] = cs.cuda_ms_many(lambda: torch.mm(xb, wb))
                row["cublas_f32_ms"] = cs.cuda_ms_many(lambda: torch.mm(x, a[3]))
                del x, xb
                nbytes = 4.0 * b * n * (3 * 64 + k) + 4.0 * (64 * 64 + 4 * 64)
                row["bound_ops_ms"] = 2.0 * rows * 64 * 64 / BF16_FLOP_PER_S * 1e3
                row["bound_bytes_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
                row["bound_l2_gather_ms"] = l2["ms"]
            if args.variants:
                t, i, bv, w2 = a[:4]
                vec = list(a[4:])
                if present:
                    warps, per = mod.launch_geometry_bf16(b, n, k, sms)
                    runs = {f"warps={w} per={p or per}": (
                        lambda g=(w, p or per): mod.launch_stage_bf16(t, i, bv, w2, vec, g))
                        for w, p in GEOMETRIES}
                else:
                    runs = {f"warps={w} nbuf={nb} grid={gr}": (
                        lambda g=(w, nb), gr=gr: mod.launch_stage(t, i, bv, w2, vec, g, gr,
                                                                 bf16_mm=True))
                        for w, nb, gr in FIRST_GEOMETRIES}
                row["variants"] = {}
                for gname, run in runs.items():
                    if not torch.equal(run(), got):
                        raise AssertionError(f"{label}: geometry {gname} changes the outputs")
                    row["variants"][gname] = cs.cuda_ms_many(run)
        print(f"{args.label or root} {label}: " + json.dumps(
            {key: v for key, v in row.items() if key != "digests"}), file=sys.stderr, flush=True)
        cases.append(row)
    res = {"label": args.label, "root": root, "device": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "route": route, "l2_gather": l2,
           "geometry": mod.launch_geometry_bf16(cs.B, cs.N, cs.K, sms) if present else None,
           "compiled": compiled, "cases": cases}
    line = json.dumps(res)
    if out is not None:
        (out / f"bf16_{args.label or 'run'}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
