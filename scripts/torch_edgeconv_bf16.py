"""Check and time the port's tensor-core fused stage kernels on one GPU: the
bf16 one (``csrc/edgeconv_fused.cu::edgeconv_stage_bf16_kernel``, the
stage's ``bf16_mm`` mode) or the TF32 one (``edgeconv_stage_tf32_kernel``,
``tf32_mm``: the model's ``matmul_precision="default"``), and hold its
outputs against another tree's.

    python scripts/torch_edgeconv_bf16.py [--mode bf16|tf32] [--root DIR] [--label NAME]
        [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``
(under ``build/``).

On ``chip_smoke.stage_cases`` (B=8, N=7000, k=30 with ``knn_capped``,
banded and the default forward's own stage-3 indices; then B=1, N=1001,
k = 20, 30, 40 with indices outside [0, N)):

* the mode's kernel against its plain version
  (``edgeconv_fused_stage_plain(..., bf16_mm=True)`` within
  ``stage_bf16_tolerance``; ``edgeconv_fused_stage_tf32_plain`` within
  ``stage_tf32_tolerance``: the two FP32 sums' orders), with the largest
  share of that tolerance used and the max abs difference;
* the mode's kernel's, the FP32 stage kernel's and the extrema kernel's
  outputs (under ``tf32`` the bf16 kernel's too) written to ``--out``
  with their SHA-256 digests by the first tree, and held ``torch.equal``
  to them by the second;
* at B=8: each kernel's device-only time (each wrapper's call timed by
  ``chip_smoke.cuda_ms_many``: back-to-back calls queued behind a device
  sleep, 50 a pair of CUDA events, median of 10 runs); on the first case
  the plain version's (``cuda_ms``), cuBLAS's bf16 GEMM with an FP32
  output (``bf16``) or its TF32 GEMM (``tf32``) for the bare
  (B*N*k, 64) x (64, 64) product (a ceiling: it neither gathers nor
  reduces) and cuBLAS FP32 for the same product, and the bounds:
  operations at the mode's dense peak (989 TFLOP/s bf16, 495 TF32),
  bytes at 3.35 TB/s, and the gather's rows at the card's L2 read rate
  measured in the same run (``chip_smoke.l2_gather_rate``), with the
  kernel's share of each.

It also prints what was compiled, for the stage kernels and the extrema
kernel: registers, stack and spills (``nvcc -Xptxas -v``, the build log)
and their SASS opcodes counted by ``cuobjdump -sass`` (HMMA: the tensor
cores; LDS: shared-memory loads, and the mode's LDS per HMMA; LDSM:
ldmatrix; FFMA; every opcode of the mode's kernel, whose SASS goes to
``--out`` as ``<mode>_<label>.sass``), and the route of the trunk's bf16 products
(``ops/matmul.py::bf16_route``). ``--variants`` times other launch
geometries, each held ``torch.equal`` to the wrapper's. Prints one JSON
line (and writes it to ``--out`` as ``<mode>_<label>.json``) with the
card's ``nvidia-smi`` name and power limit.
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

FLOP_PER_S = {"bf16": 989e12, "tf32": 495e12}  # H100 SXM dense tensor cores (700 W)
KERNELS = {"bf16": "edgeconv_stage_bf16_kernel", "tf32": "edgeconv_stage_tf32_kernel",
           "f32": "edgeconv_stage_kernel", "extrema": "edgeconv_extrema_kernel"}
OPCODES = ("HMMA", "HGMMA", "LDSM", "FFMA", "LDG", "LDS", "STS", "SHFL")
# --variants, beside the wrapper's geometry: the first bf16 design's (warps,
# nbuf, grid); the present designs' (warps, queries a block), 0 for the
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


def sass_counts(lib: Path) -> tuple[dict, dict]:
    """Opcode counts of the SASS of each kernel of :data:`KERNELS` (those of
    :data:`OPCODES`, and every opcode), and each kernel's SASS text."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {key: collections.Counter() for key in KERNELS}
    sass = {key: [] for key in KERNELS}
    inside = None
    for line in text.splitlines():
        if "Function : " in line:
            inside = next((k for k, sym in KERNELS.items() if sym in line.split()[-1]), None)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[inside][m.group(1).split(".")[0]] += 1
            sass[inside].append(line.strip())
    return ({key: {op: c[op] for op in OPCODES if c[op]} for key, c in counts.items()},
            {key: {"opcodes": dict(c.most_common()), "text": sass[key]}
             for key, c in counts.items()})


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


def _mode(mod, mode: str) -> dict:
    """The ``mode`` kernel's wrapper, plain version, tolerance and launcher."""
    import functools

    if mode == "bf16":
        return {"wrapper": mod.edgeconv_fused_stage_bf16,
                "plain": functools.partial(mod.edgeconv_fused_stage_plain, bf16_mm=True),
                "tolerance": lambda a: mod.stage_bf16_tolerance(*a[:7]),
                "launch": getattr(mod, "launch_stage_bf16", None)}
    return {"wrapper": mod.edgeconv_fused_stage_tf32,
            "plain": mod.edgeconv_fused_stage_tf32_plain,
            "tolerance": lambda a: mod.stage_tf32_tolerance(*a),
            "launch": mod.launch_stage_tf32}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("bf16", "tf32"), default="bf16",
                    help="the kernel checked and timed")
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
        raise RuntimeError(f"no CUDA device: the {args.mode} stage kernel runs on one GPU")
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
    counts, sass_text = sass_counts(lib)
    compiled = {"ptxas": ptxas_lines(log), "sass": counts,
                "opcodes": sass_text[args.mode]["opcodes"]}
    if out is not None:  # the mode's kernel's SASS, to read where its loads sit
        (out / f"{args.mode}_{args.label or 'run'}.sass").write_text(
            "\n".join(sass_text[args.mode]["text"]) + "\n")
    sass = compiled["sass"][args.mode]
    if not any(op in sass for op in ("HMMA", "HGMMA")):
        raise AssertionError(f"the {args.mode} stage kernel has no tensor-core instruction")
    compiled["lds_per_hmma"] = sass.get("LDS", 0) / sass.get("HMMA", sass.get("HGMMA"))
    print(json.dumps(compiled), file=sys.stderr, flush=True)
    if any("spill" in ln and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)
           for lines in compiled["ptxas"].values() for ln in lines):
        raise AssertionError(f"a stage kernel spills: {compiled['ptxas']}")
    route = bf16_route("cuda")
    present = hasattr(mod, "launch_geometry_bf16")  # else the first bf16 design
    kern = _mode(mod, args.mode)
    # the kernels held across trees: the mode's, the FP32 stage's, the extrema's
    # (and under tf32 the bf16 kernel's, which must not move either)
    held = {args.mode: kern["wrapper"], "f32": mod.edgeconv_fused_stage}
    if args.mode == "tf32":
        held["bf16"] = mod.edgeconv_fused_stage_bf16
    timed = {"f32_ms": mod.edgeconv_fused_stage}
    if args.mode == "tf32":
        timed["bf16_ms"] = mod.edgeconv_fused_stage_bf16

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    diag = cs.start_l2_diag(HERE / "build" / "torch_edgeconv_bf16")
    inputs = cs.stage_cases(dev)
    l2 = cs.l2_gather_rate(diag, inputs["capped C=64"]["table"], cs.K)
    cases = []
    for label, case in inputs.items():
        a, ex = cs.stage_args(case), cs.extrema_args(case)
        outs = {key: fn(*a) for key, fn in held.items()}
        outs["extrema"] = mod.edgeconv_fused_extrema(*ex)
        got = outs[args.mode]
        torch.cuda.synchronize()
        want = kern["plain"](*a)
        tol = kern["tolerance"](a)
        err = (got - want).abs()
        row = {"case": label, "max_abs_err": err.max().item(),
               "tol_share": (err / tol.clamp_min(1e-30)).max().item(),
               "digests": {key: digest(v) for key, v in outs.items()}}
        if not (err <= tol).all():
            raise AssertionError(f"{label}: kernel vs plain beyond the tolerance: {row}")
        del want, tol, err
        row["equal_to"] = _hold(out, f"{args.mode} {label}", outs, root)
        if not label.startswith("ragged"):
            row["ms"] = cs.cuda_ms_many(lambda a=a: kern["wrapper"](*a))
            for key, fn in timed.items():
                row[key] = cs.cuda_ms_many(lambda a=a, fn=fn: fn(*a))
            row["extrema_ms"] = cs.cuda_ms_many(lambda ex=ex: mod.edgeconv_fused_extrema(*ex))
            b, n, k = a[1].shape
            if not cases:
                rows = b * n * k
                row["plain_ms"] = cs.cuda_ms(lambda a=a: kern["plain"](*a), 5)
                x = torch.randn(rows, 64, device=dev)
                if args.mode == "bf16":
                    xb, wb = x.to(torch.bfloat16), a[3].to(torch.bfloat16)
                    if route == "mm_out_dtype":
                        row["cublas_bf16_ms"] = cs.cuda_ms_many(
                            lambda: torch.mm(xb, wb, out_dtype=torch.float32))
                    row["cublas_bf16_out_bf16_ms"] = cs.cuda_ms_many(lambda: torch.mm(xb, wb))
                    del xb
                else:
                    from dgcnn_tpu_torch.ops.matmul import tf32_enabled

                    with tf32_enabled():
                        row["cublas_tf32_ms"] = cs.cuda_ms_many(lambda: torch.mm(x, a[3]))
                row["cublas_f32_ms"] = cs.cuda_ms_many(lambda: torch.mm(x, a[3]))
                del x
                nbytes = 4.0 * b * n * (3 * 64 + k) + 4.0 * (64 * 64 + 4 * 64)
                row["bound_ops_ms"] = 2.0 * rows * 64 * 64 / FLOP_PER_S[args.mode] * 1e3
                row["bound_bytes_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
            row["bound_l2_gather_ms"] = l2["ms"]
            first = cases[0] if cases else row
            row["share_of_bound"] = {key: first[f"bound_{key}_ms"] / row["ms"]
                                     for key in ("ops", "bytes", "l2_gather")}
            if args.variants:
                t, i, bv, w2 = a[:4]
                vec = list(a[4:])
                if present:
                    warps, per = mod.launch_geometry_bf16(b, n, k, sms)
                    runs = {f"warps={w} per={p or per}": (
                        lambda g=(w, p or per): kern["launch"](t, i, bv, w2, vec, g))
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
        print(f"{args.label or root} {args.mode} {label}: " + json.dumps(row),
              file=sys.stderr, flush=True)
        cases.append(row)
    res = {"mode": args.mode, "label": args.label, "root": root, "device": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda, "route": route,
           "l2_gather": l2,
           "geometry": mod.launch_geometry_bf16(cs.B, cs.N, cs.K, sms) if present else None,
           "compiled": compiled, "cases": cases}
    line = json.dumps(res)
    if out is not None:
        (out / f"{args.mode}_{args.label or 'run'}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
