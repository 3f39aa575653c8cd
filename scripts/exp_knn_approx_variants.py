"""Time the approximate kNN kernel (``csrc/knn_approx.cu``) against another
tree's build of it and against patched builds of its own, on one GPU, at
the approx forward's own three calls.

    python scripts/exp_knn_approx_variants.py [--parent DIR] [--no-variants] [NAME ...]

The inputs are the kNN calls of one approx forward (``knn_impl="approx"``,
B=8, N=7000, k=30, emb 1024, weights from seed 1, ``make_blocks(8, 7000,
seed=0)``): stage 1 at C=4 on the x-sorted blocks, stages 2-3 at C=64 on
the stage outputs. Times are device-only (``chip_smoke.cuda_ms_many`` of
the kernel alone), two builds in turns (A, B, B, A).

``--parent DIR``: a checkout of another commit (``git archive`` into a
directory that ``.gitignore`` lists, such as ``build/parent``), whose
``knn_approx.cu`` is built beside this tree's. On each of the three calls
the two builds' indices must be ``torch.equal``, and they are timed in
turns (parent, new, new, parent); on each input of
``chip_smoke.approx_digest_inputs`` both builds' SHA-256 digests are
printed and must agree (run on the first design's tree as the parent, its
digests are ``chip_smoke.APPROX_DIGESTS``); the approx forward's
probabilities through each build must be ``torch.equal``, and the forward
is timed through each in turns: synced (``chip_smoke.cuda_ms``, median of
10) and busy (``torch_profile_forward.profile``: device time a forward, the
``knn_approx`` group's share).

Variants (``VARIANTS``: text replacements applied to a copy of ``csrc/``
under ``build/knn_approx_variants/NAME/``, built by
``scripts/kernel_variants.py``) are held ``torch.equal`` to the shipped
build (the ``diag_`` ones change what the kernel does and are only timed)
and timed beside it (shipped, variant, variant, shipped): ``tiled_net6``
/ ``fused_net10`` move the network's threshold (shipped: more than 10
survivors in the two-phase kernel, 6 in the fused one), ``no_network``
never uses it; ``tiled_net_each`` lets each query of the two-phase kernel
decide alone, ``tiled_per_query`` inserts there query by query,
``fused_rounds`` in branch-free rounds in the fused kernel; ``no_defer``
runs phase B right after its group's phase A, behind a barrier;
``fused_loop`` leaves the fused kernel's chunk loop rolled; ``unroll2``
unrolls the two-phase dot loop by 2 two-channel steps (shipped: 4);
``diag_no_insert`` never inserts (the walk, dots, fold and ballots
alone). Without names every variant runs; ``--no-variants`` runs none.
Prints one JSON line with the card's name and power limit and each
build's ptxas lines; a check that failed is reported after it, and the
exit code is 1.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

import kernel_variants as kv  # noqa: E402

K = 30
FAILURES: list[str] = []  # checks that failed: reported after the JSON line
PTXAS_KEYS = {"knn_approx_fused_kernelILi4ELi32": "fused C=4 KMAX=32",
              "knn_approx_tiled_kernelILi64ELi32": "tiled C=64 KMAX=32",
              "knn_approx_kernelILi4ELi32": "first design C=4",
              "knn_approx_kernelILi64ELi32": "first design C=64"}

VARIANTS = {
    "tiled_net6": [("kNetworkRounds = 10,", "kNetworkRounds = 6,")],
    "fused_net10": [("kNetwork = 6;", "kNetwork = 10;")],
    "no_network": [("kNetworkRounds = 10, kNetwork = 6;", "kNetworkRounds = 32, kNetwork = 32;")],
    "tiled_net_each": [("if (kRounds ? big : __popc(pass[qi]) > kNetwork)",
                        "if (__popc(pass[qi]) > (kRounds ? kNetworkRounds : kNetwork))")],
    "tiled_per_query": [("  offer<LW, true>(lst, kth, v, lane, K);\n}",
                         "  offer<LW, false>(lst, kth, v, lane, K);\n}")],
    "fused_rounds": [("offer<LW, false>(lst", "offer<LW, true>(lst")],
    "no_defer": [  # phase B right after its group's phase A, behind a barrier
        ("    if (pending >= 0) select_from<LW>(wt + pending * kQB * kWinStride, lst, kth, warp, "
         "lane, K);\n    pending = -1;\n", ""),
        ("      pending = wb;\n", "      __syncthreads();\n      select_from<LW>(wt + wb * kQB * "
         "kWinStride, lst, kth, warp, lane, K);\n"),
        ("  __syncthreads();\n  select_from<LW>(wt + pending * kQB * kWinStride, lst, kth, warp, "
         "lane, K);\n", ""),
    ],
    "fused_loop": [("#pragma unroll\n    for (int c = 0; c < kChunks; ++c) {\n"
                    "      if (c >= chunks) break;\n",
                    "    for (int c = 0; c < chunks; ++c) {\n")],
    "unroll2": [("tile_dots<CV, TX>(acc", "tile_dots<CV, TX, 2>(acc")],
    "diag_no_insert": [("  if (any) insert_batch<LW, kRounds>(lst, kth, v, pass, lane, K);",
                        "  if (any && K < 0) insert_batch<LW, kRounds>(lst, kth, v, pass, lane, K);")],
}


def forward_calls(model=None):
    """The approx forward's three kNN inputs, on the card."""
    import numpy as np
    import torch

    import chip_smoke as cs

    model = model or approx_model()
    inputs = []
    real = model._knn

    def record(v, *args, **kwargs):
        inputs.append(v.clone())
        return real(v, *args, **kwargs)

    model._knn = record
    with torch.inference_mode():
        model(torch.from_numpy(np.asarray(cs.make_blocks(cs.B, cs.N, seed=0))).to("cuda"))
    model._knn = real
    return dict(zip(("stage 1 C=4", "stage 2 C=64", "stage 3 C=64"), inputs))


def approx_model():
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    cfg = DGCNNConfig(k=K, emb_dims=1024, knn_impl="approx")
    model = DGCNN(cfg)
    model.load_state_dict(init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict())
    return model.to("cuda")


def launcher(handle, x, q, cn, width, k=K):
    import torch

    def run():
        b, n, cv = x.shape
        out = torch.empty((b, q.shape[1], k), dtype=torch.int32, device=x.device)
        err = handle.dgcnn_knn_approx(
            x.data_ptr(), q.data_ptr(), cn.data_ptr(), out.data_ptr(), b, n, q.shape[1], cv,
            k, width, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"dgcnn_knn_approx: CUDA error {err}")
        return out

    return run


def ab(first, second, label, names, must_equal=True) -> dict:
    """Two launchers on one call: equality, times in turns (A, B, B, A)."""
    import torch

    import chip_smoke as cs

    equal = torch.equal(first(), second())
    if not equal and must_equal:
        FAILURES.append(f"{label}: {names[1]} indices differ from {names[0]}")
    t = [cs.cuda_ms_many(f) for f in (first, second, second, first)]
    print(f"{label}: {names[0]} {t[0]:.4f} / {t[3]:.4f} ms, {names[1]} {t[1]:.4f} / "
          f"{t[2]:.4f} ms, equal {equal}", flush=True)
    return {f"{names[0]}_ms": (t[0] + t[3]) / 2, f"{names[1]}_ms": (t[1] + t[2]) / 2,
            "times_ms": t, "equal": equal}


def parent_checks(handle, shipped, calls, width) -> dict:
    """The parent build against this tree's: the forward's calls (equal,
    timed), the digest inputs (digests of both), the forward's
    probabilities and times through each (the forward's other kernels are
    this tree's in both)."""
    import torch

    import chip_smoke as cs
    from dgcnn_tpu_torch.kernels import knn_approx as ka
    from dgcnn_tpu_torch.ops.knn import approx_reduction_size
    from torch_profile_forward import profile

    res = {"calls": {}, "digests": {}}
    for label, prepared in calls.items():
        res["calls"][label] = ab(launcher(handle, *prepared, width),
                                 launcher(shipped, *prepared, width), label, ("parent", "new"))
    for label, (x, q, k) in cs.approx_digest_inputs().items():
        xt = torch.from_numpy(x).to("cuda")
        qt = None if q is None else torch.from_numpy(q).to("cuda")
        prepared = ka.prepare(xt, qt)
        w = approx_reduction_size(x.shape[1], k)
        digests = [hashlib.sha256(launcher(h, *prepared, w, k)().cpu().numpy().tobytes())
                   .hexdigest() for h in (handle, shipped)]
        res["digests"][label] = {"parent": digests[0], "new": digests[1],
                                 "held": cs.APPROX_DIGESTS.get(label)}
        print(f"digest {label}: parent {digests[0]} new {digests[1]}", flush=True)
        if digests[0] != digests[1]:
            FAILURES.append(f"digest {label}: the new kernel differs from the parent's")
    model = approx_model()
    x = torch.from_numpy(cs.make_blocks(cs.B, cs.N, seed=0)).to("cuda")
    probs = {}
    real_build = ka._build
    # the wrapper's library handle, swapped for the parent's
    parent_build = types.SimpleNamespace(lib=lambda: handle, check=real_build.check,
                                         kernel_width=real_build.kernel_width)
    res["forward"] = {"parent": [], "new": []}
    for name, build in (("parent", parent_build), ("new", real_build), ("new", real_build),
                        ("parent", parent_build)):
        ka._build = build
        try:
            with torch.inference_mode():
                probs[name] = torch.softmax(model(x), -1)
                synced = cs.cuda_ms(lambda: model(x), 10)
            prof = profile(lambda: model(x), 10)
        finally:
            ka._build = real_build
        res["forward"][name].append({
            "synced_ms": synced, "busy_ms": prof["busy_ms_per_forward"],
            "idle_share": prof["idle_share"],
            "knn_approx_ms": prof["groups"].get("knn_approx", {}).get("ms")})
        print(f"approx forward through the {name} kernel: {res['forward'][name][-1]}", flush=True)
    res["forward_probs_equal"] = torch.equal(probs["parent"], probs["new"])
    print(f"approx forward probabilities equal across trees: {res['forward_probs_equal']}")
    if not res["forward_probs_equal"]:
        FAILURES.append("the approx forward's probabilities differ from the parent's")
    return res


def main(argv=None) -> int:
    import chip_smoke as cs
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels.knn_approx import prepare
    from dgcnn_tpu_torch.ops.knn import approx_reduction_size

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree's checkout, built beside this one")
    ap.add_argument("--no-variants", action="store_true", help="run no patched build")
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    args = ap.parse_args(argv)
    names = [] if args.no_variants else (args.names or list(VARIANTS))
    out_dir = HERE / "build" / "knn_approx_variants"
    started = {n: kv.start_build(n, VARIANTS[n], out_dir, files=("knn_approx.cu",),
                                 sources=("knn_approx.cu",)) for n in names}
    if args.parent:
        csrc = Path(args.parent).resolve() / "dgcnn_tpu_torch" / "kernels" / "csrc"
        started["parent"] = kv.start_build("parent", [], out_dir, files=("knn_approx.cu",),
                                           sources=("knn_approx.cu",), csrc=csrc)
    width = approx_reduction_size(cs.N, K)
    shipped = _build.lib()
    calls = {label: prepare(v) for label, v in forward_calls().items()}
    res = {"smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "variants": {},
        "ptxas": kv.ptxas_lines(_build.library_path().with_suffix(".log").read_text(),
                                PTXAS_KEYS)}
    print(f"shipped ptxas: {res['ptxas']}", flush=True)
    if args.parent:
        handle, log = kv.finish_build("parent", *started["parent"])
        res["parent_ptxas"] = kv.ptxas_lines(log, PTXAS_KEYS)
        print(f"parent ptxas: {res['parent_ptxas']}", flush=True)
        res["parent"] = parent_checks(handle, shipped, calls, width)
    for name in names:
        handle, log = kv.finish_build(name, *started[name])
        row = {"ptxas": kv.ptxas_lines(log, PTXAS_KEYS), "cases": {}}
        print(f"{name} ptxas: {row['ptxas']}", flush=True)
        for label, prepared in calls.items():
            row["cases"][label] = ab(launcher(shipped, *prepared, width),
                                     launcher(handle, *prepared, width), f"{name} {label}",
                                     ("shipped", "variant"), not name.startswith("diag_"))
        res["variants"][name] = row
    print(json.dumps(res))
    for failure in FAILURES:
        print(f"FAILED: {failure}", file=sys.stderr)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
