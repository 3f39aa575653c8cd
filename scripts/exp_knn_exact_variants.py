"""Build variants of the flat exact kNN kernel (``csrc/knn_exact.cu`` with a
constant or a line changed) and time them beside the shipped build, on one
GPU, at the stage-1 repair's own call in the default forward.

    python scripts/exp_knn_exact_variants.py [NAME ...]

Each variant is a list of text replacements (``VARIANTS``) applied to a copy
of ``csrc/`` under ``build/knn_exact_variants/NAME/`` and built by
``scripts/kernel_variants.py``. The inputs are the repair's 256 queries per
cloud on ``make_blocks(8, 7000, seed=0)`` (``chip_smoke.forward_capture``)
and the 256 random rows of an integer cloud of ``chip_smoke.py``; each is
launched at 1 and at the shipped slices, with and without the row hint.
The script prints the compiler's register, stack and spill lines of the
C=4 instance, holds the variant's indices ``torch.equal`` to the shipped
kernel's (except the ``diag_`` variants, which change what the kernel
writes), and times both device-only (``chip_smoke.cuda_ms_many``).

``diag_count`` writes, in place of the indices, each warp's winners (the
candidates it takes into its list or its pending buffer) and chunks scored: ``out[b, m, s]`` and ``out[b, m, 8 + s]`` for slice s. The
script reports their mean and maximum per warp and per query (summed over
its slices). ``diag_no_insert`` leaves the insertions out (each lane keeps
its largest score alive instead): what the unpruned scan alone costs.
``diag_stage_only`` leaves the walk out (the launch, the staging and the
checks alone); ``thread_staging`` stages the cloud by the threads'
cp.async instead of two bulk copies; ``flush16`` merges pending winners from 16 on; ``warps16``
takes blocks of 16 warps. ``diag_clock`` writes each warp's clock cycles
to the staged cloud's checks and through its walk (their largest, mean and
median, and the query of the slowest walk). ``no_prune`` walks every chunk, ``serial_insert`` inserts
every winner at once, one after another (outputs held equal). Without arguments it runs every variant. Prints one JSON line with the card's name and power
limit.
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

K = 30

VARIANTS = {
    # each warp counts the candidates it inserts and the chunks it scores,
    # and writes them at out[.., slice] and out[.., 8 + slice] instead of
    # the indices
    "diag_count": [
        ("  int np;  // pending winners (one-slot lists)\n};",
         "  int np;  // pending winners (one-slot lists)\n  int n;\n  int nc;\n};"),
        ("    if (!ahead(cs, ci, L.ks, L.ki)) continue;  // warp-uniform\n",
         "    if (!ahead(cs, ci, L.ks, L.ki)) continue;  // warp-uniform\n    ++L.n;\n"),
        ("      L.np += __popc(want);\n", "      L.np += __popc(want);\n      L.n += __popc(want);\n"),
        ("  L.ki = INT_MAX;\n", "  L.ki = INT_MAX;\n  L.n = 0;\n  L.nc = 0;\n"),
        ("      const int o = ch * kLanes + lane;\n      const bool valid = o < N;\n"
         "      const float sc = valid ? knn_score<CV, false>",
         "      ++L.nc;\n      const int o = ch * kLanes + lane;\n      const bool valid = o < N;\n"
         "      const float sc = valid ? knn_score<CV, false>"),
        ("        if (j < K) orow[j] = L.ei[s];",
         "        if (j == 0) orow[0] = L.n;\n        if (j == 0) orow[8] = L.nc;"),
        ("    if (rank < K) orow[rank] = ci;",
         "    if (j == 0) orow[slice] = L.n;\n    if (j == 0) orow[8 + slice] = L.nc;"),
    ],
    # the scan without the insertions (each lane keeps its largest score);
    # the list stays empty, so nothing is pruned either
    "diag_no_insert": [
        ("      insert_chunk<SLOTS>(L, sc, o, valid, lane, last_lane, last_slot, m_s[warp], m_i[warp]);",
         "      L.ks = fmaxf(L.ks, sc);"),
        ("        if (j < K) orow[j] = L.ei[s];", "        if (j < K) orow[j] = __float_as_int(L.ks);"),
        ("    if (rank < K) orow[rank] = ci;", "    if (rank < K) orow[rank] = __float_as_int(L.ks);"),
    ],
    # the cloud kernel without its pruning: every chunk scored
    "no_prune": [("  sorted = __syncthreads_and(sorted);",
                  "  sorted = __syncthreads_and(sorted) && false;")],
    # every winner inserted at once, one after another (the first design),
    # none kept pending
    "serial_insert": [("  if constexpr (kPending) {\n    if (want) {",
                       "  if constexpr (false) {\n    if (want) {")],
    # pending winners merged from 16 on (32 shipped): the k-th entry rises
    # twice as often, each merge costs the same
    "flush16": [("      if (L.np >= kLanes) flush_pending(L, ps, pi, lane, last_lane);",
                 "      if (L.np >= 16) flush_pending(L, ps, pi, lane, last_lane);")],
    # blocks of 16 warps (32 shipped): at one slice the repair's 2048
    # queries still fill 128 blocks, with half the warps an SM
    "warps16": [("constexpr int kCloudWarps = 32;", "constexpr int kCloudWarps = 16;")],
    # each warp's clock: cycles from the kernel's start to the staged
    # cloud's checks, and from there to the walk's end, at out[.., 2s] and
    # out[.., 2s + 1] for slice s
    "diag_clock": [
        ("  extern __shared__ __align__(16) float csm[];\n",
         "  extern __shared__ __align__(16) float csm[];\n  const long long t0 = clock64();\n"),
        ("  sorted = __syncthreads_and(sorted);\n",
         "  sorted = __syncthreads_and(sorted);\n  const long long t1 = clock64();\n"),
        ("  write_out<SLOTS>(L, out + ((size_t)b * M + qq) * K, live, S, K, warp, lane, m_s, m_i);\n"
         "}\n\n// The rows of a cloud",
         "  const long long t2 = clock64();\n"
         "  if (live && lane == 0) {\n"
         "    out[((size_t)b * M + qq) * K + 2 * slice] = (int)(t1 - t0);\n"
         "    out[((size_t)b * M + qq) * K + 2 * slice + 1] = (int)(t2 - t1);\n"
         "  }\n}\n\n// The rows of a cloud"),
    ],
    # the cloud staged by the threads' cp.async, 16 bytes a copy (the
    # first cloud kernel's staging), not by two bulk copies
    "thread_staging": [(
        "  if (threadIdx.x == 0) {\n"
        "    const unsigned xbytes = (unsigned)(sizeof(float) * N * CV);",
        "  for (int i = threadIdx.x; i < N * (CV / 4); i += blockDim.x)\n"
        "    cp_async16(xs + 4 * i, xb + 4 * i, true);\n"
        "  if (false) {\n"
        "    const unsigned xbytes = (unsigned)(sizeof(float) * N * CV);"),
        ("  if (!bulk_norms)\n", "  if (true)\n"),
        ("  while (!done)\n", "  while (false)\n")],
    # the cloud kernel without its walk: the launch, the staging, the
    # sortedness and norm checks and the write-out alone
    "diag_stage_only": [("  if (live) {\n    const float cmax", "  if (false) {\n    const float cmax")],
}

RESOURCES = {"knn_exact_kernel_cloudILi4ELi1E": "the cloud kernel, C=4, one slot (k <= 32)"}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    cs = _load("chip_smoke_exact_variants", HERE / "chip_smoke.py")

    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels run on one GPU")
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels.knn_exact import launch_geometry

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "knn_exact_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = _build.lib()
    builds = {n: kv.start_build(n, VARIANTS[n], out_dir, ("knn_exact.cu",), ("knn_exact.cu",))
              for n in names}
    dev = torch.device("cuda")
    fwd = cs.forward_capture(dev)
    xr, qr, pos = fwd["repair"]
    rng = np.random.default_rng(0)
    ints = torch.from_numpy(rng.integers(0, 16, (8, 7000, 4)).astype(np.float32)).to(dev)
    rnd = torch.from_numpy(rng.permutation(7000)[:256]).to(dev).expand(8, 256)
    qi = ints.gather(1, rnd[..., None].expand(-1, -1, 4)).contiguous()
    s0 = launch_geometry(8, 256, 7000, 4)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731

    def make(lib, x, q, rows, slices):
        b, n, cv = x.shape
        m = q.shape[1]
        cn = (x * x).sum(-1).contiguous()
        out = torch.empty((b, m, K), dtype=torch.int32, device=dev)

        def run():
            err = lib.dgcnn_knn_exact(
                x.data_ptr(), q.data_ptr(), cn.data_ptr(),
                None if rows is None else rows.data_ptr(), out.data_ptr(), None, b, n, m, cv,
                K, 0 if rows is None else rows.stride(0), slices, stream())
            if err:
                raise RuntimeError(f"dgcnn_knn_exact: CUDA error {err}")
        return run, out

    cases = {}
    for data, x, q, rows in (("repair", xr, qr, pos), ("int random", ints, qi, rnd)):
        for slices in sorted({1, s0}):
            for hint in (None, rows):
                cases[f"{data} slices={slices} hint={'on' if hint is not None else 'off'}"] = \
                    (x, q, hint, slices)
    result = {"failing_queries_per_cloud": fwd["fails"]}
    for name, build in builds.items():
        lib, log = kv.finish_build(name, *build)
        row = {"resources": kv.ptxas_lines(log, RESOURCES)}
        for case, (x, q, rows, slices) in cases.items():
            (run_s, out_s), (run_v, out_v) = make(shipped, x, q, rows, slices), \
                make(lib, x, q, rows, slices)
            run_s()
            run_v()
            torch.cuda.synchronize()
            rec = {"ms": cs.cuda_ms_many(run_v, 20), "shipped_ms": cs.cuda_ms_many(run_s, 20)}
            if name == "diag_count":
                n = out_v[..., :slices].double()
                nc = out_v[..., 8:8 + slices].double()
                rec.update({"per_warp_mean": n.mean().item(), "per_warp_max": n.max().item(),
                            "per_query_mean": n.sum(-1).mean().item(),
                            "per_query_max": n.sum(-1).max().item(),
                            "chunks_per_query_mean": nc.sum(-1).mean().item(),
                            "chunks_per_query_max": nc.sum(-1).max().item()})
            elif name == "diag_clock":
                cyc = out_v[..., :2 * slices].double().reshape(*out_v.shape[:2], slices, 2)
                walk = cyc[..., 1]
                worst = int(walk.flatten().argmax())
                rec.update({"stage_cycles_max": cyc[..., 0].max().item(),
                            "walk_cycles_max": walk.max().item(),
                            "walk_cycles_mean": walk.mean().item(),
                            "walk_cycles_median": walk.median().item(),
                            "worst_query": worst // slices % out_v.shape[1],
                            "worst_cloud": worst // slices // out_v.shape[1]})
            elif not name.startswith("diag_") and not torch.equal(out_v, out_s):
                raise AssertionError(f"{name} {case}: indices differ from the shipped kernel's")
            row[case] = rec
        result[name] = row
        print(name, json.dumps(row), file=sys.stderr)
    print(json.dumps({"device": smi, "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
