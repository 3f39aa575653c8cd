"""Build variants of the stage-3 tail kernel's tile route (``csrc/scatter_rows.cu``
with a constant or a line changed) and time them beside the shipped build,
on one GPU, on what one production train step hands the kernel
(``chip_smoke.train_capture``: B=8, N=7000, k=30, C=64).

    python scripts/exp_scatter_tail_variants.py [NAME ...]

Each variant is a list of text replacements (``VARIANTS``) applied to a copy
of ``csrc/`` under ``build/scatter_tail_variants/NAME/`` and built by
``scripts/kernel_variants.py``; each is launched at tiles of 68 and 136
queries (2040 and 4080 entries) on preallocated outputs and timed
device-only (``chip_smoke.cuda_ms_many``), the shipped build beside it.
Outputs are held against the plain version (``chip_smoke.tail_close``)
except the ``diag_`` variants', which leave a part out: ``diag_no_flush``
adds nothing into the output (the walk's sums are kept alive but not
written: everything but the L2 reductions), ``diag_no_walk`` stops after
the sort (the staging and the sort alone), ``diag_stage_only`` after the
staging of the tile's rows. ``batch2`` / ``batch8`` load 2 or 8 sorted
entries a half-warp before adding them (4 shipped); ``threads256`` /
``threads1024`` take blocks of 8 / 32 warps. Also prints the share of a tile's entries that fall on
distinct rows, at each tile. Without arguments it runs every variant.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

import kernel_variants as kv  # noqa: E402

TILES = (68, 136)
RED = "red_add(reinterpret_cast<V*>(out + (base + lo + cur) * C + c), acc);"
VARIANTS = {
    "diag_no_flush": [(f"if (on) {RED}", f"if (on && run < 0) {RED}"),
                      ("if (counts) atomicAdd(", "if (counts && run < 0) atomicAdd(")],
    "diag_no_walk": [("    for (int c0 = 0; c0 < C; c0 += 16 * VW) {",
                      "    for (int c0 = C; c0 < C; c0 += 16 * VW) {")],
    "diag_stage_only": [("    int lo = INT_MAX, hi = INT_MIN;\n",
                         "    if (K > 0) continue;\n    int lo = INT_MAX, hi = INT_MIN;\n")],
    "batch2": [("constexpr int kTileBatch = 4;", "constexpr int kTileBatch = 2;")],
    "batch8": [("constexpr int kTileBatch = 4;", "constexpr int kTileBatch = 8;")],
    "threads256": [("constexpr int kTileThreads = 512;", "constexpr int kTileThreads = 256;")],
    "threads1024": [("constexpr int kTileThreads = 512;", "constexpr int kTileThreads = 1024;")],
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def distinct_share(idx, qt: int) -> float:
    """Distinct rows over entries, summed over the whole tiles of ``qt``
    queries of each cloud (the clamped targets of a tile's qt * k entries)."""
    b, n, k = idx.shape
    whole = n // qt * qt
    t = idx[:, :whole].clamp(0, n - 1).reshape(b, n // qt, qt * k).sort(-1).values
    distinct = (t[..., 1:] != t[..., :-1]).sum() + t.shape[0] * t.shape[1]
    return float(distinct) / t.numel()


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}; known: {', '.join(VARIANTS)}")
    cs = _load("chip_smoke_tail_variants", HERE / "chip_smoke.py")

    import torch

    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_stage_tail_rows_plain

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run on one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "scatter_tail_variants"
    builds = {n: kv.start_build(n, VARIANTS[n], out_dir, ("scatter_rows.cu",),
                                ("scatter_rows.cu",)) for n in names}
    cap = cs.train_capture(torch.device("cuda"))
    u, w, am, idx = cap["u"], cap["w"], cap["am"].to(torch.int8), cap["idx"]
    b, n, c = u.shape
    k = idx.shape[-1]
    want = scatter_stage_tail_rows_plain(u, w, am, idx)

    def make(lib, qt):
        sums = torch.zeros_like(u)
        count = torch.zeros((b, n), device=u.device)

        def run():
            err = lib.dgcnn_scatter_stage_tail(
                u.data_ptr(), w.data_ptr(), am.data_ptr(), idx.data_ptr(), sums.data_ptr(),
                count.data_ptr(), None, b, n, k, c, qt,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"CUDA error {err}")
            return sums, count
        return run

    res = {"device": smi, "distinct_share": {qt: distinct_share(idx, qt) for qt in TILES},
           "shipped": {}, "variants": {}}
    for qt in TILES:
        res["shipped"][f"qt={qt}"] = cs.cuda_ms_many(make(_build.lib(), qt))
    for name in names:
        lib, log = kv.finish_build(name, *builds[name])
        row = {"ptxas": kv.ptxas_lines(log, {"scatter_tail_tile_kernelI6float4": "float4"})}
        for qt in TILES:
            run = make(lib, qt)
            if not name.startswith("diag_"):
                cs.tail_close(run(), want, u, w, am, idx)
            row[f"qt={qt}"] = cs.cuda_ms_many(run)
        res["variants"][name] = row
        print(name, {key: v for key, v in row.items() if key != "ptxas"}, file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
