"""The readings the limits of ``correct`` are set from: the program's own
numbers over many seeds, the control's and each planted fault's, at the
cell's own size, all seeds in one process. Not run by the benchmark's own
runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--variants program control half unchanged alter] [--seconds 3]
        [--sample_range 40] [--out FILE]

``control`` is the program with its TF32 path switched on
(``matmul_precision="default"``: the products in TF32, the precision just
below the configuration's FP32 with TF32 off); the faults are
``harness/faults.py``'s. Prints one JSON line per (variant, seed) with the
compared numbers and whether the cell's limits pass them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH), str(BENCH / "reference")]


def main(argv=None) -> int:
    import torch

    import run
    from harness import core
    from harness.faults import Fault

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["program", "control"])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sample_range", type=int, default=None,
                    help="tiles: draw the sampled tiles from the first N (a short window "
                         "completes fewer tiles than a run)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 3
    limits = core.read_json("workloads", args.workload)["limits"]
    out = open(args.out, "a") if args.out else None
    for variant in args.variants:
        for seed in args.seeds:
            t0 = time.perf_counter()
            kw = {}
            if variant == "control":
                kw["overrides"] = {"matmul_precision": "default"}
            elif variant != "program":
                kw["fault"] = Fault(variant)
            if args.sample_range:
                kw["params"] = {"sample_range": args.sample_range}
            try:
                res = run.run_cell(args.workload, seed, args.seconds, False, "cuda",
                                   t_start=t0, **kw)
                numbers = res["numbers"]
                line = {"variant": variant, "seed": seed, "numbers": numbers,
                        "correct": res["result"]["correct"],
                        "attempted": res["result"]["attempted"]}
            except Exception as e:  # a run that crashes gives no number
                line = {"variant": variant, "seed": seed, "error": repr(e)[:500],
                        "correct": False}
            line["seconds"] = time.perf_counter() - t0
            line["limits"] = limits
            text = json.dumps(line, default=str)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
