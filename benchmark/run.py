"""The benchmark of dgcnn_tpu_torch on one NVIDIA GPU: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic kind and its per-layer metrics
are found by name (``harness/core.py``). A run makes the weights on the
device and the traffic on the host from ``--seed``, warms up the cell's
shapes, measures for ``--seconds`` and, after the window, checks what the
timed path produced against the plain reference (``reference/``). It
prints the numbers compared, each beside its limit, as the last lines of
standard error, and one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, read from a traced stretch after
the window), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``.

Exits 3 with no result when no CUDA device (or too few) is present, 1 when
the program is missing or a JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(BENCH), str(BENCH / "reference")]


def observations(out: dict, cfg: dict, kind: str, work) -> dict:
    """What the per-layer readers read: the driver's window and trace, and
    the work bounds per batch and per step at the card's peaks, counted by
    the architecture's ``work`` module."""
    from harness.peaks import bound_s, peaks

    s = work.shapes(cfg, out["obs"]["batch"], out["obs"]["points"])
    pk = peaks(kind, cfg["precision"])
    bounds = {
        site: {fam: bound_s(w, pk) * calls for fam, (w, calls) in fams.items()}
        for site, fams in (("inference", work.inference_sites(s)),
                           ("training", work.training_sites(s)))}
    return dict(out["obs"], bounds=bounds, peak_flops=pk["flops_per_s"],
                forward_flops_per_block=work.forward_flops(s) / s["B"],
                train_flops_per_step=work.train_flops(s))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             *, fault=None, overrides: dict | None = None, params: dict | None = None,
             t_start: float = T_START) -> dict:
    """One run of cell ``name`` on ``device``, without looking for a card:
    ``{"result": the result line's object, "numbers": the compared numbers}``.
    ``fault`` (``harness/faults.py``), ``overrides`` (model knobs) and
    ``params`` (traffic parameters) are for the checks of the check."""
    import torch

    from harness import core
    from harness.trace import declared_groups

    entry = core.cell(name)
    wl = core.read_json("workloads", name)
    cfg = core.read_json("configs", wl["config"])
    arch = core.architecture(cfg, wl["config"])
    work = core.load_module("work", arch)
    traffic = core.load_module("traffic", wl["traffic"])
    device = torch.device(device)
    spans = core.Spans()
    ctx = {"seed": seed, "seconds": seconds, "trace": trace, "device": device,
           "config": cfg, "params": {**wl["params"], **(params or {})}, "spans": spans, "t_start": t_start,
           "fault": fault, "overrides": overrides or {}, "arch": core.load_module("arch", arch),
           "kernel_groups": declared_groups(work)}
    out = traffic.run(ctx)
    judge = out.pop("judge")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge()
    correct, checks = core.checks_line(numbers, wl["limits"])
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": entry["chips"], "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics, breakdown = {}, None
    if trace:
        obs = observations(out, cfg, kind if device.type == "cuda" else "H100", work)
        for m in core.per_layer_of(name):
            value = core.load_module("metrics", m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["obs"]["trace"] or {}
        if tr.get("window_s"):
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
            breakdown = {"device_ops": [list(kv) for kv in tr["device_ops"]],
                         "idle_gaps": [list(kv) for kv in tr["idle_gaps"]]}
    else:
        for m in core.end_to_end_of(name):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct and not out["failed"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "numbers": numbers, "setup_phases": out.get("setup_phases", {})}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        import dgcnn_tpu_torch
    except ImportError as e:
        print(f"the program dgcnn_tpu_torch is not in this checkout: {e}", file=sys.stderr)
        return 1
    if Path(dgcnn_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"dgcnn_tpu_torch loaded from {dgcnn_tpu_torch.__file__}, not from this "
              f"checkout ({ROOT})", file=sys.stderr)
        return 1
    from harness import core

    chips = core.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s), found {have}: the benchmark runs on the card "
              "only", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = core.forbidden_modules()
    if bad:
        print(f"a JAX package was loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 1
    out["result"]["device"]["power"] = power_limit()
    print("set-up seconds: " + json.dumps(out["setup_phases"]), file=sys.stderr)
    for name, c in out["result"]["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.exit(main())
