"""The comparison that decides ``correct``, shown to fail: the control (the
program with its TF32 path on) and each planted fault a cell can have must
read not correct, and the program correct, under the cells' own limits.

Runs the whole of a run but the look for a card, on the CPU, at the
production widths (k 30, emb 1024) and a test's size (B=2, N=1000), in a
temporary copy that adds these cells by new files. The same readings at
the cells' own size come from ``calibrate.py`` on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2**31 + 4242
CASES = {
    "check_tiles": ("f4_tiles", ["program", "control", "half", "alter"]),
    "check_train": ("f4_train", ["program", "control", "half", "unchanged", "alter"]),
}


@pytest.fixture(scope="module")
def readings(tmp_path_factory) -> dict:
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "dgcnn_tpu_torch", tmp / "dgcnn_tpu_torch")
    b = tmp / "benchmark"
    cfg = json.loads((b / "configs" / "ahn3_f4.json").read_text())
    cfg.update(batch_size=2, num_points=1000)
    cfg["model"].update(knn_band=256, knn_band_feature=256)
    (b / "configs" / "check_f4.json").write_text(json.dumps(cfg))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "check_f4", "source": "https://example.org",
                            "file": "benchmark/configs/check_f4.json", "reduced": [],
                            "why": "a test"})
    for name, (base, _) in CASES.items():
        wl = json.loads((b / "workloads" / f"{base}.json").read_text())
        wl["config"] = "check_f4"
        if wl["traffic"] == "tiles":
            wl["params"].update(pool_blocks=16, min_blocks=2, max_blocks=6, cycle=4,
                                sample_tiles=2, sample_range=2)
        else:
            wl["params"].update(pool_batches=4)
        (b / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        spec["workloads"].append({"name": name, "config": "check_f4", "traffic": wl["traffic"],
                                  "chips": 1, "why": "a test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, json; sys.path[:0] = ['benchmark', 'benchmark/reference']\n"
        "import run\nfrom harness.faults import Fault\n"
        f"cases = {json.dumps({k: v[1] for k, v in CASES.items()})}\n"
        "for cell, variants in cases.items():\n"
        "    for v in variants:\n"
        "        kw = {'overrides': {'matmul_precision': 'default'}} if v == 'control' else \\\n"
        "             {} if v == 'program' else {'fault': Fault(v)}\n"
        "        try:\n"
        f"            r = run.run_cell(cell, {SEED}, 0.5, False, 'cpu', **kw)\n"
        "            line = {'correct': r['result']['correct'], 'numbers': r['numbers']}\n"
        "        except Exception as e:\n"
        "            line = {'correct': False, 'error': repr(e)}\n"
        "        print(json.dumps({'cell': cell, 'variant': v, **line}, default=str), flush=True)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=tmp, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    return {(x["cell"], x["variant"]): x for x in lines}


@pytest.mark.parametrize("cell,variant", [(c, v) for c, (_, vs) in CASES.items() for v in vs])
def test_control_and_faults_fail_the_program_passes(readings, cell, variant):
    line = readings[(cell, variant)]
    assert line["correct"] is (variant == "program"), line
