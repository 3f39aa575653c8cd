"""CPU tests of the benchmark's harness: the names that tie its files
together, the work counts, the frozen reference against the port's CPU
forward, the imports, the refusal without a card, and a cell added in a
temporary copy by new files alone.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(BENCH), str(BENCH / "reference")]

from harness import core  # noqa: E402
from work import dgcnn as work  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("cell", CELLS)
def test_workload_names_its_config_and_traffic(cell):
    entry = core.cell(cell)
    wl = core.read_json("workloads", cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    cfg = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert (BENCH / "traffic" / f"{entry['traffic']}.py").is_file()
    assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_has_reader_and_moves_reported(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert callable(core.load_module("metrics", metric).read)
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in {e["name"] for e in core.end_to_end_of(cell)}, cell
        assert m in core.per_layer_of(cell)


def test_every_cell_reports_setup_and_another_metric():
    for cell in CELLS:
        names = {e["name"] for e in core.end_to_end_of(cell)}
        assert "setup_s" in names and len(names) >= 2
        assert core.per_layer_of(cell)


PRODUCTION = {"B": 8, "N": 7000, "k": 30, "emb": 1024, "C": 5}


@pytest.mark.parametrize("f,knn,edge,trunk,forward,train", [
    # by hand: kNN 2*8*7000^2*(F+64+64); EdgeConv per point 4*8*7000*F*64 +
    # 2 * 4*8*7000*64*64, per edge 2 * 2*8*7000*30*64*64; trunk
    # 2*8*7000*(192*1024 + 1216*512 + 512*256 + 256*5)
    (4, 103.488e9, 29.417472e9, 106.573824e9, 239.479296e9, 511.404544e9),
    (9, 107.408e9, 29.489152e9, 106.573824e9, 243.470976e9, 515.467904e9),
])
def test_work_counts_at_production_shapes(f, knn, edge, trunk, forward, train):
    s = dict(PRODUCTION, F=f)
    assert work.knn(s)["flops"] == pytest.approx(knn, rel=1e-9)
    assert sum(work.edgeconv_products(s).values()) == pytest.approx(edge, rel=1e-9)
    assert sum(work.trunk_products(s).values()) == pytest.approx(trunk, rel=1e-9)
    assert work.forward_flops(s) == pytest.approx(forward, rel=1e-9)
    # backward: twice every product but the raw points' conv1 (once)
    assert work.train_flops(s) == pytest.approx(train, rel=1e-9)


def test_call_site_bounds_at_production_shapes():
    from harness.peaks import bound_s, peaks

    pk = peaks("NVIDIA H100 80GB HBM3", "float32")
    s = dict(PRODUCTION, F=4)
    # the stage call: 2*8*7000*30*64*64 operations at 67 TFLOP/s
    assert bound_s(work.stage_call(s), pk) == pytest.approx(13.76256e9 / 67e12)
    # the extrema: 4*8*7000*(3*64 + 30) bytes at 3.35 TB/s
    assert bound_s(work.extrema_call(s), pk) == pytest.approx(
        (4 * 8 * 7000 * 222 + 4 * 192) / 3.35e12)
    assert bound_s(work.knn(s), pk) == pytest.approx(103.488e9 / 67e12)
    # gathers 4*8*7000*(c + 30 + 30c) at c = 4, 64, 64; the row scatter
    # 4*8*7000*(30*64 + 30 + 64); the tail 8*7000*(4*(2*64 + 30 + 64 + 1) + 64)
    assert work.gather_calls(s)["bytes"] == 34.496e6 + 2 * 451.136e6
    assert work.scatter_call(s)["bytes"] == 451.136e6
    assert work.tail_call(s)["bytes"] == 53.536e6


# what observations() read at B=8, N=7000 before the work counts were found
# by the configuration's architecture: seconds a batch / a step by family
# at the H100's float32 peaks, and the flops of a block and of a step
DGCNN_OBSERVATIONS = {
    "ahn3_f4": ({"inference": {"knn": 0.0015445970149253732, "stage": 0.00041082268656716416,
                               "extrema": 1.4844408358208956e-05},
                 "training": {"knn": 0.0015445970149253732, "gather": 0.00027963223880597015,
                              "scatter": 0.00013466746268656716,
                              "tail": 1.598089552238806e-05}},
                29934912000.0, 511404544000.0),
    "ahn3_f9": ({"inference": {"knn": 0.0016031044776119404, "stage": 0.00041082268656716416,
                               "extrema": 1.4844408358208956e-05},
                 "training": {"knn": 0.0016031044776119404, "gather": 0.0002899964179104478,
                              "scatter": 0.00013466746268656716,
                              "tail": 1.598089552238806e-05}},
                30433872000.0, 515467904000.0),
}


@pytest.mark.parametrize("config", sorted(DGCNN_OBSERVATIONS))
def test_observations_keep_the_dgcnn_counts(config):
    import run

    cfg = core.read_json("configs", config)
    arch = core.load_module("work", core.architecture(cfg, config))
    obs = run.observations({"obs": {"batch": 8, "points": 7000}}, cfg, "NVIDIA H100 80GB HBM3",
                           arch)
    bounds, per_block, per_step = DGCNN_OBSERVATIONS[config]
    assert obs["bounds"] == bounds
    assert obs["forward_flops_per_block"] == per_block
    assert obs["train_flops_per_step"] == per_step
    assert obs["peak_flops"] == 67e12


def test_a_configuration_must_name_its_architecture():
    assert core.architecture(core.read_json("configs", "ahn3_f4"), "ahn3_f4") == "dgcnn"
    with pytest.raises(KeyError, match="benchmark/configs/nameless.json"):
        core.architecture({"model": {}}, "nameless")


@pytest.mark.parametrize("kernel,group", [
    ("knn_banded_kernel", "knn"), ("knn_capped_kernel_merge", "knn"),
    ("knn_exact_banded_fused", "knn"), ("knn_packed_kernel_fused", "knn"),
    ("edgeconv_stage_kernel", "stage"), ("edgeconv_stage_tf32_kernel", "stage"),
    ("edgeconv_extrema_kernel", "extrema"),
    ("gather_rows_kernel", "gather"), ("scatter_rows_kernel", "scatter"),
    ("scatter_tail_kernel", "tail"), ("scatter_tail_tile_kernel", "tail"),
    ("train_tail_sums_kernel", "torch_ops"), ("train_tail_apply_kernel", "torch_ops"),
    ("train_tail_max_grad_kernel", "torch_ops"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize128x128x32", "gemm"),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>", "gemm"),
    ("void splitKreduce_kernel<32, 16, int, float, float, float, float>", "gemm"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"), ("Memset (Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
     "torch_ops"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "torch_ops"),
])
def test_trace_groups_the_dgcnn_kernels_as_before(kernel, group):
    from harness import trace

    assert trace.group(kernel) == group
    assert trace.group(kernel, trace.declared_groups(core.load_module("work", "dgcnn"))) == group


def test_declared_kernel_families_match_first():
    from types import SimpleNamespace

    from harness import trace

    declared = (("toy_pointwise", "pointwise"), ("toy_gemm_fused", "fused"))
    assert trace.group("toy_pointwise_kernel", declared) == "pointwise"
    assert trace.group("toy_gemm_fused_kernel", declared) == "fused"
    assert trace.group("toy_gemm_fused_kernel") == "gemm"

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, t0, t1, dev=cuda):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=t0, end=t1))

    events = [ev("bench.window", 0, 1000, cpu), ev("toy_pointwise_kernel", 100, 300),
              ev("toy_gemm_fused_kernel", 300, 400), ev("knn_banded_kernel", 500, 600)]
    got = trace.summary(events, declared)
    assert got["groups"] == pytest.approx({"pointwise": 200e-6, "fused": 100e-6, "knn": 100e-6})
    assert got["busy_s"] == pytest.approx(400e-6)
    assert trace.summary(events)["groups"] == pytest.approx(
        {"torch_ops": 200e-6, "gemm": 100e-6, "knn": 100e-6})
    with pytest.raises(ValueError, match="torch_ops"):
        trace.declared_groups(SimpleNamespace(KERNEL_GROUPS=(("x", "torch_ops"),),
                                              __file__="work/x.py"))


def test_reference_matches_port_cpu_forward():
    """B=2, N=1000, k=20: the port's CPU forward (exact kNN) against the
    frozen reference on the port's graphs, and those graphs against the
    reference's exact kNN."""
    from compare import _stage_inputs
    from dgcnn_ref import forward, knn_miss_share, serve
    from harness import scene
    from harness.tap import KnnTap
    from harness.weights import make_weights

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig

    model_cfg = {"num_classes": 5, "num_features": 4, "k": 20, "emb_dims": 1024}
    cfg = DGCNNConfig(knn_impl="xla", **model_cfg)
    w = make_weights(model_cfg, 7, "cpu")
    model = DGCNN(cfg)
    model.load_state_dict(w)
    tap = KnnTap(model)
    pts, _ = scene.make_blocks(np.random.default_rng(3), 2, 1000, ["x", "y", "z", "agl"])
    x = torch.from_numpy(pts)
    with torch.no_grad():
        tap.armed = True
        got = torch.softmax(model(x), -1)
        idx = tap.take()
        want, _ = serve(forward(w, x, idx), 0.8)
        feats = _stage_inputs(w, x, idx)
        miss = max(knn_miss_share(f[j], i[j], 20) for f, i in zip(feats, idx) for j in range(2))
    assert float((got - want).abs().max()) < 2e-6
    assert miss < 1e-3


def test_imports_leave_no_jax():
    code = (
        "import sys; sys.path[:0] = [{r!r}, {b!r}, {b!r} + '/reference']\n"
        "import run, calibrate, compare, dgcnn_ref\n"
        "from harness import core, scene, trace, weights, faults, readers, tap\n"
        "core.load_module('traffic', 'tiles'); core.load_module('traffic', 'train')\n"
        "core.load_module('arch', 'dgcnn'); core.load_module('work', 'dgcnn')\n"
        "import dgcnn_tpu_torch.eval.predict, dgcnn_tpu_torch.train.steps\n"
        "import dgcnn_tpu_torch.data.prefetch, dgcnn_tpu_torch.models.dgcnn\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
        "{{'jax', 'jaxlib', 'flax', 'dgcnn_tpu'}}))\n"
    ).format(r=str(ROOT), b=str(BENCH))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def test_run_refuses_without_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A throwaway configuration, cell and per-layer metric, made in a
    temporary copy: new files plus entries in BENCHMARK.json, no file of
    ``benchmark/`` edited; the cell runs (on the CPU, past the look for a
    card) and reports the new metric."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "dgcnn_tpu_torch", tmp_path / "dgcnn_tpu_torch")
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "ahn3_f4.json").read_text())
    cfg.update(batch_size=2, num_points=300)
    cfg["model"].update(k=10, emb_dims=64, knn_band=256, knn_band_feature=256)
    (b / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    wl = json.loads((b / "workloads" / "f4_tiles.json").read_text())
    wl["config"] = "throwaway"
    wl["params"].update(pool_blocks=20, min_blocks=2, max_blocks=9, cycle=4, sample_tiles=2,
                        sample_range=3, trace_tiles=2)
    (b / "workloads" / "throwaway_tiles.json").write_text(json.dumps(wl))
    (b / "metrics" / "tiles_served.py").write_text(
        "def read(obs):\n    return obs['window'].get('tiles')\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "https://example.org",
                            "file": "benchmark/configs/throwaway.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "throwaway_tiles", "config": "throwaway",
                              "traffic": "tiles", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "f4_tiles" in m.get("workloads", []):
            m["workloads"].append("throwaway_tiles")
    spec["per_layer"].append({"name": "tiles_served", "unit": "tiles", "better": "higher",
                              "source": "host_clock", "layer": "predict loop and guard",
                              "moves": "infer_pts_per_s", "workloads": ["throwaway_tiles"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json; sys.path.insert(0, 'benchmark'); import run\n"
            "for t in (False, True):\n"
            "    r = run.run_cell('throwaway_tiles', 2**31 + 99, 1.0, t, 'cpu')\n"
            "    print(json.dumps(r['result'], default=str))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = (json.loads(x) for x in res.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"infer_pts_per_s", "tile_p95_ms", "peak_gb", "setup_s"}
    assert traced["metrics"]["tiles_served"]["value"] >= 1
    assert list(plain)[-1] == "checks"
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_architecture_is_added_by_new_files_alone(tmp_path):
    """A throwaway architecture (``tests/toy/``: a per-point two-layer model,
    no guard, its own judges and one declared kernel family) with a
    ``tiles`` and a ``train`` cell and a per-layer metric of the family's
    bound, made in a temporary copy by new files plus entries in
    BENCHMARK.json: both cells run through the shared loops on the CPU,
    correct with ``--trace`` 0 and 1, and the ``alter`` fault fails them."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "dgcnn_tpu_torch", tmp_path / "dgcnn_tpu_torch")
    b = tmp_path / "benchmark"
    before = _digests(b)
    shutil.copy(BENCH / "tests" / "toy" / "arch.py", b / "arch" / "toy.py")
    shutil.copy(BENCH / "tests" / "toy" / "work.py", b / "work" / "toy.py")
    cfg = {"architecture": "toy", "precision": "float32", "features": ["x", "y", "z", "agl"],
           "batch_size": 2, "num_points": 300, "min_class_confidence": 0.8,
           "model": {"num_classes": 5, "num_features": 4, "hidden": 32},
           "train": {"lr": 1e-3, "momentum": 0.9, "weight_decay": 1e-4, "scheduler": "cos",
                     "epochs": 30}}
    (b / "configs" / "toy.json").write_text(json.dumps(cfg))
    tiles = json.loads((b / "workloads" / "f4_tiles.json").read_text())
    tiles["params"].update(pool_blocks=20, min_blocks=2, max_blocks=9, cycle=4, sample_tiles=2,
                           sample_range=3, trace_tiles=2)
    train = json.loads((b / "workloads" / "f4_train.json").read_text())
    train["params"].update(pool_batches=4, trace_steps=2)
    limits = {"tiles": {"logit_gap": 1e-4, "label_rule": 0},
              "train": {"loss_gap.1": 1e-4, "grad_gap": 1e-3}}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy", "source": "https://example.org",
                            "file": "benchmark/configs/toy.json", "reduced": [], "why": "a test"})
    for wl, site, suffix, moves in ((tiles, "inference", "infer", "infer_pts_per_s"),
                                    (train, "training", "train", "train_pts_per_s")):
        cell = f"toy_{wl['traffic']}"
        (b / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": "toy", "traffic": wl["traffic"], "why": "a test", "params": wl["params"],
             "limits": limits[wl["traffic"]]}))
        spec["workloads"].append({"name": cell, "config": "toy", "traffic": wl["traffic"],
                                  "chips": 1, "why": "a test"})
        for m in spec["end_to_end"]:
            if f"f4_{wl['traffic']}" in m.get("workloads", []):
                m["workloads"].append(cell)
        next(m for m in spec["per_layer"] if m["name"] == f"mfu.{suffix}")["workloads"].append(cell)
        (b / "metrics" / f"pointwise_bound_ms.{suffix}.py").write_text(
            f"def read(obs):\n    return 1e3 * obs['bounds']['{site}']['pointwise']\n")
        spec["per_layer"].append({"name": f"pointwise_bound_ms.{suffix}", "unit": "ms",
                                  "better": "lower", "source": "host_clock", "layer": "toy",
                                  "moves": moves, "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json; sys.path[:0] = ['benchmark', 'benchmark/reference']; import run\n"
            "from harness.faults import Fault\n"
            "for cell in ('toy_tiles', 'toy_train'):\n"
            "    for t, fault in ((False, None), (True, None), (False, Fault('alter'))):\n"
            "        r = run.run_cell(cell, 2**31 + 77, 0.5, t, 'cpu', fault=fault)\n"
            "        print(json.dumps(r['result'], default=str))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()[-6:]]
    (t_plain, t_traced, t_alter), (r_plain, r_traced, r_alter) = lines[:3], lines[3:]
    assert t_plain["correct"] and t_traced["correct"], (t_plain, t_traced)
    assert r_plain["correct"] and r_traced["correct"], (r_plain, r_traced)
    assert not t_alter["correct"] and not r_alter["correct"]
    assert set(t_plain["metrics"]) == {"infer_pts_per_s", "tile_p95_ms", "peak_gb", "setup_s"}
    assert set(r_plain["metrics"]) == {"train_pts_per_s", "peak_gb", "setup_s"}
    # the toy's count at B=2, N=300: 2*2*300*(4*32 + 32*5) flops at 67 TFLOP/s,
    # under 4*2*300*(4 + 5) bytes at 3.35 TB/s
    assert t_traced["metrics"]["pointwise_bound_ms.infer"]["value"] == pytest.approx(
        1e3 * max(345600 / 67e12, 21600 / 3.35e12))
    assert r_traced["metrics"]["pointwise_bound_ms.train"]["value"] > 0
    assert t_traced["metrics"]["mfu.infer"]["value"] > 0
    assert r_traced["metrics"]["mfu.train"]["value"] > 0
    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.cuda
def test_cell_runs_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                              str(2**31 + 17), "--seconds", "2", "--trace", "0"],
                             capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=900)
        assert res.returncode == 0, res.stderr[-3000:]
        assert json.loads(res.stdout.strip().splitlines()[-1])["correct"], res.stderr[-2000:]


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"


def test_benchmark_json_keeps_the_contract_shape():
    import re

    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(re.fullmatch(NAME, n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert len(m["layer"]) <= 200
    for p in (BENCH).rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(p.relative_to(ROOT)))
