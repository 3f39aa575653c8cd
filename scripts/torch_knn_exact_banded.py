"""Time the port's exact banded kNN kernel (``csrc/knn_exact_banded.cu``,
the parity mode's) at the shapes the port runs it, and hold its outputs
against another tree's.

    python scripts/torch_knn_exact_banded.py [--root DIR] [--label NAME] [--out DIR]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``.

Inputs, from seeds (k=30, 64 windows, cap 8, query tile 256 unless
named), B=8, N=7000 unless named:

* the parity forward's stage 1, C=4 at band 2048: ``make_blocks`` points
  and an integer-valued cloud; its stages 2-3, C=64 at full width (band =
  n_pad = 7040): seeded normal features and integers;
* the ``banded=False`` launch (the stage-1 points, scanned at full width
  by the device flag);
* integer edge shapes: cap 4 (C=4 band 2048); 16 windows (C=4 band 1024);
  query tiles 64 and 512 (C=4 band 2048); ragged N=4500 (C=64 full width,
  n_pad 4608) and B=1 N=1001 (C=4 band 512, n_win 16, tile 128);
* a launch with a False predicate (the C=64 inputs).

Per input:

* ``ms``: the kernel alone (row norms and padding made beforehand),
  device-only: back-to-back launches between a pair of CUDA events queued
  behind a device sleep (``chip_smoke.cuda_ms_many``), median of 10 runs;
  ``wrapper_ms``: ``knn_exact_banded_raw`` (the norms, then the kernel),
  timed the same way;
* the indices, k-th keys and overflow flags go to ``--out``; where a run
  on another tree wrote them first, all three must be ``torch.equal``. On
  the integer inputs they must also equal the plain version's;
* ``bound_ms``: the rows and norms read once, the three outputs written
  once, one FMA (2 operations) per channel of each (query, band row below
  N) pair (``chip_smoke.band_pairs``).

Then the parity-mode forward of ``chip_smoke.py``'s phase 6 model (emb
1024, seeded weights, the ``make_blocks`` batch): its probabilities go to
``--out`` and must be ``torch.equal`` to the other tree's. The kernel has
one launch geometry a width (16 queries a block at C <= 8, 32 above), so
there are no variants to time here: ``exp_knn_third_path_variants.py``
builds patched ones. Prints one JSON line: the card's ``nvidia-smi`` name and
power limit, the root, the cases.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
K = 30


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(cs, dev):
    """name -> (x, dict(band, n_win, cap, query_tile), banded flag or None,
    integer-valued)."""
    import torch

    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ints = lambda b, n, c: on(rng.integers(0, 16, (b, n, c)).astype(np.float32))  # noqa: E731
    pts = on(cs.make_blocks(8, 7000, seed=0))
    feats = on(rng.standard_normal((8, 7000, 64), np.float32))
    int4, int64 = on(cs.int_cloud(8, 7000, seed=1)), ints(8, 7000, 64)
    stage1 = dict(band=2048, n_win=64, cap=8, query_tile=256)
    full = dict(band=7040, n_win=64, cap=8, query_tile=256)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    return {
        "C=4 band 2048 (blocks)": (pts, stage1, None, False),
        "int C=4 band 2048": (int4, stage1, None, True),
        "C=64 full width": (feats, full, None, False),
        "int C=64 full width": (int64, full, None, True),
        "C=4 banded=False (blocks)": (pts, stage1, no, False),
        "int C=4 band 2048 cap 4": (int4, {**stage1, "cap": 4}, None, True),
        "int C=4 band 1024 n_win 16": (int4, {**stage1, "band": 1024, "n_win": 16}, None,
                                       True),
        "int C=4 band 2048 tile 64": (int4, {**stage1, "query_tile": 64}, None, True),
        "int C=4 band 2048 tile 512": (int4, {**stage1, "query_tile": 512}, None, True),
        "int C=64 N=4500 full width": (ints(8, 4500, 64), {**full, "band": 4608}, None, True),
        "int B=1 N=1001 C=4 band 512": (
            on(cs.int_cloud(1, 1001, seed=2)),
            dict(band=512, n_win=16, cap=8, query_tile=128), None, True),
    }


def _raw(build, x, cn, k, kw, banded=None, pred=None):
    """A launcher of the kernel alone on prepared tensors (the C entry
    point, whose parameter list both trees share)."""
    import torch

    b, n, cv = x.shape
    n_pad = -(-n // 128) * 128
    idx = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    kth = torch.empty((b, n), dtype=torch.int32, device=x.device)
    ovf = torch.empty((b, n), dtype=torch.int32, device=x.device)
    flag, sel = build.predicate(pred, x.device), build.predicate(banded, x.device)
    args = (x.data_ptr(), cn.data_ptr(), idx.data_ptr(), kth.data_ptr(), ovf.data_ptr(),
            None if flag is None else flag.data_ptr(), None if sel is None else sel.data_ptr(),
            b, n, cv, k, n_pad, kw["band"], kw["n_win"], kw["cap"], kw["query_tile"])

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        build.check(build.lib().dgcnn_knn_exact_banded(*args, stream), "knn_exact_banded")
        return idx, kth, ovf
    return run


def _bound(cs, x, kw, k):
    """Rows and norms read once, indices, k-th keys and flags written once;
    2 FP32 operations per channel of each (query, band row below N) pair."""
    b, n, c = x.shape
    return cs.bound(4.0 * b * n * (c + 1 + k + 2),
                    2.0 * b * cs.band_pairs(kw["band"], kw["query_tile"], n) * c)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", default="", help="directory of the outputs to hold trees against")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    cs = _load("chip_smoke_exact_banded", HERE / "chip_smoke.py")
    hold = _load("torch_knn_capped_hold", HERE / "scripts" / "torch_knn_capped.py")._hold

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the exact banded kNN kernel runs on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import knn_exact_banded as mod

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    cases = {}
    inputs = _inputs(cs, dev)
    for name, (x, kw, banded, int_valued) in inputs.items():
        got = mod.knn_exact_banded_raw(x, K, banded=banded, **kw)
        torch.cuda.synchronize()
        if int_valued:
            pkw = kw if banded is None else {**kw, "band": -(-x.shape[1] // 128) * 128}
            want = mod.knn_exact_banded_raw_plain(x, K, **pkw)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name}: kernel != plain on integer inputs")
        cv = _build.kernel_width(x.shape[-1])
        xp = torch.nn.functional.pad(x, (0, cv - x.shape[-1])).contiguous()
        cn = (x * x).sum(-1).contiguous()
        full = banded is not None or kw["band"] >= x.shape[1]
        launches = 10 if full else 50
        b_ms, b_by = _bound(cs, x, kw if banded is None else
                            {**kw, "band": -(-x.shape[1] // 128) * 128}, K)
        row = {"ms": cs.cuda_ms_many(_raw(_build, xp, cn, K, kw, banded=banded), launches),
               "wrapper_ms": cs.cuda_ms_many(
                   lambda x=x, kw=kw, banded=banded: mod.knn_exact_banded_raw(
                       x, K, banded=banded, **kw), launches),
               "bound_ms": b_ms, "bound_by": b_by,
               "equal_to": hold(out, name, torch.cat([t.flatten().cpu() for t in got]), root)}
        row["bound_share"] = b_ms / row["ms"]
        cases[name] = row
        print(f"{args.label or root} {name}: " + ", ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in row.items()), file=sys.stderr)
    x, kw, _, _ = inputs["C=64 full width"]
    cn = (x * x).sum(-1).contiguous()
    no = torch.zeros((), dtype=torch.bool, device=dev)
    cases["pred=False C=64 full width"] = {
        "ms": cs.cuda_ms_many(_raw(_build, x.contiguous(), cn, K, kw, pred=no))}

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    cfg = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas")
    model = DGCNN(cfg)
    model.load_state_dict(init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict())
    pts = torch.from_numpy(cs.make_blocks(8, 7000, seed=0)).to(dev)
    with torch.inference_mode():
        prob = torch.softmax(model.to(dev)(pts), -1).cpu()
    cases["forward parity"] = {"equal_to": hold(out, "forward parity", prob, root)}
    print(json.dumps({"label": args.label, "root": root, "device": smi, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
