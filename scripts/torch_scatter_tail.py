"""Time the port's stage-3 tail scatter kernel (``csrc/scatter_rows.cu``,
``scatter_stage_tail_rows``) at the shapes the port runs it, and hold its
outputs against its plain version and another tree's.

    python scripts/torch_scatter_tail.py [--root DIR] [--label NAME] [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``
(under ``build/``: the saved inputs take ~40 MB).

Inputs, from seeds:

* ``train step stage 3``: what one production train step hands the kernel
  (``chip_smoke.train_capture``: B=8, N=7000, k=30, C=64), saved to
  ``--out`` by the first run and loaded by the later ones, so that every
  tree is timed on the same tensors;
* B=8, N=7000, k=30, C=64 with random u, w and argmax slots on the kNN
  indices of ``make_blocks`` points (``knn_capped``) and on uniform random
  indices (``chip_smoke.py`` phase 2's cases);
* B=1, N=1001, k=20, C=64, indices in [-7, N+7) (ragged; a batch too small
  to fill the card);
* B=1, N=60 000, k=30, C=64 (rows past the tile route: the global route).

Per input:

* ``ms``: the kernel alone, device-only: the C entry point at the tree's
  own geometry on preallocated outputs (it adds into the same buffers
  launch after launch, which changes no address), back-to-back launches
  between a pair of CUDA events queued behind a device sleep
  (``chip_smoke.cuda_ms_many``, 50 a pair), median of 10 runs;
  ``wrapper_ms``: ``scatter_stage_tail_rows``, the outputs' allocation and
  zeroing included;
* the sums against the plain version's (``chip_smoke.tail_close``: 1e-5,
  or the summation bound on rows of many entries) and the count exact,
  both asserted; the sums are atomic, so they are not held across trees,
  the count is (``torch.equal``);
* ``bound_ms`` (``chip_smoke.tail_bound``): the tables, the argmax slots
  and the indices read once, the sums and the count written once.

``--variants`` (a tree whose wrapper has ``tail_plan``) also times the
train step's input and the kNN-of-blocks one at tiles of 1024, 2048 and
4096 entries (34, 68 and 136 queries) and on the global route, each held
against the plain version. Prints one JSON line: the card's
``nvidia-smi`` name and power limit, the root, the cases.
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


def _inputs(cs, out, dev):
    """name -> (u, w, am int8, idx int32)."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped

    saved = None if out is None else out / "tail_train_capture.pt"
    if saved is not None and saved.exists():
        cap = {k_: v.to(dev) for k_, v in torch.load(saved).items()}
    else:
        cap = cs.train_capture(dev)
        if saved is not None:
            torch.save({k_: v.cpu() for k_, v in cap.items()}, saved)
    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def tables(b, n, c, k):
        return (on(rng.standard_normal((b, n, c), np.float32)),
                on(rng.standard_normal((b, n, c), np.float32)),
                on(rng.integers(-1, k, (b, n, c)).astype(np.int8)))

    pts = on(cs.make_blocks(8, 7000, seed=0))
    knn = knn_capped(pts, K)
    uniform = on(rng.integers(0, 7000, (8, 7000, K)).astype(np.int32))
    return {
        "train step stage 3": (cap["u"], cap["w"], cap["am"].to(torch.int8), cap["idx"]),
        "kNN of blocks C=64": (*tables(8, 7000, 64, K), knn),
        "uniform C=64": (*tables(8, 7000, 64, K), uniform),
        "ragged B=1 N=1001 k=20": (*tables(1, 1001, 64, 20),
                                   on(rng.integers(-7, 1008, (1, 1001, 20)).astype(np.int32))),
        "past shared memory B=1 N=60000": (
            *tables(1, 60000, 64, K), on(rng.integers(0, 60000, (1, 60000, K)).astype(np.int32))),
    }


def _raw(mod, build, u, w, am, idx, qt=None):
    """A launcher of the kernel alone on preallocated outputs: the C entry
    point with the tree's own parameters (``qt``: queries a tile, the
    tree's ``tail_plan`` by default; a tree without one takes the first
    design's parameter list)."""
    import torch

    b, n, c = u.shape
    k = idx.shape[-1]
    sums = torch.zeros((b, n, c), dtype=torch.float32, device=u.device)
    count = torch.zeros((b, n), dtype=torch.float32, device=u.device)
    args = [u.data_ptr(), w.data_ptr(), am.data_ptr(), idx.data_ptr(), sums.data_ptr(),
            count.data_ptr(), None, b, n, k, c]
    if hasattr(mod, "tail_plan"):
        args.append(mod.tail_plan(b, n, k, c) if qt is None else qt)
    elif qt is not None:
        raise ValueError("this tree's kernel takes no tile")

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream)
        build.check(build.lib().dgcnn_scatter_stage_tail(*args, stream),
                    "scatter_stage_tail_rows")
        return sums, count
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", default="", help="directory of the outputs to hold trees against")
    ap.add_argument("--variants", action="store_true", help="also time other geometries")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    cs = _load("chip_smoke_tail", HERE / "chip_smoke.py")
    hold = _load("torch_knn_capped_hold", HERE / "scripts" / "torch_knn_capped.py")._hold

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tail scatter kernel runs on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import scatter_rows as mod

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
    for name, (u, w, am, idx) in _inputs(cs, out, dev).items():
        b, n, c = u.shape
        k = idx.shape[-1]
        want = mod.scatter_stage_tail_rows_plain(u, w, am, idx)
        got = mod.scatter_stage_tail_rows(u, w, am, idx)
        row = {"max_abs_err": cs.tail_close(got, want, u, w, am, idx)}
        row["ms"] = cs.cuda_ms_many(_raw(mod, _build, u, w, am, idx))
        row["wrapper_ms"] = cs.cuda_ms_many(lambda: mod.scatter_stage_tail_rows(u, w, am, idx))
        row["plain_ms"] = cs.cuda_ms_many(
            lambda: mod.scatter_stage_tail_rows_plain(u, w, am, idx), 5, 5)
        b_ms, b_by = cs.tail_bound(b, n, k, c)
        row.update(bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / row["ms"])
        if hasattr(mod, "tail_plan"):
            row["queries_a_tile"] = mod.tail_plan(b, n, k, c)
        row["count_equal_to"] = hold(out, f"tail {name} count", got[1].cpu(), root)
        if args.variants and hasattr(mod, "tail_plan") and n == 7000 and "uniform" not in name:
            var = {}
            for entries in (1024, 2048, 4096):
                qt = mod.tail_plan(b, n, k, c, entries=entries)
                run = _raw(mod, _build, u, w, am, idx, qt=qt)
                var[f"qt={qt} ({entries} entries)"] = {
                    "max_abs_err": cs.tail_close(run(), want, u, w, am, idx),
                    "ms": cs.cuda_ms_many(run)}
            run = _raw(mod, _build, u, w, am, idx, qt=0)
            var["global route"] = {"max_abs_err": cs.tail_close(run(), want, u, w, am, idx),
                                   "ms": cs.cuda_ms_many(run)}
            row["variants"] = var
        cases[name] = row
        print(f"{args.label or root} {name}: " + ", ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in row.items()), file=sys.stderr)
    print(json.dumps({"label": args.label, "root": root, "device": smi, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
