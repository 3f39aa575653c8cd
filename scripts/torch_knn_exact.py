"""Time the port's flat exact kNN kernel (``csrc/knn_exact.cu``) at the
shapes the port runs it, and hold its outputs against another tree's.

    python scripts/torch_knn_exact.py [--root DIR] [--label NAME] [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``.

Inputs (k=30, C=4):

* the stage-1 repair's own call in the default forward: the 256 rows per
  cloud that ``repair_queries`` picks on ``make_blocks(8, 7000, seed=0)``
  (``chip_smoke.forward_capture``: failing rows first, then the others in
  ascending order), with those rows as the hint where the tree takes one;
* 256 random rows of an integer cloud in [0, 16) (``chip_smoke.py``'s
  timing case);
* a self-kNN at B=1, N=40 000, integers in [0, 64) (the capped kNN's
  fallback past 15 index bits), without and with the rows as the hint;
* a self-kNN at B=1, N=1001 (x-sorted floats);
* a launch with a False predicate (the repair's inputs).

Per input:

* ``ms``: the kernel alone (norms and padding made beforehand),
  device-only: back-to-back launches queued behind a device sleep
  (``chip_smoke.cuda_ms_many``, 50 per pair of events, 10 for the
  self-kNN), median of 10 runs; ``wrapper_ms``: ``knn_exact`` timed the
  same way;
* the indices are written to ``--out``; where a run on another tree wrote
  them first, both must be ``torch.equal``. On the integer inputs they must
  also equal the plain version's;
* ``bound_ms`` (``chip_smoke.bound``): the rows, norms and queries read
  once, the indices written once; one FMA (2 operations) per channel of
  each (query, row) pair.

Then the default forward on a guarded and on an unguarded dispatch
(``chip_smoke.py``'s phase 6 model); its probabilities must be
``torch.equal`` to the other tree's.

``--variants`` (a tree whose wrapper has ``launch_geometry``) also times
each input at 1, 2, 4 and 8 slices (the cloud kernel; 1 for the other),
with and without the hint, each held ``torch.equal`` to the shipped
launch. Prints one JSON line: the card's
``nvidia-smi`` name and power limit, the root, the failing queries per
cloud, the cases.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
K = 30


def _raw(mod, build, x, q, cn, rows=None, slices=None, pred=None):
    """A launcher of the kernel alone on prepared tensors: the wrapper's
    ``launch_kernel`` where the tree has one, else the C entry point of the
    kernel it replaced (a warp per query, ascending, no hint)."""
    import ctypes

    import torch

    b, n, cv = x.shape
    m = q.shape[1]
    if hasattr(mod, "launch_kernel"):
        s = mod.launch_geometry(b, m, n, cv) if slices is None else slices
        return lambda: mod.launch_kernel(x, q, cn, K, rows=rows, slices=s, pred=pred)
    if rows is not None or slices is not None:
        raise ValueError("this tree's kernel takes no hint and no slices")
    out = torch.empty((b, m, K), dtype=torch.int32, device=x.device)
    flag = build.predicate(pred, x.device)

    def run():
        err = build.lib().dgcnn_knn_exact(
            x.data_ptr(), q.data_ptr(), cn.data_ptr(), out.data_ptr(),
            None if flag is None else flag.data_ptr(), b, n, m, cv, K,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        build.check(err, "knn_exact")
        return out
    return run


def _hold(out, name, tensor, root):
    """Write ``tensor`` under ``name`` or hold it equal to another tree's."""
    import torch

    if out is None:
        return None
    path = out / (name.replace(" ", "_").replace("=", "").replace("(", "").replace(")", "")
                  .replace(",", "").replace("'", "") + ".pt")
    if path.exists():
        other = torch.load(path)
        if not torch.equal(tensor, other["t"]):
            raise AssertionError(f"{name}: differs from {other['root']}'s")
        return other["root"]
    torch.save({"t": tensor, "root": root}, path)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", default="", help="directory of the outputs to hold trees against")
    ap.add_argument("--variants", action="store_true", help="also time other slices and hints")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    spec = importlib.util.spec_from_file_location("chip_smoke_exact", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the exact kNN kernel runs on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import knn_exact as mod

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    hinted = hasattr(mod, "launch_kernel")

    fwd = cs.forward_capture(dev)
    xr, qr, pos = fwd["repair"]
    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ints = on(rng.integers(0, 16, (8, 7000, 4)).astype(np.float32))
    rnd = on(rng.permutation(7000)[:256]).expand(8, 256)
    big = on(rng.integers(0, 64, (1, 40000, 4)).astype(np.float32))
    small = on(cs.make_blocks(1, 1001, seed=3))
    # name -> (x, queries or None, the rows as the hint, integer-valued)
    inputs = {
        "repair (make_blocks, the forward's 256 queries)": (xr, qr, pos, False),
        "int 256 random queries": (ints, ints.gather(1, rnd[..., None].expand(-1, -1, 4)),
                                   rnd, True),
        "int self B=1 N=40000": (big, None, None, True),
        "int self B=1 N=40000, rows as the hint": (big, None,
                                                   torch.arange(40000, device=dev)[None], True),
        "self B=1 N=1001 (blocks)": (small, None, torch.arange(1001, device=dev)[None], False),
    }
    cases = {}
    for name, (x, q, rows, int_valued) in inputs.items():
        if "hint" in name and not hinted:
            continue
        hint = rows if hinted and ("hint" in name or q is not None) else None
        kw = {} if hint is None else {"query_rows": hint}
        idx = mod.knn_exact(x, K, queries=q, **kw)
        torch.cuda.synchronize()
        if int_valued and not torch.equal(idx, mod.knn_exact_plain(x, K, queries=q)):
            raise AssertionError(f"{name}: kernel != plain on integer inputs")
        qq = x if q is None else q
        cn = (x * x).sum(-1).contiguous()
        launches = 10 if q is None and x.shape[1] > 10000 else 50
        b_ms, b_by = cs.bound(4.0 * x.shape[0] * (x.shape[1] * 5 + qq.shape[1] * (4 + K)),
                              2.0 * x.shape[0] * qq.shape[1] * x.shape[1] * 4)
        row = {"ms": cs.cuda_ms_many(_raw(mod, _build, x, qq, cn, rows=hint), launches),
               "wrapper_ms": cs.cuda_ms_many(lambda: mod.knn_exact(x, K, queries=q, **kw),
                                             launches),
               "bound_ms": b_ms, "bound_by": b_by,
               "equal_to": _hold(out, name, idx.cpu(), root)}
        row["bound_share"] = b_ms / row["ms"]
        if args.variants and hinted:
            var = {}
            cloud = mod.cloud_fits(x.shape[1], _build.kernel_width(x.shape[-1]))
            for slices in (1, 2, 4, 8) if cloud else (1,):
                for h in (None, rows):
                    run = _raw(mod, _build, x, qq, cn, rows=h, slices=slices)
                    if not torch.equal(run(), idx):
                        raise AssertionError(f"{name}: slices {slices} changes the indices")
                    var[f"slices={slices} hint={'on' if h is not None else 'off'}"] = \
                        cs.cuda_ms_many(run, launches, 5)
            row["variants"] = var
        cases[name] = row
        print(f"{args.label or root} {name}: " + ", ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in row.items() if key != "variants"), file=sys.stderr)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    cn = (xr * xr).sum(-1).contiguous()
    cases["pred=False repair"] = {"ms": cs.cuda_ms_many(
        _raw(mod, _build, xr, qr, cn, rows=pos if hinted else None, pred=no))}

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    cfg = DGCNNConfig(k=K, emb_dims=1024)
    weights = init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict()
    pts = torch.from_numpy(cs.make_blocks(8, 7000, seed=0)).to(dev)
    for name, band_mode in (("forward default guarded", 1), ("forward default unguarded", 0)):
        model = DGCNN(cfg)
        model.load_state_dict(weights)
        with torch.inference_mode():
            prob = torch.softmax(model.to(dev)(pts, band_mode=band_mode), -1).cpu()
        cases[name] = {"equal_to": _hold(out, name, prob, root)}
    print(json.dumps({"label": args.label, "root": root, "device": smi,
                      "failing_queries_per_cloud": fwd["fails"], "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
