"""Time the port's capped kNN kernel (``csrc/knn_capped.cu``) at the shapes
the port runs it, and hold its outputs against another tree's.

    python scripts/torch_knn_capped.py [--root DIR] [--label NAME] [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``.

Inputs, from seeds (k=30, cap 8, window 256 unless named):

* self-kNN at B=8, N=7000: seeded normal features at C=64 (the capped-only
  forward's stages 2-3, every fallback), ``make_blocks`` points at C=4
  (its stage 1), and integer-valued clouds at C=4 and C=64;
* the recall guard's probes: ``probe_rows(7000, 64)`` and
  ``probe_rows(7000, 256)`` of the C=64 features, and a ragged M=200;
* edge shapes, integer-valued: window 128 with cap 4 (B=8, N=7000, C=64);
  B=1, N=1001 (C=64); B=1, N=30000 (C=4: 15 index bits, 118 windows);
* a launch with a False predicate (the C=64 self-kNN's inputs).

Per input:

* ``ms``: the kernel alone (row norms made beforehand), device-only: 50
  back-to-back launches per pair of CUDA events queued behind a device
  sleep (``chip_smoke.cuda_ms_many``), median of 10 runs (fewer launches
  for the self-kNNs); ``wrapper_ms``: ``knn_capped`` (the norms, then the
  kernel), timed the same way;
* the indices are written to ``--out``; where a run on another tree wrote
  them first, both must be ``torch.equal``. On the integer inputs they
  must also equal the plain version's;
* ``bound_ms``: the rows and queries read once, the indices written once,
  one FMA (2 operations) per channel of each (query, row) pair below N
  (``chip_smoke.bound``).

Then three forwards of ``chip_smoke.py``'s phase 6 model (emb 1024, seeded
weights, the ``make_blocks`` batch): the default configuration on a
guarded and on an unguarded dispatch, and the capped-only one; their
probabilities go to ``--out`` and must be ``torch.equal`` to the other
tree's.

``--variants`` (a tree whose wrapper has ``launch_geometry``) also times
each float input at other launch geometries (``(qb, g, jt, nbuf)``:
queries and windows per block, j-steps per tile, tile buffers), whose
indices must equal the shipped geometry's. Prints one JSON line: the
card's ``nvidia-smi`` name and power limit, the root, the cases.
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
# --variants: windows per block at C >= 16 (64 and 32 queries a block), and
# (windows, j-steps per tile, buffers) at C <= 8
TILED_GROUPS = (1, 2, 4, 7, 14, 28)
FUSED_TILES = ((16, 2), (8, 2), (32, 2), (16, 1))


def _inputs(cs, probe_rows, dev):
    """name -> (x, queries or None, window, cap, integer-valued)."""
    import torch

    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    feats = on(rng.standard_normal((8, 7000, 64), np.float32))
    pts = on(cs.make_blocks(8, 7000, seed=0))
    ints = {c: on(rng.integers(0, 16, (8, 7000, c)).astype(np.float32)) for c in (4, 64)}
    ragged = torch.from_numpy(np.linspace(0, 6999, 200).round().astype(np.int64)).to(dev)
    return {
        "self C=64": (feats, None, 256, 8, False),
        "self C=4 (blocks)": (pts, None, 256, 8, False),
        "int self C=4": (ints[4], None, 256, 8, True),
        "int self C=64": (ints[64], None, 256, 8, True),
        "probes M=64 C=64": (feats, feats[:, probe_rows(7000, 64, dev)].contiguous(), 256, 8,
                             False),
        "probes M=256 C=64": (feats, feats[:, probe_rows(7000, 256, dev)].contiguous(), 256,
                              8, False),
        "queries M=200 C=64": (feats, feats[:, ragged].contiguous(), 256, 8, False),
        "int window 128 cap 4 C=64": (ints[64], None, 128, 4, True),
        "int B=1 N=1001 C=64": (on(rng.integers(0, 16, (1, 1001, 64)).astype(np.float32)),
                                None, 256, 8, True),
        "int B=1 N=30000 C=4": (on(rng.integers(0, 64, (1, 30000, 4)).astype(np.float32)),
                                None, 256, 8, True),
    }


def _prepared(build, x, q):
    """The wrapper's tensors: norms, rows zero-padded to the kernel width."""
    import torch

    cv = build.kernel_width(x.shape[-1])
    qq = x if q is None else q
    cn, qn = (x * x).sum(-1).contiguous(), (qq * qq).sum(-1).contiguous()
    pad = cv - x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, pad)).contiguous()
    qp = xp if q is None else torch.nn.functional.pad(q, (0, pad)).contiguous()
    return xp, qp, cn, qn


def _raw(mod, build, x, q, cn, qn, k, window, cap, geometry=None, pred=None):
    """A launcher of the kernel alone on prepared tensors: the wrapper's
    ``launch_kernel`` where the tree has one, else the C entry point with
    the parameter list of the kernel it replaced (one query per lane)."""
    import ctypes

    import torch

    b, n, cv = x.shape
    m = q.shape[1]
    n_pad, n_win, idx_bits = mod.capped_geometry(n, window)
    if hasattr(mod, "launch_kernel"):
        g = geometry or mod.launch_geometry(cv, b, m, n_pad, n_win, cap)
        return lambda: mod.launch_kernel(x, q, cn, qn, k, window=window, cap=cap, geometry=g,
                                         pred=pred)
    if geometry is not None:
        raise ValueError("this tree's kernel takes no launch geometry")
    out = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
    flag = build.predicate(pred, x.device)
    args = (x.data_ptr(), q.data_ptr(), cn.data_ptr(), qn.data_ptr(), out.data_ptr(),
            None if flag is None else flag.data_ptr(), b, n, m, cv, k, n_pad, window, cap,
            idx_bits)

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        build.check(build.lib().dgcnn_knn_capped(*args, stream), "knn_capped")
        return out
    return run


def _bound(cs, x, q, k):
    """Rows, norms and queries read once, indices written once; 2 FP32
    operations per channel of each (query, row below N) pair."""
    b, n, c = x.shape
    m = n if q is None else q.shape[1]
    return cs.bound(4.0 * b * (n * (c + 1) + (0 if q is None else m * (c + 1)) + m * k),
                    2.0 * b * m * n * c)


def _geometries(cv, n_win):
    if cv > 8:
        return sorted({(qb, g, 256 // g, 1) for qb in (64, 32) for g in TILED_GROUPS
                       if g <= n_win})
    return sorted({(4 * min(256 // g, 16), g, jt, nbuf) for g in TILED_GROUPS if g <= n_win
                   for jt, nbuf in FUSED_TILES})


def _hold(out, name, tensor, root):
    """Write ``tensor`` under ``name`` or hold it equal to another tree's."""
    import torch

    if out is None:
        return None
    path = out / (name.replace(" ", "_").replace("=", "").replace("(", "").replace(")", "")
                  + ".pt")
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
    ap.add_argument("--variants", action="store_true", help="also time other launch geometries")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    spec = importlib.util.spec_from_file_location("chip_smoke_capped", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the capped kNN kernel runs on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import knn_capped as mod
    from dgcnn_tpu_torch.kernels.knn_banded import probe_rows

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
    inputs = _inputs(cs, probe_rows, dev)
    for name, (x, q, window, cap, int_valued) in inputs.items():
        kw = dict(window=window, cap=cap)
        idx = mod.knn_capped(x, K, queries=q, **kw)
        torch.cuda.synchronize()
        if int_valued and not torch.equal(idx, mod.knn_capped_plain(x, K, queries=q, **kw)):
            raise AssertionError(f"{name}: kernel != plain on integer inputs")
        xp, qp, cn, qn = _prepared(_build, x, q)
        launches = 50 if q is not None or x.shape[0] * x.shape[1] < 20000 else 10
        b_ms, b_by = _bound(cs, x, q, K)
        row = {"ms": cs.cuda_ms_many(_raw(mod, _build, xp, qp, cn, qn, K, **kw), launches),
               "wrapper_ms": cs.cuda_ms_many(lambda: mod.knn_capped(x, K, queries=q, **kw),
                                             launches),
               "bound_ms": b_ms, "bound_by": b_by,
               "equal_to": _hold(out, name, idx.cpu(), root)}
        row["bound_share"] = b_ms / row["ms"]
        if args.variants and hasattr(mod, "launch_geometry") and not int_valued:
            cv, m = xp.shape[-1], qp.shape[1]
            n_pad, n_win, _ = mod.capped_geometry(x.shape[1], window)
            g0 = mod.launch_geometry(cv, xp.shape[0], m, n_pad, n_win, cap)
            var = {}
            for g in _geometries(cv, n_win):
                got = _raw(mod, _build, xp, qp, cn, qn, K, geometry=g, **kw)()
                if not torch.equal(got, idx):
                    raise AssertionError(f"{name}: geometry {g} changes the indices")
                var["qb={} g={} jt={} nbuf={}".format(*g) + (" (shipped)" if g == g0 else "")] = \
                    cs.cuda_ms_many(_raw(mod, _build, xp, qp, cn, qn, K, geometry=g, **kw),
                                    launches, 5)
            row["variants"] = var
        cases[name] = row
        print(f"{args.label or root} {name}: " + ", ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in row.items() if key != "variants"), file=sys.stderr)
    x, q, window, cap, _ = inputs["self C=64"]
    xp, qp, cn, qn = _prepared(_build, x, q)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    cases["pred=False self C=64"] = {"ms": cs.cuda_ms_many(
        _raw(mod, _build, xp, qp, cn, qn, K, window=window, cap=cap, pred=no))}

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    default = DGCNNConfig(k=K, emb_dims=1024)
    capped = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas_capped", knn_band=0,
                         knn_band_feature=0)
    weights = init_dgcnn(default, torch.Generator().manual_seed(1)).state_dict()
    pts = torch.from_numpy(cs.make_blocks(8, 7000, seed=0)).to(dev)
    for name, cfg, band_mode in (("forward default guarded", default, 1),
                                 ("forward default unguarded", default, 0),
                                 ("forward capped-only", capped, None)):
        model = DGCNN(cfg)
        model.load_state_dict(weights)
        with torch.inference_mode():
            logits = model.to(dev)(pts, band_mode=band_mode)
            prob = torch.softmax(logits, -1).cpu()
        cases[name] = {"equal_to": _hold(out, name, prob, root)}
    print(json.dumps({"label": args.label, "root": root, "device": smi, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
