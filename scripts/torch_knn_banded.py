"""Time the port's banded kNN kernel (``csrc/knn_banded.cu``) at the two
widths the default path runs, and hold its outputs against another tree's.

    python scripts/torch_knn_banded.py [--root DIR] [--label NAME] [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``.

The inputs are ``chip_smoke.py``'s phase 2, made from the same seeds: B=8,
N=7000, k=30, 64 windows, cap 6; ``make_blocks`` points at C=4 (band 2048,
query tile 512: stage 1) and seeded normal features at C=64 (band 4096,
query tile 384: stages 2-3), and integer inputs at both widths. Per input:

* ``ms``: the kernel alone (row norms made beforehand), device-only: 50
  back-to-back launches per pair of CUDA events queued behind a device
  sleep (``chip_smoke.cuda_ms_many``), median of 10 runs;
* ``wrapper_ms``: ``knn_banded_raw`` (the norm reduction, then the
  kernel), timed the same way; ``event_ms``: the same call with one pair of
  events per call, median of 20 (``chip_smoke.cuda_ms``, the method of
  the kernel table's earlier rows);
* the indices and k-th keys are written to ``--out``; where a run on
  another tree wrote them first, both must be ``torch.equal``. On the
  integer inputs they must also equal the plain version's;
* ``cublas_ms`` (float inputs): cuBLAS FP32 (TF32 off) for the same score
  product, dense per query tile (``torch.bmm`` of each tile's queries by
  its band rows): a ceiling for the dots alone, not a yardstick of the
  kernel, which also selects;
* ``bound_ms``: ``chip_smoke.banded_bound``.

Then the default forward (``chip_smoke.py``'s phase 6 model: emb 1024,
seeded weights, the ``make_blocks`` batch, a guarded dispatch): its
probabilities go to ``--out`` and must be ``torch.equal`` to the other
tree's, as the neighbour indices are.

``--variants`` (a tree whose wrapper has ``launch_geometry``) also times
the kernel at other launch geometries (``GEOMETRIES``: queries per block,
j-steps per tile, buffers, the two-phase or the fused kernel) and with
k = 0, the scan without the merge. Prints one JSON
line: the card's ``nvidia-smi`` name and power limit, the root, the cases.
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
BANDS = {"C=4 band 2048": (2048, 512), "C=64 band 4096": (4096, 384)}
# --variants: launch geometries (qb, jt, nbuf, two_phase) beside the shipped
# one: the two-phase kernel with 32-query blocks, the fused kernel with
# other blocks and tiles
GEOMETRIES = {"C=4 band 2048": [(32, 1, 2, 0), (32, 4, 2, 0), (32, 8, 2, 0), (32, 32, 1, 0)],
              "C=64 band 4096": [(32, 4, 1, 1), (64, 2, 2, 0), (64, 1, 2, 0), (32, 2, 2, 0)]}


def _inputs(cs, dev):
    """chip_smoke.phase_kernels' tensors, in its order of draws."""
    import torch

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(cs.make_blocks(cs.B, cs.N, seed=0)).to(dev)
    feats = torch.from_numpy(rng.standard_normal((cs.B, cs.N, 64), np.float32)).to(dev)
    ints = {c: torch.from_numpy(rng.integers(0, 16, (cs.B, cs.N, c)).astype(np.float32)).to(dev)
            for c in (4, 64)}
    return {"C=4 band 2048": pts, "C=64 band 4096": feats,
            "int C=4 band 2048": ints[4], "int C=64 band 4096": ints[64]}


def _raw(mod, build, x, cn, k, kw, geometry=None):
    """A launcher of the kernel alone on prepared tensors: the wrapper's
    ``launch_kernel`` where the tree has one, else the C entry point with
    the parameter list of the kernel it replaced (one query per lane)."""
    import ctypes

    import torch

    if hasattr(mod, "launch_kernel"):
        g = geometry or mod.launch_geometry(x.shape[-1], kw["band"], kw["n_win"], kw["cap"],
                                            kw["query_tile"])
        return lambda: mod.launch_kernel(x, cn, k, geometry=g, **kw)
    if geometry is not None:
        raise ValueError("this tree's kernel takes no launch geometry")
    b, n, cv = x.shape
    idx = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    kth = torch.empty((b, n), dtype=torch.int32, device=x.device)
    band = kw["band"]
    args = (x.data_ptr(), cn.data_ptr(), idx.data_ptr(), kth.data_ptr(), None, b, n, cv, k,
            -(-n // 128) * 128, band, kw["n_win"], kw["cap"], kw["query_tile"],
            (band - 1).bit_length())

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        build.check(build.lib().dgcnn_knn_banded(*args, stream), "knn_banded")
        return idx, kth
    return run


def _cublas_ms(cs, mod, x, band, qt):
    """cuBLAS FP32 for the dense score product of every query tile with
    its band rows, (B * tiles, qt, C) x (B * tiles, C, band)."""
    import torch

    b, n, c = x.shape
    n_pad = -(-n // 128) * 128
    xp = torch.nn.functional.pad(x, (0, 0, 0, -(-n // qt) * qt - n))
    xr = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
    starts = mod.band_starts(xp.shape[1], qt, n_pad, band)
    q = xp.reshape(b, len(starts), qt, c).reshape(-1, qt, c)
    rows = torch.stack([xr[:, s:s + band] for s in starts], 1).reshape(-1, band, c)
    rows_t = rows.transpose(1, 2).contiguous()
    return cs.cuda_ms_many(lambda: torch.bmm(q, rows_t), 10, 5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", default="", help="directory of the outputs to hold trees against")
    ap.add_argument("--variants", action="store_true",
                    help="also time other launch geometries and the scan without the merge")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    spec = importlib.util.spec_from_file_location("chip_smoke_banded", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the banded kNN kernel runs on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import knn_banded as mod

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev, k = torch.device("cuda"), cs.K
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    cases = {}
    for name, x in _inputs(cs, dev).items():
        band, qt = BANDS[name.removeprefix("int ")]
        kw = dict(band=band, query_tile=qt, **cs.BANDS)
        cn = (x * x).sum(-1).contiguous()
        idx, kth = mod.knn_banded_raw(x, k, **kw)
        torch.cuda.synchronize()
        if name.startswith("int "):
            want = mod.knn_banded_raw_plain(x, k, **kw)
            if not (torch.equal(idx, want[0]) and torch.equal(kth, want[1])):
                raise AssertionError(f"{name}: kernel != plain on integer inputs")
        same = None
        if out is not None:
            path = out / (name.replace(" ", "_").replace("=", "") + ".pt")
            if path.exists():
                other = torch.load(path)
                same = other["root"]
                if not (torch.equal(idx.cpu(), other["idx"]) and torch.equal(kth.cpu(), other["kth"])):
                    raise AssertionError(f"{name}: outputs differ from {other['root']}'s")
            else:
                torch.save({"idx": idx.cpu(), "kth": kth.cpu(), "root": root}, path)
        b_ms, b_by = cs.banded_bound(x.shape[-1], band, qt)
        row = {"ms": cs.cuda_ms_many(_raw(mod, _build, x, cn, k, kw)),
               "wrapper_ms": cs.cuda_ms_many(lambda: mod.knn_banded_raw(x, k, **kw)),
               "event_ms": cs.cuda_ms(lambda: mod.knn_banded_raw(x, k, **kw), 20),
               "bound_ms": b_ms, "bound_by": b_by, "equal_to": same}
        if not name.startswith("int "):
            row["cublas_ms"] = _cublas_ms(cs, mod, x, band, qt)
        if args.variants and hasattr(mod, "launch_geometry"):
            cv = x.shape[-1]
            g0 = mod.launch_geometry(cv, band, cs.BANDS["n_win"], cs.BANDS["cap"], qt)
            var = {}
            for g in sorted({g0, *GEOMETRIES[name.removeprefix("int ")]}):
                got = _raw(mod, _build, x, cn, k, kw, g)()
                if not (torch.equal(got[0], idx) and torch.equal(got[1], kth)):
                    raise AssertionError(f"{name}: geometry {g} changes the outputs")
                var["qb={} jt={} nbuf={} two_phase={}".format(*g)] = cs.cuda_ms_many(
                    _raw(mod, _build, x, cn, k, kw, g))
            var["scan only (k=0)"] = cs.cuda_ms_many(_raw(mod, _build, x, cn, 0, kw))
            row["variants"] = var
        cases[name] = row
        print(f"{args.label or root} {name}: " + ", ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in row.items()), file=sys.stderr)
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    cfg = DGCNNConfig(k=k, emb_dims=1024)
    model = DGCNN(cfg)
    model.load_state_dict(init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict())
    with torch.inference_mode():
        prob = torch.softmax(model.to(dev)(_inputs(cs, dev)["C=4 band 2048"], band_mode=1),
                             -1).cpu()
    cases["forward"] = {"equal_to": None}
    if out is not None:
        path = out / "forward_prob.pt"
        if path.exists():
            other = torch.load(path)
            if not torch.equal(prob, other["prob"]):
                raise AssertionError(f"forward probabilities differ from {other['root']}'s")
            cases["forward"]["equal_to"] = other["root"]
        else:
            torch.save({"prob": prob, "root": root}, path)
    print(json.dumps({"label": args.label, "root": root, "device": smi, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
