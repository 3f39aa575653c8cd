"""Time the port's packed kNN kernels (``csrc/knn_packed.cu``: the flat
kernel of the packed mode, and the split one) at the shapes the port runs
them, and hold their outputs against another tree's.

    python scripts/torch_knn_packed.py [--root DIR] [--label NAME] [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``.

Inputs, from seeds (self-kNN, k=30, B=8, N=7000 unless named):

* the packed forward's stage 1, C=4: ``make_blocks`` points and an
  integer-valued cloud; its stages 2-3, C=64: seeded normal features and
  integers;
* ``queries=``: 1000 rows of the C=64 features (M != N);
* integer edge shapes: k = 20, 40 and 64 (C=4); ragged N=4500 (C=64) and
  B=1 N=1001 (C=4); B=1 N=30000 (C=4, 15 index bits); the capped kNN's
  small-input fallback (N=200, ``knn_capped`` with one window);
* the split kernel (``knn_packed(..., splits=s)``), splits 2 and 8, on the
  integer C=4 cloud, the ``make_blocks`` points and the C=64 features, and
  splits 8 on the 1000 C=64 queries;
* a launch with a False predicate (the C=64 features).

Per input:

* ``ms``: the kernel alone (row norms and padding made beforehand; the
  split cases where the tree's wrapper has ``launch_split``, one launch
  with no scratch), device-only: back-to-back launches between a pair of
  CUDA events queued behind a device sleep (``chip_smoke.cuda_ms_many``),
  median of 10 runs; ``wrapper_ms``: ``knn_packed`` (the norms, then the
  kernel; a tree's split kernel with its scratch and merge), timed the same
  way; the split cases also time the flat kernel alone on the same input
  (``flat_ms``);
* the indices go to ``--out``; where a run on another tree wrote them
  first, they must be ``torch.equal``. On the integer inputs they must also
  equal the plain version's;
* ``bound_ms``: the rows, norms and queries read once, the indices written
  once, one FMA (2 operations) per channel of each (query, row below N)
  pair (``chip_smoke.bound``).

Then the packed-mode forward of ``chip_smoke.py``'s phase 6 model (emb
1024, seeded weights, the ``make_blocks`` batch): its probabilities go to
``--out`` and must be ``torch.equal`` to the other tree's.

``--split_digests`` prints instead the SHA-256 digests (first 16 hex
digits) of the tree's split kernel's indices, splits 2, on each input of
``chip_smoke.split_inputs`` (self and 1000 queries): run on the tree of the
first split kernel, they are ``chip_smoke.SPLIT_DIGESTS``.

``--variants`` (a tree whose wrapper has ``launch_kernel``) also times each
float C <= 8 input of the flat kernel (the fused kernel) at the other block
size (``qb``: 64 or 32 queries a block), whose indices must equal the
shipped geometry's; the two-phase kernel (C >= 16) has one block. Prints
one JSON line: the card's ``nvidia-smi`` name and power limit, the root,
the cases.
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
BLOCKS = (64, 32)  # --variants: queries a block of the fused kernel (C <= 8)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(cs, dev):
    """name -> (x, queries or None, k, integer-valued, splits)."""
    import torch

    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ints = lambda b, n, c, hi=16: on(rng.integers(0, hi, (b, n, c)).astype(np.float32))  # noqa: E731
    pts = on(cs.make_blocks(8, 7000, seed=0))
    feats = on(rng.standard_normal((8, 7000, 64), np.float32))
    int4, int64 = ints(8, 7000, 4), ints(8, 7000, 64)
    rows = torch.from_numpy(rng.permutation(7000)[:1000]).to(dev)
    return {
        "C=4 (blocks)": (pts, None, K, False, 1),
        "int C=4": (int4, None, K, True, 1),
        "C=64": (feats, None, K, False, 1),
        "int C=64": (int64, None, K, True, 1),
        "queries M=1000 C=64": (feats, feats[:, rows].contiguous(), K, False, 1),
        "int queries M=1000 C=64": (int64, int64[:, rows].contiguous(), K, True, 1),
        "int C=4 k=20": (int4, None, 20, True, 1),
        "int C=4 k=40": (int4, None, 40, True, 1),
        "int C=4 k=64": (int4, None, 64, True, 1),
        "int N=4500 C=64": (ints(8, 4500, 64), None, K, True, 1),
        "int B=1 N=1001 C=4": (ints(1, 1001, 4), None, K, True, 1),
        "int B=1 N=30000 C=4": (ints(1, 30000, 4, 64), None, K, True, 1),
        "int N=200 C=4 (capped fallback)": (int4[:, :200].contiguous(), None, K, True, 0),
        "int C=4 splits 2": (int4, None, K, True, 2),
        "int C=4 splits 8": (int4, None, K, True, 8),
        "C=4 (blocks) splits 2": (pts, None, K, False, 2),
        "C=4 (blocks) splits 8": (pts, None, K, False, 8),
        "C=64 splits 2": (feats, None, K, False, 2),
        "C=64 splits 8": (feats, None, K, False, 8),
        "queries M=1000 C=64 splits 8": (feats, feats[:, rows].contiguous(), K, False, 8),
    }


def _raw(mod, build, x, q, cn, qn, k, qb=None, pred=None):
    """A launcher of the flat kernel alone on prepared tensors: the
    wrapper's ``launch_kernel`` where the tree has one, else the C entry
    point with the parameter list of the kernel it replaced (one query per
    lane)."""
    import torch

    if hasattr(mod, "launch_kernel"):
        qb = qb or mod.launch_geometry(x.shape[-1], x.shape[0], q.shape[1])
        return lambda: mod.launch_kernel(x, q, cn, qn, k, qb=qb, pred=pred)
    if qb is not None:
        raise ValueError("this tree's kernel takes no launch geometry")
    b, n, cv = x.shape
    m = q.shape[1]
    n_pad, idx_bits = mod.packed_geometry(n)
    out = torch.empty((b, m, k), dtype=torch.int32, device=x.device)
    flag = build.predicate(pred, x.device)
    args = (x.data_ptr(), q.data_ptr(), cn.data_ptr(), qn.data_ptr(), out.data_ptr(),
            None if flag is None else flag.data_ptr(), b, n, m, cv, k, n_pad, idx_bits)

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        build.check(build.lib().dgcnn_knn_packed(*args, stream), "knn_packed")
        return out
    return run


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


def _bound(cs, x, q, k):
    """Rows, norms and queries read once, indices written once; 2 FP32
    operations per channel of each (query, row below N) pair."""
    b, n, c = x.shape
    m = n if q is None else q.shape[1]
    return cs.bound(4.0 * b * (n * (c + 1) + (0 if q is None else m * (c + 1)) + m * k),
                    2.0 * b * m * n * c)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", default="", help="directory of the outputs to hold trees against")
    ap.add_argument("--variants", action="store_true",
                    help="also time the fused kernel's other block size")
    ap.add_argument("--split_digests", action="store_true",
                    help="print the digests of the split kernel's indices on "
                         "chip_smoke.split_inputs instead")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    cs = _load("chip_smoke_packed", HERE / "chip_smoke.py")
    hold = _load("torch_knn_capped_hold", HERE / "scripts" / "torch_knn_capped.py")._hold

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the packed kNN kernels run on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import knn_packed as mod
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if args.split_digests:
        pts = torch.from_numpy(cs.make_blocks(8, 7000, seed=0)).to(dev)
        digests = {f"{name} {tag}": cs.digest(mod.knn_packed(x, K, queries=qq, splits=2))
                   for name, x, _, _, q in cs.split_inputs(pts)
                   for tag, qq in (("self", None), ("1000 queries", q))}
        print(json.dumps({"label": args.label, "root": root, "device": smi,
                          "split_digests": digests}))
        return 0
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    cases = {}
    inputs = _inputs(cs, dev)
    for name, (x, q, k, int_valued, splits) in inputs.items():
        if splits == 0:  # the capped kNN's fallback: one window, n_win * cap < k
            call = lambda x=x, k=k: knn_capped(x, k)  # noqa: E731
        else:
            call = lambda x=x, q=q, k=k, s=splits: mod.knn_packed(x, k, queries=q, splits=s)  # noqa: E731
        idx = call()
        torch.cuda.synchronize()
        if int_valued:
            plain = mod.knn_packed_split_plain if splits > 1 else mod.knn_packed_plain
            if not torch.equal(idx, plain(x, k, queries=q)):
                raise AssertionError(f"{name}: kernel != plain on integer inputs")
        big = x.shape[0] * x.shape[1] * (x.shape[1] if q is None else q.shape[1]) > 10 ** 8
        launches = 10 if big else 50
        row = {"wrapper_ms": cs.cuda_ms_many(call, launches)}
        if splits == 1:
            xp, qp, cn, qn = _prepared(_build, x, q)
            row["ms"] = cs.cuda_ms_many(_raw(mod, _build, xp, qp, cn, qn, k), launches)
            b_ms, b_by = _bound(cs, x, q, k)
            row.update(bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / row["ms"])
            if (args.variants and hasattr(mod, "launch_kernel") and not int_valued
                    and xp.shape[-1] <= 8):
                shipped = mod.launch_geometry(xp.shape[-1], xp.shape[0], qp.shape[1])
                var = {}
                for qb in BLOCKS:
                    got = _raw(mod, _build, xp, qp, cn, qn, k, qb=qb)()
                    if not torch.equal(got, idx):
                        raise AssertionError(f"{name}: qb={qb} changes the indices")
                    var[f"qb={qb}" + (" (shipped)" if qb == shipped else "")] = \
                        cs.cuda_ms_many(_raw(mod, _build, xp, qp, cn, qn, k, qb=qb), launches, 5)
                row["variants"] = var
        elif splits > 1:
            xp, qp, cn, qn = _prepared(_build, x, q)
            if hasattr(mod, "launch_split"):
                qb = mod.launch_geometry(xp.shape[-1], xp.shape[0], qp.shape[1])
                row["ms"] = cs.cuda_ms_many(
                    lambda: mod.launch_split(xp, qp, cn, qn, k, qb=qb), launches)
            row["flat_ms"] = cs.cuda_ms_many(_raw(mod, _build, xp, qp, cn, qn, k), launches)
            b_ms, b_by = _bound(cs, x, q, k)
            row.update(bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / row.get("ms", row["wrapper_ms"]))
        row["equal_to"] = hold(out, name, idx.cpu(), root)
        cases[name] = row
        print(f"{args.label or root} {name}: " + ", ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in row.items() if key != "variants"), file=sys.stderr)
    x = inputs["C=64"][0]
    xp, qp, cn, qn = _prepared(_build, x, None)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    cases["pred=False C=64"] = {"ms": cs.cuda_ms_many(
        _raw(mod, _build, xp, qp, cn, qn, K, pred=no))}

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    cfg = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas_packed")
    model = DGCNN(cfg)
    model.load_state_dict(init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict())
    pts = torch.from_numpy(cs.make_blocks(8, 7000, seed=0)).to(dev)
    with torch.inference_mode():
        prob = torch.softmax(model.to(dev)(pts), -1).cpu()
    cases["forward packed"] = {"equal_to": hold(out, "forward packed", prob, root)}
    print(json.dumps({"label": args.label, "root": root, "device": smi, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
