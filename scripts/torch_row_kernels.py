"""Time the port's two row kernels, ``scatter_add_rows`` and
``gather_rows``, beside their plain versions and the PyTorch call that
computes the same function, on one GPU.

    python scripts/torch_row_kernels.py [--root DIR] [--label NAME]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees can be compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A). The method and the
shapes are ``chip_smoke.py``'s phase 2, imported from this checkout:
B=8, N=7000, k=30; the indices of the capped kNN of ``make_blocks``
batches and uniform random ones; C=4 (stage 1) and C=64 (stages 2-3); each
time the median of 10 runs of 50 back-to-back calls between one pair of
CUDA events. The kernels are first held against their plain versions (the
gather bit for bit, the scatter within 1e-5). Prints one JSON line: the
card's name and power limit, the root, and per case the kernel's, the
plain version's and the library call's milliseconds and the bound.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    spec = importlib.util.spec_from_file_location("chip_smoke_rows", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the row kernels run on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_add_rows, scatter_add_rows_plain

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    b, n, k = cs.B, cs.N, cs.K
    dev = torch.device("cuda")
    pts = torch.from_numpy(cs.make_blocks(b, n, seed=0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    indices = {"kNN of blocks": knn_capped(pts, k).reshape(b, n * k),
               "uniform": torch.randint(0, n, (b, n * k), generator=g, device=dev,
                                        dtype=torch.int32)}
    cases = {}
    for label, idx in indices.items():
        for c in (4, 64):
            dy = torch.randn((b, n * k, c), generator=g, device=dev)
            torch.testing.assert_close(scatter_add_rows(dy, idx, n),
                                       scatter_add_rows_plain(dy, idx, n), atol=1e-5, rtol=1e-5)
            cases[f"scatter_add_rows C={c} {label}"] = cs.time_scatter_rows(dy, idx, n)
            table = pts if c == 4 else torch.randn((b, n, c), generator=g, device=dev)
            if not torch.equal(gather_rows(table, idx), gather_rows_plain(table, idx)):
                raise AssertionError(f"gather_rows C={c} ({label}): kernel != plain")
            cases[f"gather_rows C={c} {label}"] = cs.time_gather_rows(table, idx)
    for name, t in cases.items():
        print(f"{args.label or root} {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound {t['bound_ms']:.4f}",
              file=sys.stderr)
    print(json.dumps({"label": args.label, "root": root, "device": smi, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
