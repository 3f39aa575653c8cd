"""Hold the port's forwards' probabilities against another tree's, bit for
bit, on one card.

    python scripts/torch_forward_probs.py [--root DIR] [--label NAME] --out DIR
        [--matmul_precision default|high|highest]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` runs (default: this
one); run it on two trees (e.g. the parent unpacked with ``git archive``
into a directory that ``.gitignore`` lists) with one ``--out``: the first
run writes each forward's probabilities there, the second holds its own
``torch.equal`` to them. The forwards: ``chip_smoke.py``'s phase 6 model
(B=8, N=7000, k=30, emb 1024, weights from seed 1, ``make_blocks(8, 7000,
seed=0)``) in the default configuration on a guarded and on an unguarded
dispatch, the capped-only path, the parity mode, the packed mode and the
bf16 serving configuration (``compute_dtype="bfloat16"``, guarded and
unguarded). ``--matmul_precision`` runs instead the default configuration
at that product precision, guarded and unguarded ("default": the TF32
conv operands and the TF32 stage kernel).
Prints one JSON line: the card's ``nvidia-smi`` name and power limit, the
root, and for each forward the tree it was held equal to (null where it
was written).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port runs")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", required=True, help="directory of the probabilities held")
    ap.add_argument("--matmul_precision", choices=("default", "high", "highest"), default=None,
                    help="hold the default configuration's forwards at this precision instead")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    cs = _load("chip_smoke_probs", HERE / "chip_smoke.py")
    hold = _load("torch_knn_capped_hold", HERE / "scripts" / "torch_knn_capped.py")._hold

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the forwards run on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    x = torch.from_numpy(cs.make_blocks(8, 7000, seed=0)).to("cuda")
    configs = {
        "default": DGCNNConfig(k=30, emb_dims=1024),
        "capped-only": DGCNNConfig(k=30, emb_dims=1024, knn_impl="pallas_capped", knn_band=0,
                                   knn_band_feature=0),
        "parity": DGCNNConfig(k=30, emb_dims=1024, knn_impl="pallas"),
        "packed": DGCNNConfig(k=30, emb_dims=1024, knn_impl="pallas_packed"),
        "bf16": DGCNNConfig(k=30, emb_dims=1024, compute_dtype="bfloat16"),
    }
    weights = init_dgcnn(configs["default"], torch.Generator().manual_seed(1)).state_dict()
    guarded = ("default", "bf16")
    if args.matmul_precision:
        name = f"default {args.matmul_precision}"
        configs = {name: DGCNNConfig(k=30, emb_dims=1024,
                                     matmul_precision=args.matmul_precision)}
        guarded = (name,)
    held = {}
    for name, cfg in configs.items():
        model = DGCNN(cfg)
        model.load_state_dict(weights)
        model.to("cuda")
        modes = {"guarded": 1, "unguarded": 0} if name in guarded else {"": None}
        for mode, band_mode in modes.items():
            label = f"forward {name} {mode}".strip()
            kw = {} if band_mode is None else {"band_mode": band_mode}
            with torch.inference_mode():
                prob = torch.softmax(model(x, **kw), -1).cpu()
            held[label] = hold(out, label, prob, root)
    print(json.dumps({"label": args.label, "root": root, "device": smi, "held": held}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
