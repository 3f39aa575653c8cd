"""CLI for training, and evaluating a checkpoint, on the GPU.

    python -m dgcnn_tpu_torch.train --data_dir rooms/ --num_features 4 \
        --k 30 --batch_size 8 --epochs 30 [--device cuda]
    python -m dgcnn_tpu_torch.train --eval 1 --data_dir rooms/ \
        --num_features 4 --k 30 [--test_batch_size 8] [--device cuda]

The flags are ``main.py``'s training and test flags (``--mode classifier
--eval 0`` and ``--eval 1``), with the same names and defaults, plus
``--device`` (default ``cuda``). ``--eval 1`` scores the checkpoint
``<model_root>/<model_label>.npz`` on the validation rooms
(``eval/test.py::test_args``) instead of training, writing the per-room
dumps to ``--test_visu_dir``. ``main.py``'s TPU-only
``--knn_train_unroll`` (the Mosaic compile cache) has no counterpart, nor
has the ``DGCNN_GATHER_IMPL`` knob: on the card the training forward's row
gathers always run the gather kernel. The log goes to
``checkpoints/<exp_name>/run.log``, as ``main.py`` writes it.
"""

from __future__ import annotations

import argparse
import os
import sys

from dgcnn_tpu_torch.eval.test import test_args
from dgcnn_tpu_torch.train.loop import train_args
from dgcnn_tpu_torch.utils.logging import IOStream


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dgcnn_tpu_torch.train")
    p.add_argument("--eval", type=str2bool, default=False)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--tb_dir", type=str, default="log_tensorboard")
    p.add_argument("--exp_name", type=str, default="dgcnn_tpu")
    p.add_argument("--model", type=str, default="dgcnn", choices=["dgcnn"])
    p.add_argument("--num_classes", type=int, default=5)
    p.add_argument("--num_features", type=int, default=3)
    p.add_argument("--validation_area", type=str, default="1")
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--validation_batch_size", type=int, default=12)
    p.add_argument("--test_batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--use_sgd", type=str2bool, default=False)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--scheduler", type=str, default="cos", choices=["cos", "step", "none"])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--emb_dims", type=int, default=1024)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--model_root", type=str, default="checkpoints/dgcnn")
    p.add_argument("--test_visu_dir", default="predict")
    p.add_argument("--validation_prop", type=float, default=0.2)
    p.add_argument("--exclude_classes", nargs="*", type=int, default=[-1])
    p.add_argument("--model_label", type=str, default="dgcnn_model")
    p.add_argument("--min_class_confidence", type=float, default=0.8)
    p.add_argument("--patience", type=int, default=None,
                   help="early-stop after N epochs without validation improvement")
    p.add_argument("--num_points", type=int, default=7000)
    p.add_argument("--use_all_points", type=str2bool, default=False)
    p.add_argument("--knn_impl", type=str, default="auto",
                   choices=["auto", "xla", "approx", "pallas", "pallas_packed",
                            "pallas_capped"])
    p.add_argument("--knn_band", type=int, default=None,
                   help="banded stage-1 kNN rows (0 = full capped kernel)")
    p.add_argument("--knn_band_feature", type=int, default=None,
                   help="banded feature kNN rows (0 = full capped kernel)")
    p.add_argument("--knn_band_recall_guard", type=int, default=None,
                   help="recall-guard probe queries of the feature bands (0 = off)")
    p.add_argument("--knn_band_recall_threshold", type=float, default=None)
    p.add_argument("--knn_band_guard_every", type=int, default=None,
                   help="guard every Nth step, sticky fallback for the rest of "
                        "the epoch after a trip")
    p.add_argument("--knn_share_stage3", type=str2bool, default=False)
    p.add_argument("--compute_dtype", type=str, default=None)
    p.add_argument("--matmul_precision", type=str, default=None,
                   choices=[None, "default", "high", "highest"])
    p.add_argument("--remat", type=str, default="off", choices=["off", "selective", "full"])
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per optimizer step")
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--point_shards", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(f"checkpoints/{args.exp_name}", exist_ok=True)
    io = IOStream(f"checkpoints/{args.exp_name}/run.log")
    io.cprint(str(args))
    (test_args if args.eval else train_args)(args, io)
    return 0


if __name__ == "__main__":
    sys.exit(main())
